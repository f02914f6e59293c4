"""Compile-time block-size autotuning with a persisted on-disk cache;
counterpart of ``repro/core/autotune.py``.

A plan runs each scan step in row blocks of ``PlanConfig.block_size``: every
block costs one fused kernel launch (``cuda``) or one ``index_add_`` per view
(``torch``) plus the eager torch ops that build its payloads.  This module
times candidate block sizes on synthetic data matching a step's *signature*
— relation row count, widest segment layout, payload width, node-axis N,
backend, platform — and memoizes the winner.  Signatures bucket the
continuous dimensions to the next power of two, so one tuning run serves a
neighbourhood of shapes.

The cache persists as JSON (``REPRO_TORCH_AUTOTUNE_CACHE`` env, default
``~/.cache/repro_torch/autotune.json``; never the reference's file), so warm
sessions never re-tune: a second process with the same signatures does zero
timing runs (``n_timed`` stays 0).  A corrupt file loads as empty (re-tune);
a corrupt entry gives the defaults; a stale version is discarded.

Where it departs from the reference, for the card:

* **No ``block_rows``.** The port's kernels size their own grids from the
  shapes, so a signature has no ``interpret`` flag and a result no
  ``block_rows``.
* **The candidate grid** is the card's rows per launch, 2¹⁶ … 2²².  A
  candidate larger than the bucketed row count is one block of that count;
  a candidate whose payload block (rows × bucketed width × 4 bytes) passes
  :data:`MAX_BLOCK_PAYLOAD_BYTES` is dropped, so that no probe or run holds
  a payload block the card cannot (a maintained covar batch rooted at the
  fact reduces 2,024 columns: 2²² rows of them are 34 GB).
* **The probe times what the backend launches**: on ``cuda`` a loop of
  ``ops.fused_scan_block`` over the blocks (one reduction of the
  signature's segments and width), on ``torch`` a loop of float32
  ``index_add_`` block partials, as ``lowering/torch.py`` adds them;
  on CUDA tensors timed by CUDA events, on the CPU by ``perf_counter``.
  Where the byte budget caps the probe below a candidate, that candidate
  and every larger one run the probe as one block, so only the largest of
  them is timed: the card's launches cost host time the probe does not
  show (a 1% tick of the maintained covar at 84M rows took 0.131-0.146 s
  in blocks of 2¹⁸ rows, a tie the probe broke by noise, against 0.099 s
  in blocks of 2²⁰).  A probe that fails to launch raises.  The probes are the only code of the
  engine that waits for the card, and they run only at bind time and at
  tick-runner build time, never in a steady tick.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, Optional, Tuple

from repro_torch.obs.trace import span

DEFAULT_BLOCK_SIZE = 1 << 20
#: candidate rows per launch
BLOCK_SIZE_CANDIDATES = (1 << 16, 1 << 18, 1 << 20, 1 << 22)
#: largest payload block (rows × bucketed payload width × 4 bytes) a
#: candidate may give: 8 GiB keeps 2²⁰ rows of a 2,048-column step
MAX_BLOCK_PAYLOAD_BYTES = 8 << 30
#: probe payload at most this many bytes (2¹⁸ rows of 2,048 columns)
MAX_PROBE_BYTES = 2 << 30
CACHE_VERSION = 1


def default_cache_path() -> str:
    env = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "autotune.json")


def _pow2_bucket(n: int) -> int:
    b = 1
    while b < max(int(n), 1):
        b *= 2
    return b


@dataclasses.dataclass(frozen=True)
class TuneSignature:
    """What a tuned choice is keyed on — the step facts that change the
    best blocking.  Continuous dims are pow2-bucketed."""

    backend: str        # lowering backend ("cuda" | "torch")
    platform: str       # device type of the relations: "cpu" | "cuda"
    n_rows: int         # pow2 bucket of the scanned relation's row count
    n_segments: int     # pow2 bucket of the widest segment layout in the step
    payload_width: int  # pow2 bucket of the step's total payload columns
    n_nodes: int        # param-batch (node) axis size (1 when unbatched)
    delta: bool = False  # IVM delta scan: n_rows is the |update| pad bucket

    def key(self) -> str:
        return (f"v{CACHE_VERSION}/{self.backend}/{self.platform}/"
                f"r{self.n_rows}/s{self.n_segments}/w{self.payload_width}/"
                f"n{self.n_nodes}/d{int(self.delta)}")


@dataclasses.dataclass(frozen=True)
class TuneResult:
    block_size: int
    from_cache: bool
    fallback: bool = False   # True when a corrupt entry forced the default


def signature_for_step(backend: str, platform: str, n_rows: int,
                       n_segments: int, payload_width: int,
                       n_nodes: Optional[int],
                       delta: bool = False) -> TuneSignature:
    """``delta=True`` marks an IVM delta scan: ``n_rows`` is then the
    |update| pad bucket, and the best blocking differs enough from a full
    scan's to deserve its own cache lane."""
    return TuneSignature(
        backend=backend, platform=platform, n_rows=_pow2_bucket(n_rows),
        n_segments=_pow2_bucket(n_segments),
        payload_width=_pow2_bucket(payload_width),
        n_nodes=_pow2_bucket(n_nodes or 1), delta=bool(delta))


def candidates(sig: TuneSignature) -> Tuple[int, ...]:
    """The block sizes a signature times: each grid size, one block of the
    bucketed row count where it is larger, none whose payload block passes
    :data:`MAX_BLOCK_PAYLOAD_BYTES` (the smallest if every one does)."""
    cands = sorted({min(c, sig.n_rows) for c in BLOCK_SIZE_CANDIDATES})
    kept = [c for c in cands
            if c * sig.payload_width * 4 <= MAX_BLOCK_PAYLOAD_BYTES]
    return tuple(kept or cands[:1])


def probe_rows(sig: TuneSignature, cands: Tuple[int, ...]) -> int:
    """Rows of probe data: two blocks of the largest candidate where the
    byte budget allows, never more than the signature's rows (a power of
    two, so every candidate divides it)."""
    cap = MAX_PROBE_BYTES // (4 * sig.payload_width)
    cap = 1 << max(cap.bit_length() - 1, 0)
    return max(min(sig.n_rows, 2 * max(cands), cap), 1)


def timed_candidates(cands: Tuple[int, ...], n: int) -> Tuple[int, ...]:
    """The candidates a probe of ``n`` rows can tell apart: each one
    smaller than ``n``, and of those that would run all ``n`` rows as one
    block — the same probe — only the largest, which launches least at
    full size."""
    small = tuple(c for c in cands if c < n)
    whole = [c for c in cands if c >= n]
    return small + ((max(whole),) if whole else ())


def _valid_entry(e) -> bool:
    if not isinstance(e, dict):
        return False
    bs = e.get("block_size")
    return isinstance(bs, int) and not isinstance(bs, bool) and bs >= 1


class Autotuner:
    """Times candidates per signature; memoizes in memory and on disk.

    ``n_timed`` counts individual timing runs (0 across a warm session),
    ``n_hits``/``n_misses`` count cache lookups, ``n_fallbacks`` counts
    corrupt entries that degraded to the default."""

    def __init__(self, cache_path: Optional[str] = None):
        self.cache_path = cache_path or default_cache_path()
        self.n_timed = 0
        self.n_hits = 0
        self.n_misses = 0
        self.n_fallbacks = 0
        self._entries: Dict[str, dict] = self._load()

    # -- persistence ---------------------------------------------------------

    def _load(self) -> Dict[str, dict]:
        try:
            with open(self.cache_path) as f:
                blob = json.load(f)
        except (OSError, ValueError):
            return {}     # missing or corrupt file: start empty, re-tune
        if not isinstance(blob, dict) or blob.get("version") != CACHE_VERSION:
            return {}     # stale format: discard wholesale
        entries = blob.get("entries")
        return dict(entries) if isinstance(entries, dict) else {}

    def _save(self) -> None:
        path = self.cache_path
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({"version": CACHE_VERSION, "entries": self._entries},
                          f, indent=1, sort_keys=True)
            os.replace(tmp, path)    # atomic: concurrent readers never see a
        except OSError:              # torn file
            pass                     # read-only FS etc.: cache stays in-memory

    # -- tuning --------------------------------------------------------------

    def tune(self, sig: TuneSignature) -> TuneResult:
        """The tuned block size for a signature — from the in-memory/on-disk
        cache when present (zero timing runs), otherwise timed now and
        persisted."""
        key = sig.key()
        entry = self._entries.get(key)
        if entry is not None:
            if _valid_entry(entry):
                self.n_hits += 1
                return TuneResult(entry["block_size"], from_cache=True)
            # corrupt entry: degrade to the default, never raise mid-compile
            self.n_fallbacks += 1
            return TuneResult(DEFAULT_BLOCK_SIZE, from_cache=False,
                              fallback=True)
        self.n_misses += 1
        with span("autotune.tune", key=key):
            block_size = self._time_candidates(sig)
        self._entries[key] = {"block_size": int(block_size),
                              "sig": dataclasses.asdict(sig)}
        self._save()
        return TuneResult(int(block_size), from_cache=False)

    # -- timing probes -------------------------------------------------------

    def _time(self, fn, device) -> float:
        """Median-of-3 seconds after one warm-up run: CUDA events on the
        card, the host clock on the CPU.  The one place the engine waits
        for the card, at bind or runner-build time only."""
        import torch

        with span("autotune.probe"):
            fn()
            self.n_timed += 1
            times = []
            for _ in range(3):
                if device.type == "cuda":
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    fn()
                    end.record()
                    end.synchronize()
                    times.append(float(start.elapsed_time(end)) / 1e3)
                else:
                    t0 = time.perf_counter()
                    fn()
                    times.append(time.perf_counter() - t0)
        times.sort()
        return times[1]

    def _time_candidates(self, sig: TuneSignature) -> int:
        import numpy as np
        import torch

        from repro_torch.core.lowering.torch import segment_sum
        from repro_torch.kernels import ops

        device = torch.device(sig.platform)
        cands = candidates(sig)
        n = probe_rows(sig, cands)
        cands = timed_candidates(cands, n)
        n_seg, width = sig.n_segments, sig.payload_width
        rng = np.random.default_rng(0)
        codes = torch.from_numpy(
            rng.integers(0, n_seg, n).astype(np.int32)).to(device)
        pay = torch.from_numpy(
            rng.random((n, width), dtype=np.float32)).to(device)
        spec = (ops.ReduceSpec("seg", 0, n_seg, width, 0),)
        codes2d = codes[:, None]

        def probe(B: int):
            """One step-shaped pass over the probe rows in blocks of B."""
            if sig.backend == "torch":   # lowering/torch.py's reduction
                acc = torch.zeros((n_seg, width), dtype=torch.float32,
                                  device=device)
                for s in range(0, n, B):
                    acc += segment_sum(codes[s:s + B], pay[s:s + B], n_seg)
                return acc
            acc = None
            for s in range(0, n, B):
                (out,) = ops.fused_scan_block(codes2d[s:s + B],
                                              pay[s:s + B], spec)
                if acc is None:
                    acc = out
                else:
                    acc += out
            return acc

        best = None
        for cand in cands:
            t = self._time(lambda: probe(min(cand, n)), device)
            if best is None or t < best[0]:
                best = (t, cand)
        return best[1]
