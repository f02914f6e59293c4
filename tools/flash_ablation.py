"""Ablations of ``flash_attention``'s bf16 kernel on an H100: builds the
committed ``src/repro_torch/kernels/csrc/flash_attention.cu`` and variants of
it, each with one design choice taken back by a patch of the source text,
checks each against the plain version and times it at the dense models'
attention shapes beside ``scaled_dot_product_attention``.

    PYTHONPATH=src python3 tools/flash_ablation.py [--reps 20]
        [--source NAME=PATH ...]

Variants:

- ``kernel``: the source as committed;
- ``exp2f``: the library's ``exp2f`` in place of the bare ``ex2.approx``;
- ``stages3``: a ring of three K/V stages in place of two;
- ``no_overlap``: each tile's softmax waits for the previous tile's P·V
  (``wgmma_wait<0>`` in place of ``wgmma_wait<1>``);
- ``pingpong``: the two consumer warpgroups take turns to issue their
  products, on named barriers (FlashAttention-3's inter-warpgroup
  schedule, on top of the overlap);
- ``no_softmax``: the scores go to P·V as they are, so only the loads and
  the products remain (its output is not checked);
- ``--source NAME=PATH``: another whole ``flash_attention.cu`` with the same
  C entry point (D_q and D_v passed apart), for example an edited copy.

Each case is timed in turns (every variant, then every variant in reverse
order) with CUDA events.  One JSON line a variant and case, then the card's
name and power limit.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

#: (variant, [(text in the source, its replacement), ...])
PATCHES = {
    "exp2f": [('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
               "y = exp2f(x);")],
    "stages3": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    "no_overlap": [("wgmma_wait<1>();", "wgmma_wait<0>();")],
    "pingpong": [("    mbar_wait(L.q_full(), 0);\n",
                  '    if (wg == 1) asm volatile("bar.arrive 1, 256;\\n" ::: "memory");\n'
                  "    mbar_wait(L.q_full(), 0);\n"),
                 ("      wgmma_fence();\n",
                  '      asm volatile("bar.sync %0, 256;\\n" ::"r"(1 + wg) : "memory");\n'
                  "      wgmma_fence();\n"),
                 ("issue_qk<DQ>(sc, q_rows, L.k(0));\n      wgmma_commit();\n",
                  "issue_qk<DQ>(sc, q_rows, L.k(0));\n      wgmma_commit();\n"
                  '      asm volatile("bar.arrive %0, 256;\\n" ::"r"(2 - wg) : "memory");\n'),
                 ("issue_pv<DV>(o, pa, L.v(sp));\n      wgmma_commit();\n",
                  "issue_pv<DV>(o, pa, L.v(sp));\n      wgmma_commit();\n"
                  '      asm volatile("bar.arrive %0, 256;\\n" ::"r"(2 - wg) : "memory");\n')],
    "no_softmax": [("softmax(sc, k_first, alpha0, alpha1);",
                    "alpha0 = alpha1 = 1.f;"),
                   ("softmax(sc, k_first + i * kTileK, alpha0, alpha1);",
                    "alpha0 = alpha1 = 1.f;")],
}
#: (label, B, H, H_kv, S, D, window), causal, on (B, S, H, D) tensors viewed
#: as (B, H, S, D) as the model passes them
CASES = (("internlm2-1.8b", 4, 16, 8, 4096, 128, 0),
         ("minicpm-2b", 4, 36, 36, 2048, 64, 0),
         ("h2o-danube-3-4b", 1, 32, 8, 8192, 120, 4096),
         ("ragged.bf16", 2, 8, 4, 1000, 128, 0),
         ("prefill_32k", 1, 16, 8, 32768, 128, 0))
#: bf16 kernel vs the plain version in float32, per query row ÷ its rms
ROW_REL_TOL = 5e-2


def patched(source: str, patches) -> str:
    for old, new in patches:
        if old not in source:
            raise SystemExit(f"flash_ablation: {old!r} is not in the source; "
                             "update PATCHES")
        source = source.replace(old, new)
    return source


def build(sources: dict, out: Path) -> dict:
    """Compile each source into its own shared library, all at once."""
    from repro_torch.kernels import _build

    procs = {}
    for name, path in sources.items():
        so = out / f"flash_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"flash_ablation: nvcc failed on {name}:\n{log}")
        spills = [ln.strip() for ln in log.splitlines() if "spill" in ln]
        print(json.dumps({"variant": name, "ptxas_spills": spills}), flush=True)
        lib = ctypes.CDLL(str(so))
        _build.bind_flash_attention(lib)
        libs[name] = lib
    return libs


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20, help="launches a timing")
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=PATH of another flash_attention.cu to time")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("flash_ablation: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ops, ref

    src = (ROOT / "src/repro_torch/kernels/csrc/flash_attention.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        sources = {"kernel": _build.CSRC / "flash_attention.cu"}
        for name, patches in PATCHES.items():
            sources[name] = out / f"{name}.cu"
            sources[name].write_text(patched(src, patches))
        for spec in args.source:
            name, path = spec.split("=", 1)
            sources[name] = Path(path).resolve()
        libs = build(sources, out)

        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)

        def inputs(b, h, hkv, s, d):
            return [torch.randn((b, s, n, d), generator=gen, device="cuda")
                    .to(torch.bfloat16).transpose(1, 2) for n in (h, hkv, hkv)]

        def run_with(lib, q, k, v, window):
            _build.library = lambda: lib
            return ops.flash_attention(q, k, v, causal=True, window=window)

        checks = {}
        for name, lib in libs.items():
            worst = 0.0
            for b, h, hkv, s, d, window in ((2, 8, 4, 1000, 128, 0),
                                            (2, 8, 2, 777, 64, 100),
                                            (2, 4, 4, 600, 120, 0)):
                q, k, v = inputs(b, h, hkv, s, d)
                got = run_with(lib, q, k, v, window).float()
                want = ref.attention_ref(q.float(), k.float(), v.float(),
                                         causal=True, window=window)
                rms = want.pow(2).mean(-1, keepdim=True).sqrt().clamp_min(1e-30)
                worst = max(worst, float(((got - want).abs().amax(-1, keepdim=True)
                                          / rms).max()))
            checks[name] = worst
            if name != "no_softmax" and worst > ROW_REL_TOL:
                print(f"flash_ablation: {name} is off the plain version by "
                      f"{worst:.3e} of a row's rms", file=sys.stderr)
                return 1

        order = list(libs)
        for label, b, h, hkv, s, d, window in CASES:
            q, k, v = inputs(b, h, hkv, s, d)
            reps = max(2, args.reps // 4) if s > 8192 else args.reps
            times = {name: [] for name in order}
            for name in order + order[::-1]:
                times[name].append(cuda_ms(lambda: run_with(libs[name], q, k, v,
                                                            window), reps))
            if window:
                rr = torch.arange(s, device="cuda")
                band = (rr[None, :] <= rr[:, None]) & (rr[None, :] > rr[:, None] - window)
                library = lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=band, enable_gqa=True)
            else:
                library = lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True)
            sdpa_ms = cuda_ms(library, reps)
            for name in order:
                print(json.dumps({"variant": name, "case": label, "ms": times[name],
                                  "sdpa_ms": sdpa_ms, "row_rel": checks[name]}),
                      flush=True)
            del q, k, v
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown")
    return 0


if __name__ == "__main__":
    sys.exit(main())
