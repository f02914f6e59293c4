"""Old against new, and each design choice taken back, for the redesigned
``seg_aggregate`` and ``covar_xtx`` kernels on an H100: builds each variant
into its own shared library, checks it against the plain version and times
it, in turns, in one process.

    PYTHONPATH=src python3 tools/scan_ablation.py [--reps 20] [--old DIR]

``--old DIR`` holds an earlier ``seg_aggregate.cu`` with its
``scan_reduce.cuh`` and an earlier ``covar_xtx.cu`` (the 32 x 32 tile-pair
kernel), for example written by ``git show <commit>:<path>`` into a scratch
directory; they are driven through the earlier wrappers' geometry, which
``fused_scan.launch_plan`` and :func:`old_covar_chunking` reproduce.

Variants of ``seg_aggregate`` (4,960 segments x 99 columns: segment
ranges; and two narrow reductions of the unfused covar pass, 4,800 x 1 and
480 x 20: one block holds the whole accumulator):

- ``kernel``: the sources as committed;
- ``one_stage``: one-block mode with a ring of one stage of rows;
- ``batch1``: range mode with one listed row a warp in flight, not 8;
- ``old``: the earlier kernel (``--old``).

Variants of ``covar_xtx`` (F = 70 and 142, one group of pieces; 173,
TPC-DS's width, in two groups of pieces):

- ``kernel``; ``one_stage`` (a ring of one raw stage); ``rows32`` (steps
  of 32 rows where the kernel takes 48); ``no_two_level`` (the wgmma
  accumulators take the whole chunk, never promoted); ``promote2`` and
  ``promote4`` (promoted after every 2 or 4 steps of rows, not every one);
  ``one_tf32`` (hi.hi only, reported for its error); ``old`` (``--old``).

Every variant is a patch of the committed source, built into its own
library and launched through the committed wrappers' geometry (their
``lib=`` argument).

Each variant's error is reported against the plain version on random
inputs (max |Δ| ÷ Σ|terms|) and, for ``covar_xtx``, against float64 on
gathered-like features whose few values repeat in every row.  Each case is
timed in turns (every variant, then every variant in reverse order) with
CUDA events, beside the one PyTorch call that computes the same function.
One JSON line a variant and case, then the card's name and power limit.
Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

ROWS = 1_000_003
#: (variant, file, [(text in the source, its replacement), ...])
SEG_PATCHES = {
    "one_stage": ("seg_reduce.cuh", [("constexpr int kStagesA = 4;",
                                      "constexpr int kStagesA = 1;")]),
    "batch1": ("seg_reduce.cuh", [("constexpr int kBatch = 8;",
                                   "constexpr int kBatch = 1;")]),
}
#: the covar entry point's launch, where a patch may take back the
#: wrapper's choice of ring stages or step rows
XTX_LAUNCH = "  const int err = dispatch(stages, rows, Launch{"
XTX_PATCHES = {
    "no_two_level": [("constexpr int kPromote = 1;",
                      "constexpr int kPromote = 1 << 30;")],
    "promote2": [("constexpr int kPromote = 1;", "constexpr int kPromote = 2;")],
    "promote4": [("constexpr int kPromote = 1;", "constexpr int kPromote = 4;")],
    "one_stage": [("  XTX_CASE(2, 48)",
                   "  XTX_CASE(1, 48) XTX_CASE(1, 32) XTX_CASE(1, 16) XTX_CASE(2, 48)"),
                  (XTX_LAUNCH, "  stages = 1;\n  smem = smem_bytes(f, stages, rows);\n"
                   + XTX_LAUNCH)],
    "rows32": [(XTX_LAUNCH, "  if (rows == 48) rows = 32;\n"
                "  smem = smem_bytes(f, stages, rows);\n" + XTX_LAUNCH)],
    "one_tf32": [("wgmma_n48(part[p], desc(ah, kSBO), desc(bh + lo_b, kSBO), kk > 0 || !fresh);\n"
                  "          wgmma_n48(part[p], desc(ah + lo_a, kSBO), desc(bh, kSBO), 1);\n"
                  "          wgmma_n48(part[p], desc(ah, kSBO), desc(bh, kSBO), 1);\n",
                  "wgmma_n48(part[p], desc(ah, kSBO), desc(bh, kSBO), kk > 0 || !fresh);\n")],
}
SEG_CASES = ((4960, 99, ROWS), (4800, 1, 1 << 20), (480, 20, 1 << 20))
XTX_WIDTHS = (70, 142, 173)


def patched(text: str, patches) -> str:
    for old, new in patches:
        if old not in text:
            raise SystemExit(f"scan_ablation: {old!r} is not in the source; "
                             "update the patches")
        text = text.replace(old, new)
    return text


def build(sources: dict, out: Path) -> dict:
    """Compile each (variant -> .cu path) into its own library, all at once."""
    from repro_torch.kernels import _build

    procs = {}
    for name, path in sources.items():
        so = out / f"{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"scan_ablation: nvcc failed on {name}:\n{log}")
        print(json.dumps({"variant": name, "ptxas": [
            ln.strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln]}),
            flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def bind(lib, kind: str, old: bool):
    from repro_torch.kernels import _build

    P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    if not old:
        (_build.bind_seg_aggregate if kind == "seg" else _build.bind_covar_xtx)(lib)
    elif kind == "seg":
        lib.seg_aggregate.argtypes = [P, I64, P, I64, P, I, I, I64, I, P, P, P]
        lib.seg_aggregate.restype = I
    else:
        lib.covar_xtx.argtypes = [P, P, I64, I, I64, I, P, P, P]
        lib.covar_xtx_blocks_per_sm.argtypes = []
        lib.covar_xtx.restype = lib.covar_xtx_blocks_per_sm.restype = I
    return lib


def old_covar_chunking(n: int, f: int, wave: int):
    """The earlier wrapper's chunks: a wave of 32 x 32 tile-pair blocks."""
    nt = -(-f // 32)
    pairs = nt * (nt + 1) // 2
    chunks = max(1, min(max(1, wave // pairs), -(-n // 32)))
    chunk_rows = -(-max(n, 1) // chunks)
    chunk_rows = min(1 << 16, -(-chunk_rows // 32) * 32)
    return chunk_rows, max(1, -(-n // chunk_rows)), pairs


def old_seg(lib, seg, pay, n_segments):
    from repro_torch.kernels import fused_scan

    spec = fused_scan.ReduceSpec("seg", 0, n_segments, pay.shape[1], 0)
    plan = fused_scan.launch_plan((spec,), ("seg",), seg.shape[0], seg.device)
    (out,) = fused_scan.run(lib.seg_aggregate, [seg.data_ptr(), seg.shape[0],
                                                pay.data_ptr(), pay.shape[1]],
                            plan, seg.shape[0], seg.device)
    return out


def old_covar(lib, x, w):
    import torch

    n, f = x.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chunk_rows, n_chunks, pairs = old_covar_chunking(
        n, f, lib.covar_xtx_blocks_per_sm() * sms)
    out = torch.empty((f, f), device=x.device)
    scratch = torch.empty(n_chunks * pairs * 1024, device=x.device)
    err = lib.covar_xtx(x.data_ptr(), w.data_ptr(), n, f, chunk_rows, n_chunks,
                        scratch.data_ptr(), out.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"scan_ablation: the earlier covar_xtx failed ({err})")
    return out


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


def scaled_err(got, want, scale) -> float:
    return float(((got.double() - want.double()).abs() / (scale.double() + 1e-30)).max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20, help="launches a timing")
    ap.add_argument("--old", type=Path, default=None,
                    help="directory of the earlier seg_aggregate.cu, "
                         "scan_reduce.cuh and covar_xtx.cu")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("scan_ablation: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build, covar_xtx as kxtx, ref
    from repro_torch.kernels import seg_aggregate as kseg

    csrc = _build.CSRC
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        seg_src, xtx_src = {"kernel": csrc / "seg_aggregate.cu"}, {"kernel": csrc / "covar_xtx.cu"}
        for name, (fname, patches) in SEG_PATCHES.items():
            d = tmp / f"seg_{name}"
            d.mkdir()
            shutil.copy(csrc / "seg_aggregate.cu", d)
            shutil.copy(csrc / "seg_reduce.cuh", d)
            (d / fname).write_text(patched((csrc / fname).read_text(), patches))
            seg_src[name] = d / "seg_aggregate.cu"
        for name, patches in XTX_PATCHES.items():
            xtx_src[name] = tmp / f"xtx_{name}.cu"
            xtx_src[name].write_text(patched((csrc / "covar_xtx.cu").read_text(), patches))
        if args.old is not None:
            d = tmp / "seg_old"
            d.mkdir()
            for fname in ("seg_aggregate.cu", "scan_reduce.cuh"):
                shutil.copy(args.old / fname, d)
            seg_src["old"] = d / "seg_aggregate.cu"
            xtx_src["old"] = args.old / "covar_xtx.cu"
        libs = build({**{f"seg_{k}": v for k, v in seg_src.items()},
                      **{f"xtx_{k}": v for k, v in xtx_src.items()}}, tmp)
        seg_libs = {k: bind(libs[f"seg_{k}"], "seg", k == "old") for k in seg_src}
        xtx_libs = {k: bind(libs[f"xtx_{k}"], "xtx", k == "old") for k in xtx_src}

        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)

        # -- seg_aggregate: every variant but "old" launches with the
        # committed geometry
        def seg_runner(name):
            if name == "old":
                return lambda s, p, S: old_seg(seg_libs["old"], s, p, S)
            return lambda s, p, S: kseg.seg_aggregate_cuda(s, p, S, lib=seg_libs[name])

        seg_names = list(seg_libs)
        for S, A, n in SEG_CASES:
            spill = max(1, S // 25)
            seg = torch.randint(-spill, S + spill, (n,), generator=gen, device="cuda",
                                dtype=torch.int32)
            pay = torch.randn((n, A), generator=gen, device="cuda")
            want = ref.seg_aggregate_ref(seg, pay, S)
            scale = ref.seg_aggregate_ref(seg, pay.abs(), S)
            geo = kseg.seg_plan(n, S, A, torch.device("cuda"), seg_libs["kernel"])
            runners = {k: seg_runner(k) for k in seg_names}
            errs = {k: scaled_err(runners[k](seg, pay, S), want, scale) for k in seg_names}
            times = {k: [] for k in seg_names}
            for k in seg_names + seg_names[::-1]:
                times[k].append(cuda_ms(lambda: runners[k](seg, pay, S), args.reps))
            ok = (seg >= 0) & (seg < S)
            sid = torch.where(ok, seg, torch.zeros_like(seg)).long()
            masked = pay * ok[:, None].float()
            lib_out = torch.zeros((S, A), device="cuda")
            library_ms = cuda_ms(lambda: lib_out.index_add_(0, sid, masked), args.reps)
            for k in seg_names:
                print(json.dumps({"kernel": "seg_aggregate", "variant": k,
                                  "case": f"{S}x{A}", "n": n, "ms": times[k],
                                  "max_rel_err": errs[k], "index_add_ms": library_ms,
                                  "blocks": len(geo.layout.items) if k != "old" else None,
                                  "chunks": geo.n_chunks if k != "old" else None}),
                      flush=True)
            del seg, pay, want, scale, sid, masked, lib_out

        # -- covar_xtx
        def xtx_runner(name):
            if name == "old":
                return lambda x, w: old_covar(xtx_libs["old"], x, w)
            return lambda x, w: kxtx.covar_xtx_cuda(x, w, lib=xtx_libs[name])

        xtx_names = list(xtx_libs)
        for f in XTX_WIDTHS:
            x = torch.randn((ROWS, f), generator=gen, device="cuda")
            w = (torch.rand((ROWS,), generator=gen, device="cuda") < 0.9).float()
            # gathered-like: eight positive values, each 0.45 of a TF32 unit
            # off the TF32 grid, repeated in every row
            vals = 1.0 + (torch.randint(0, 512, (8,), generator=gen, device="cuda") + 0.45) * 2.0 ** -10
            g = vals[torch.randint(0, 8, (ROWS, f), generator=gen, device="cuda")]
            want, scale = ref.covar_xtx_ref(x, w), ref.covar_xtx_ref(x.abs(), w)
            g64 = g.double()
            want_g = g64.t() @ (g64 * w.double()[:, None])
            runners = {k: xtx_runner(k) for k in xtx_names}
            errs = {k: (scaled_err(runners[k](x, w), want, scale),
                        scaled_err(runners[k](g, w), want_g, want_g)) for k in xtx_names}
            times = {k: [] for k in xtx_names}
            for k in xtx_names + xtx_names[::-1]:
                times[k].append(cuda_ms(lambda: runners[k](x, w), args.reps))
            mm_ms = cuda_ms(lambda: torch.mm(x.t(), x * w[:, None]), args.reps)
            for k in xtx_names:
                print(json.dumps({"kernel": "covar_xtx", "variant": k, "case": f"F{f}",
                                  "n": ROWS, "ms": times[k], "max_rel_err": errs[k][0],
                                  "repeated_values_rel_err_f64": errs[k][1],
                                  "mm_ms": mm_ms}), flush=True)
            del x, w, g, g64, want, scale, want_g
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown")
    return 0


if __name__ == "__main__":
    sys.exit(main())
