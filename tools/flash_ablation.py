"""Ablations of ``flash_attention``'s kernels on an H100: builds the
committed ``src/repro_torch/kernels/csrc/flash_attention.cu`` and variants of
it, each with one design choice taken back by a patch of the source text
(of the chosen dtype's kernel only), checks each against the plain version
and times it at the models' attention shapes beside
``scaled_dot_product_attention``.

    PYTHONPATH=src python3 tools/flash_ablation.py [--dtype bfloat16|float32]
        [--reps 20] [--source NAME=PATH ...]

Variants of the bf16 kernel (``--dtype bfloat16``, the default):

- ``kernel``: the source as committed;
- ``exp2f``: the library's ``exp2f`` in place of the bare ``ex2.approx``;
- ``stages3``: a ring of three K/V stages in place of two;
- ``no_overlap``: each tile's softmax waits for the previous tile's P·V
  (``wgmma_wait<0>`` in place of ``wgmma_wait<1>``);
- ``pingpong``: the two consumer warpgroups take turns to issue their
  products, on named barriers (FlashAttention-3's inter-warpgroup
  schedule, on top of the overlap);
- ``no_softmax``: the scores go to P·V as they are, so only the loads and
  the products remain (its output is not checked).

Variants of the float32 kernel (``--dtype float32``; each but ``kernel``,
``no_overlap`` and ``qk_interleaved`` unchecked, since each changes the
result):

- ``kernel``, ``no_overlap`` and ``no_softmax`` as above;
- ``one_product``: 1xTF32, hi.hi alone in both products (a third of the
  tensor-core work);
- ``qk_interleaved``: Q Kᵀ's three products issued k-step by k-step
  (hi.lo, lo.hi, hi.hi) in place of the small ones first (checked);
- ``no_qk`` / ``no_pv``: Q Kᵀ or P V not issued, the other and the
  softmax kept;
- ``no_split``: the producer waits for each raw tile and releases it
  unsplit (the products read whatever the split buffers hold);
- ``no_loads``: the producer's TMA loads nothing from device memory; it
  splits whatever the raw buffer holds and stores as before.

``--source NAME=PATH``: another whole ``flash_attention.cu`` with the same
C entry point (D_q and D_v passed apart), for example an edited copy.

Each variant is checked on five small cases (in float32 also against float64
attention: ``max_abs_vs_float64``), and each case is timed in turns (every
variant, then every variant in reverse order) with CUDA events.  One JSON line a variant and case, then the card's
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

#: (variant, [(text in the source, its replacement), ...]) of the bf16 kernel
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
#: the same for the float32 kernel
F32_PATCHES = {
    "no_overlap": [("wgmma_wait<1>();", "wgmma_wait<0>();")],
    "no_softmax": [("softmax(sc, k_first, alpha0, alpha1);",
                    "alpha0 = alpha1 = 1.f;"),
                   ("softmax(sc, k_first + i * BK, alpha0, alpha1);",
                    "alpha0 = alpha1 = 1.f;")],
    "one_product": [
        ("    wgmma_tf32(sc, desc_k_major(qa, DQ * 32), desc_k_major(ka + L_t::kK, DQ * 32), kk > 0);\n"
         "    wgmma_tf32(sc, desc_k_major(qa + L_t::kQ, DQ * 32), desc_k_major(ka, DQ * 32), 1);\n",
         ""),
        ("desc_k_major(k + kk * 256, DQ * 32), 1);", "desc_k_major(k + kk * 256, DQ * 32), kk > 0);"),
        ("    wgmma_tf32(acc, ph[kk], desc_k_major(va + L_t::kV, kSbo), kk > 0);\n"
         "    wgmma_tf32(acc, pl[kk], desc_k_major(va, kSbo), 1);\n"
         "    wgmma_tf32(acc, ph[kk], desc_k_major(va, kSbo), 1);\n",
         "    wgmma_tf32(acc, ph[kk], desc_k_major(va, kSbo), kk > 0);\n")],
    "qk_interleaved": [
        ("    wgmma_tf32(sc, desc_k_major(qa + L_t::kQ, DQ * 32), desc_k_major(ka, DQ * 32), 1);\n"
         "  }\n"
         "#pragma unroll\n"
         "  for (int kk = 0; kk < DQ / 8; ++kk)\n"
         "    wgmma_tf32(sc, desc_k_major(q + kk * 256, DQ * 32), desc_k_major(k + kk * 256, DQ * 32), 1);\n",
         "    wgmma_tf32(sc, desc_k_major(qa + L_t::kQ, DQ * 32), desc_k_major(ka, DQ * 32), 1);\n"
         "    wgmma_tf32(sc, desc_k_major(qa, DQ * 32), desc_k_major(ka, DQ * 32), 1);\n"
         "  }\n")],
    "no_qk": [("for (int kk = 0; kk < DQ / 8; ++kk) {\n    const uint32_t qa",
               "for (int kk = 0; kk < 0; ++kk) {\n    const uint32_t qa"),
              ("for (int kk = 0; kk < DQ / 8; ++kk)\n    wgmma_tf32(sc,",
               "for (int kk = 0; kk < 0; ++kk)\n    wgmma_tf32(sc,")],
    "no_pv": [("for (int kk = 0; kk < L_t::kKeys / 8; ++kk) {\n    const uint32_t va",
               "for (int kk = 0; kk < 0; ++kk) {\n    const uint32_t va")],
    "no_split": [("        split_k<BK, DQ>(L.raw(), L.k(), L_t::kK, tid);\n", ""),
                 ("        split_v<BK, DV>(L.raw(), L.v(), L_t::kV, tid);\n", "")],
    "no_loads": [("mbar_expect_tx(L.raw_full(), boxes * BK * 128);",
                  "mbar_arrive(L.raw_full());"),
                 ("          tma_load(smem_addr(L.raw()) + c * BK * 128, map, L.raw_full(), 32 * c, k0, hk, b);\n",
                  "          ;\n")],
}
#: the variants whose output is the kernel's own
CHECKED = {"kernel", "exp2f", "stages3", "no_overlap", "pingpong", "qk_interleaved"}
#: each dtype's kernel lies between its marker and the next section's
SECTIONS = {"bfloat16": ("// ---------------------------------------------------------------- bf16",
                         "// ---------------------------------------------------------------- float32"),
            "float32": ("// ---------------------------------------------------------------- float32",
                        "// cuTensorMapEncodeTiled looked up at run time")}
#: (label, B, H, H_kv, S, D, window), causal, on (B, S, H, D) tensors viewed
#: as (B, H, S, D) as the model passes them
CASES = (("internlm2-1.8b", 4, 16, 8, 4096, 128, 0),
         ("minicpm-2b", 4, 36, 36, 2048, 64, 0),
         ("h2o-danube-3-4b", 1, 32, 8, 8192, 120, 4096),
         ("ragged.bf16", 2, 8, 4, 1000, 128, 0),
         ("prefill_32k", 1, 16, 8, 32768, 128, 0))
#: the float32 kernel's: (label, B, H, H_kv, S, D_q, D_v, window), causal
F32_CASES = (("internlm2-1.8b.f32", 4, 16, 8, 4096, 128, 128, 0),
             ("deepseek-v2-lite-16b.mla.f32", 4, 16, 16, 4096, 192, 128, 0),
             ("zamba2-1.2b.f32", 4, 32, 32, 4096, 64, 64, 0))
#: the kernel vs the plain version in float32, per query row ÷ its rms
#: (chip_smoke.py's ROW_REL_TOL)
ROW_REL_TOL = {"bfloat16": 5e-2, "float32": 1e-3}


def patched(source: str, patches, dtype: str) -> str:
    """``source`` with ``patches`` applied to ``dtype``'s kernel alone."""
    start, end = (source.index(m) for m in SECTIONS[dtype])
    section = source[start:end]
    for old, new in patches:
        if old not in section:
            raise SystemExit(f"flash_ablation: {old!r} is not in the {dtype} "
                             "kernel's source; update its patches")
        section = section.replace(old, new)
    return source[:start] + section + source[end:]


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
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                    help="the kernel to take apart")
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
        dtype = getattr(torch, args.dtype)
        for name, patches in (PATCHES if args.dtype == "bfloat16" else F32_PATCHES).items():
            sources[name] = out / f"{name}.cu"
            sources[name].write_text(patched(src, patches, args.dtype))
        for spec in args.source:
            name, path = spec.split("=", 1)
            sources[name] = Path(path).resolve()
        libs = build(sources, out)

        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)

        def inputs(b, h, hkv, s, d, dv=None):
            return [torch.randn((b, s, n, w), generator=gen, device="cuda")
                    .to(dtype).transpose(1, 2)
                    for n, w in ((h, d), (hkv, d), (hkv, dv or d))]

        def run_with(lib, q, k, v, window):
            _build.library = lambda: lib
            return ops.flash_attention(q, k, v, causal=True, window=window)

        checks, exact_err = {}, {}
        for name, lib in libs.items():
            worst = exact = 0.0
            for b, h, hkv, s, d, dv, window in ((2, 8, 4, 1000, 128, 128, 0),
                                                (2, 8, 2, 777, 64, 64, 100),
                                                (2, 4, 4, 600, 120, 120, 0),
                                                (2, 4, 4, 600, 192, 128, 0),
                                                (2, 8, 4, 2048, 192, 192, 0)):
                q, k, v = inputs(b, h, hkv, s, d, dv)
                got = run_with(lib, q, k, v, window).float()
                want = ref.attention_ref(q.float(), k.float(), v.float(),
                                         causal=True, window=window)
                rms = want.pow(2).mean(-1, keepdim=True).sqrt().clamp_min(1e-30)
                # a NaN (an unchecked variant's) reads as inf, not lost by max
                worst = max(worst, float(((got - want).abs().amax(-1, keepdim=True)
                                          / rms).nan_to_num(float("inf")).max()))
                if args.dtype == "float32":   # float32-class: against float64
                    exact = max(exact, float((got.double() - ref.attention_ref(
                        q.double(), k.double(), v.double(), causal=True,
                        window=window)).abs().nan_to_num(float("inf")).max()))
            checks[name] = worst
            exact_err[name] = exact if args.dtype == "float32" else None
            if name in CHECKED and worst > ROW_REL_TOL[args.dtype]:
                print(f"flash_ablation: {name} is off the plain version by "
                      f"{worst:.3e} of a row's rms", file=sys.stderr)
                return 1

        order = list(libs)
        cases = (CASES if args.dtype == "bfloat16" else
                 [(label, b, h, hkv, s, d, window)
                  for label, b, h, hkv, s, d, _, window in F32_CASES])
        widths = {c[0]: c[6] for c in F32_CASES}
        for label, b, h, hkv, s, d, window in cases:
            q, k, v = inputs(b, h, hkv, s, d, widths.get(label))
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
                                  "sdpa_ms": sdpa_ms, "row_rel": checks[name],
                                  "max_abs_vs_float64": exact_err[name]}),
                      flush=True)
            del q, k, v
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown")
    return 0


if __name__ == "__main__":
    sys.exit(main())
