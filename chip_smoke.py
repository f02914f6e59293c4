#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--scale 1400] [--block-size 1048576]

Phases, one JSON line each (``{"phase": ...}``):

  1. card    — the card's name and power limit (``nvidia-smi``); TF32 off.
  2. build   — nvcc builds the kernels of ``src/repro_torch/kernels/csrc``.
  3. kernels — each kernel against its plain PyTorch version on the card,
               at the shapes the covar plan gives it (unaligned rows,
               out-of-range codes), with its time, the plain version's
               time, the ``index_add_`` time where one call computes the
               same function, and the least time the card could take;
               ``fused_scan_block`` both in the reference's packed form
               and in the parts form the main path launches (its covar
               fact case leads the summary).
  4. main    — ``make_retailer(scale)`` (84M fact rows at 1400),
               ``connect(..., device="cuda")`` and ``compute_covar`` fused,
               then unfused; launch counters of each run; the covar held
               against a float64 oracle computed on the card from the
               gathered join; ridge (closed form and BGD) against ridge on
               the oracle's covar.
  5. fused_covar — ``make_fused_covar`` over the same session: one
               ``covar_xtx`` launch per block of fact rows; the covar
               against the main phase's float64 oracle (N and C[0, 0]
               exact), ridge on it, a profile and peak memory.
  6. trees   — a ``DecisionTree`` regression fit with the reference's
               defaults on the same tables, fused then unfused, driven level
               by level through the stepping API: launch counters, the N of
               each level, and every level's statistics held against a
               float64 oracle computed on the card from the gathered join;
               the chosen splits' gains, the root count and the training
               RMSE (the tree walked over the gathered rows on the card).
  7. forest  — a 4-tree ``RandomForest`` (depth 3, up to 32 nodes a pass),
               fused: wall time, launches, training RMSE.
  8. chowliu — ``chow_liu`` over the eight categorical features with
               ``multi_root`` on and off: counts, MI and the learned tree
               against an int64 ``bincount`` oracle of the gathered join.
  9. cubes   — ``cube_via_engine`` and ``cube_rollup`` over three dimensions
               of three relations with two measures, per cell against a
               float64 ``index_add_`` oracle.
 10. polyreg — degree-2 polynomial regression over the eight continuous
               features (540 aggregates in one query): C and b against a
               float64 design-matrix oracle, the fit's training RMSE.
 11. moments — ``feature_moments`` against float64 sums, and
               ``expert_load_aggregate`` against ``bincount``.
 12. ivm     — ``OnlineRidge`` (the covar batch, every query rooted at the
               fact table) fitted over the same session, then six ticks of
               1% fact inserts and deletes (``benchmarks/bench_ivm.py``'s
               update, from ``--seed``), the last four under
               ``torch.cuda.set_sync_debug_mode("error")`` with no tick
               runner built: tick walls (apply to results on the host), the
               solve apart, ``fused_scan_block`` launches per tick; then
               the resident fact table against the host's ``apply_delta``
               sequence row for row, C / N / θ against a float64 oracle of
               the post-update join and against two fresh passes, the
               maintained batch's (rooted at the fact) and the session's
               ordinary batch's (the faster wall is the full recompute; the
               median steady tick must stay below half of it), the
               compaction alone, a profiled tick
               that must leave a pinned epoch's results bitwise unchanged,
               a snapshot restored into a fresh handle bitwise; then
               ``StreamingCube`` over the cubes phase's cube for two of the
               ticks, per cell against a float64 ``index_add_`` oracle.
 13. lm.f32  — internlm2-1.8b at full width and depth in float32, random
               weights from ``--seed`` on the card: the prefill
               ``forward(impl="flash")`` against ``forward(impl="dense")``
               (B = 2, S = 4096), ``BatchedServer.generate`` (batch 8,
               64-token prompts, 64 new tokens), then teacher-forced
               ``decode_step`` logits at all 128 positions against the flash
               forward over the same sequence; 24 kernel launches a forward,
               none in decode.
 14. lm.bf16 — the same model in its own dtype, bf16: warm prefill walls and
               tokens/s at B = 4, S = 4096 against the dense prefill, warm
               ``generate`` walls (ms per decode step), peak memory, and a
               device breakdown of one prefill and of a short decode; then
               the flash prefill against the float32 dense prefill on the
               same bf16 weights for three seeds, each layer's kernel output
               against the plain version on that layer's q, k, v, and the
               readings of planted faults.

The ``kernels`` phase also holds ``flash_attention`` against its plain
version at the attention shapes of internlm2-1.8b's prefill (the summary's
case), llama3-8b, minicpm-2b, h2o-danube-3-4b (window 4,096), a ragged
non-causal float32 case, a ragged causal bf16 one and ``prefill_32k``
(sampled rows), with
``scaled_dot_product_attention`` as the library time, on (B, H, S, D)
views of (B, S, H, D) tensors as the model passes them.  Besides allclose
at the reference's tolerances, each case is held per query row to a
limit on the scale of that row's output, and must read above that limit
against a plain version with a planted fault.

Every phase sets the kernels' launch counters to 0 before it runs its path
and reads them after.

Then the ``kernels`` summary line, the card line, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero before
the last line is printed.  The script needs one CUDA card and the
repository's ``src/`` beside it.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: |kernel − plain| ≤ KERNEL_RTOL · Σ|payload| of the output entry: both
#: sum float32 values in different orders (the kernel with shared-memory
#: atomics in a varying order), and the rounding of such a sum is bounded
#: by a multiple of eps · Σ|terms|
KERNEL_RTOL = 1e-4
#: max |C − C_oracle| / sqrt(C_ii · C_jj) — the float32 engine against the
#: float64 oracle, each entry scaled by its Cauchy–Schwarz bound (entries of
#: mixed-sign sums may cancel to near zero); 1e-4 is the reference's own
#: tolerance for float32 aggregates
COVAR_TOL = 1e-4
#: ridge: the training RMSE of θ (evaluated on the oracle's covar) must
#: match the oracle θ's to this relative tolerance ...
RMSE_TOL = 1e-5
#: ... and θ itself to this relative L2 distance: the one-hot blocks are
#: collinear with the intercept and only λ = 1e-3 separates them, so the
#: system amplifies the float32 rounding of C along those directions
THETA_TOL = 2e-2
#: N is the float32 COUNT aggregate.  The kernels add integer counts in
#: chunks whose partials stay below 2^24 (exact in float32) and combine the
#: chunks in double, so N must be the fact-row count rounded once to
#: float32: 84,000,000 itself at scale 1400
#: rows of the kernel-vs-plain checks: about one main-path row block, and
#: not a multiple of any block or chunk size
KERNEL_ROWS = 1_000_003
#: feature columns of the covar_xtx cases: the fused covar path's p over
#: Retailer (the main path) and over Favorita
XTX_WIDTHS = (70, 142)
#: frontier nodes of the tree kernels' cases: the last level of the depth-4
#: tree (1, 2, 4, 8, 16 nodes)
TREE_NODES = 16
#: the fact steps' reductions as the main path's lowering passes them, a
#: tensor a part: (kind, segments, part widths) or, for a histogram, (kind,
#: buckets, (nodes,)); the covar fact bucket's 45 aggregate columns of one
#: view and its five one-aggregate views of pulled widths, as Retailer's
#: covar plan has them; the tree fact bucket's 48 columns at TREE_NODES
PARTS_STEPS = {
    "fact_parts": [("seg", 4960, (1,) * 45 + (5, 6, 10, 25, 8)), ("seg", 40, (1,) * 4),
                   ("seg", 480, (1,) * 9 + (5, 6))],
    "tree_fact_parts": [("seg", 4960, (1,) * 48), ("hist", 40, (TREE_NODES,)),
                        ("hist", 480, (TREE_NODES,))],
}
#: |stat − oracle| ≤ STAT_TOL · Σ|terms| per tree statistic (Σcond, Σcond·|y|,
#: Σcond·y²): the engine sums in float32, per row block, in a varying order
STAT_TOL = 1e-4
#: a chosen split's gain under the oracle's statistics is within this
#: (relative) of the best gain at its node: float32 statistics may swap
#: near-equal candidates, never pick a clearly worse one
GAIN_TOL = 1e-4
#: the root count against the fact rows: bucket counts above 2^24 (the
#: zipf-heavy location holds about a quarter of the rows) round once each
#: in the float32 accumulator of a step
ROOT_N_TOL = 1e-5
#: a tree or forest learns: training RMSE ≤ this × the label's std
RMSE_RATIO = 0.8
#: attention kernel vs its plain version in float32 on the same inputs, and
#: the float32 flash prefill vs the dense one: the reference's own bounds
#: (tests/test_kernels.py:185,197, tests/test_models.py:109), as allclose's
#: rtol = atol
ATTN_TOL = {"float32": 2e-3, "bfloat16": 5e-2}
#: teacher-forced decode logits vs the prefill's (tests/test_models.py:70)
DECODE_TOL = 5e-3
#: flash_attention vs its plain version, per query row: max |Δ| over the
#: row ÷ the row's rms.  allclose's atol does not scale with the output
#: (|o| ≈ sqrt(e/n) for a row that sees n keys of randn inputs, 0.026 at
#: n = 4,096), so it cannot see a dropped key tile; this can: in bf16 it
#: reads the output's rounding (at most 2⁻⁸ of an element), a planted fault
#: reads far more (both readings: PERF.md)
ROW_REL_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
#: the bf16 flash prefill vs the float32 dense prefill on the same (bf16)
#: weights: max |Δlogits| / max |logits|
BF16_PREFILL_TOL = 5e-2
#: seeds (from --seed on) of the bf16 prefill check's weights and tokens
BF16_CHECK_SEEDS = 3
#: the cube of the cubes and ivm phases: three categorical dimensions of
#: three relations, the fact label and a Weather attribute as measures
CUBE_DIMS = ("rain", "rgn_cd", "category")
CUBE_MEASURES = ("inventoryunits", "maxtemp")
#: ivm: each tick inserts and deletes this share of the fact rows
#: (benchmarks/bench_ivm.py's _fact_update), the first IVM_WARM of
#: IVM_TICKS ticks warm up, and StreamingCube takes IVM_CUBE_TICKS of them
IVM_FRAC = 0.01
IVM_TICKS = 6
IVM_WARM = 2
IVM_CUBE_TICKS = 2
#: ivm: the median steady tick must take less than this share of a full
#: recompute's wall (a tick scans 2 of the pass's 81 fact blocks)
IVM_TICK_RATIO = 0.5
#: polyreg: the training RMSE of θ (on the oracle's statistics) against the
#: oracle θ's, relative.  θ itself is not held to a bound: 45 monomials of 8
#: features that take 30 to 4,960 distinct values are nearly collinear, and
#: only λ = 1e-3 on the scaled features separates them
POLY_RMSE_TOL = 1e-4


T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line; ``at_s`` is the seconds since the script started."""
    print(json.dumps({"phase": phase, **fields,
                      "at_s": time.perf_counter() - T_START}), flush=True)


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def card_rates(name: str):
    """(HBM bytes/s, float32 FLOP/s outside the tensor cores, dense bf16
    tensor-core FLOP/s) from NVIDIA's data sheets, by the card's reported
    name; dense TF32 is half the bf16 rate."""
    if "PCIe" in name:
        return 2.0e12, 51e12, 756e12
    if "NVL" in name:
        return 3.9e12, 60e12, 835e12
    return 3.35e12, 67e12, 989e12    # H100 SXM


def cuda_ms(fn, reps: int = 10) -> float:
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


# ---------------------------------------------------------------- kernels

def random_inputs(specs, n: int, gen):
    """codes (n, C) with ~4% of codes outside [0, S) on each side, and a
    payload whose hist cond columns are 0/1 and whose y-triples are
    [1, y, y²] — the packing the covar plan launches."""
    import torch

    n_codes = 1 + max(sp.code_col for sp in specs)
    width = max(sp.pay_off + sp.width if sp.kind == "seg"
                else max(sp.pay_off + sp.n_cond, sp.yk_off + 3) for sp in specs)
    codes = torch.empty((n, n_codes), dtype=torch.int32, device="cuda")
    for sp in specs:
        spill = max(1, sp.n_segments // 25)
        codes[:, sp.code_col] = torch.randint(
            -spill, sp.n_segments + spill, (n,), generator=gen, device="cuda",
            dtype=torch.int32)
    fpay = torch.randn((n, width), generator=gen, device="cuda")
    for sp in specs:
        if sp.kind == "hist":
            fpay[:, sp.pay_off:sp.pay_off + sp.n_cond] = (
                fpay[:, sp.pay_off:sp.pay_off + sp.n_cond] > 0).float()
            y = fpay[:, sp.yk_off + 1]
            fpay[:, sp.yk_off] = 1.0
            fpay[:, sp.yk_off + 2] = y * y
    return codes.contiguous(), fpay.contiguous()


def compare(got, want, abs_want, what: str):
    """Max abs and scaled error of kernel outputs against the plain ones."""
    import torch

    max_abs, max_rel = 0.0, 0.0
    for g, w, a in zip(got, want, abs_want):
        check(tuple(g.shape) == tuple(w.shape), f"{what}: shape {tuple(g.shape)} != {tuple(w.shape)}")
        check(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
        err = (g - w).abs()
        max_abs = max(max_abs, float(err.max()))
        max_rel = max(max_rel, float((err / (a + 1e-30)).max()))
    check(max_rel <= KERNEL_RTOL,
          f"{what}: |kernel - plain| / sum|payload| = {max_rel:.3e} > {KERNEL_RTOL}")
    return max_abs, max_rel


def ptxas_report(log: str, namespace: str):
    """Registers and spills of each kernel whose mangled name holds
    ``namespace``, from nvcc's ``-Xptxas -v`` log."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
            name = fn if namespace in fn else None
        elif name and ("Used" in ln or "spill" in ln):
            out.setdefault(name, []).append(ln.split("info    :")[-1].strip())
    return out


def launch_geometry(plan):
    """The grids and items of a seg_reduce.cuh launch, and the registers and
    spills of its kernels."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import seg_aggregate as kseg

    lay = plan.launch
    names = ("one block SEG", "segment ranges SEG", "one block HIST", "segment ranges HIST")
    return dict(grids=[dict(kernel=names[g.kernel], blocks=g.n_items, chunks=g.n_chunks,
                            chunk_rows=g.chunk_rows, smem_bytes=g.smem_bytes,
                            blocks_at_once=g.wave_blocks) for g in lay.grids],
                reductions=[dict(kind=sh.kind, segments=sh.n_segments, width=sh.width,
                                 kernel=names[kseg.kernel_of(sh, sub)], blocks=len(sub.items),
                                 copies=sub.copies)
                            for sh, sub in zip(lay.shapes, lay.layouts)],
                scratch_bytes=4 * lay.scratch_numel,
                ptxas=ptxas_report(_build.build_log, "seg_reduce"))


def in_range_rows(codes, specs):
    return [int(((codes[:, sp.code_col] >= 0)
                 & (codes[:, sp.code_col] < sp.n_segments)).sum()) for sp in specs]


def kernel_phase(args, plan_specs, rates):
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import covar_xtx as kxtx
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import seg_aggregate as kseg

    bw, flops, bf16 = rates
    tf32 = bf16 / 2
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    n = KERNEL_ROWS
    results = {}

    # -- fused_scan_block at the covar plan's fact and Items steps, and at
    # the tree plan's fact step for TREE_NODES frontier nodes.  Library
    # time: the sum of one index_add_ per spec on payloads formed beforehand
    fused_cases = []
    for label in ("fact", "items", "tree_fact"):
        specs = plan_specs[label]
        codes, fpay = random_inputs(specs, n, gen)
        got = ops.fused_scan_block(codes, fpay, specs)
        want = ref.fused_scan_block_ref(codes, fpay, specs)
        abs_want = ref.fused_scan_block_ref(codes, fpay.abs(), specs)
        torch.cuda.synchronize()
        max_abs, max_rel = compare(got, want, abs_want, f"fused_scan_block[{label}]")
        ms = cuda_ms(lambda: ops.fused_scan_block(codes, fpay, specs))
        plain_ms = cuda_ms(lambda: ref.fused_scan_block_ref(codes, fpay, specs))
        rows = in_range_rows(codes, specs)
        nbytes = (codes.numel() + fpay.numel()) * 4 + sum(
            sp.n_segments * sp.width * 4 for sp in specs)
        ops_n = sum(r * sp.width * (2 if sp.kind == "hist" else 1)
                    for r, sp in zip(rows, specs))
        sids, pays, outs = [], [], []
        for sp in specs:
            code = codes[:, sp.code_col]
            ok = (code >= 0) & (code < sp.n_segments)
            sids.append(torch.where(ok, code, torch.zeros_like(code)).long())
            if sp.kind == "seg":
                pay = fpay[:, sp.pay_off:sp.pay_off + sp.width]
            else:
                cond = fpay[:, sp.pay_off:sp.pay_off + sp.n_cond]
                yk = fpay[:, sp.yk_off:sp.yk_off + 3]
                pay = (cond[:, :, None] * yk[:, None, :]).reshape(n, sp.width)
            pays.append((pay * ok[:, None].float()).contiguous())
            outs.append(torch.zeros((sp.n_segments, sp.width), device="cuda"))

        def library():
            for o, i, p in zip(outs, sids, pays):
                o.index_add_(0, i, p)

        shapes = tuple(kseg.Shape("seg", sp.n_segments, (sp.width,), sp.width)
                       if sp.kind == "seg" else
                       kseg.Shape("hist", sp.n_segments, (sp.n_cond, 3), sp.width)
                       for sp in specs)
        case = dict(case=label, form="packed", n=n,
                    specs=[list(map(str, (sp.kind, sp.n_segments, sp.width))) for sp in specs],
                    geometry=launch_geometry(kseg.launch_plan(n, shapes, codes.device)),
                    max_abs_err=max_abs, max_rel_err=max_rel, ms=ms,
                    plain_ms=plain_ms, library_ms=cuda_ms(library),
                    library_call="the sum of one index_add_ per spec on payloads formed beforehand",
                    **bound(nbytes, ops_n, bw, flops))
        emit("kernel", name="fused_scan_block", **case)
        fused_cases.append(case)
        del codes, fpay, got, want, abs_want, sids, pays, outs

    # -- fused_scan_block in the parts form, as the main path's lowering
    # passes the covar and tree fact steps: each aggregate column a tensor
    # of its own, a pulled block a row-major (n, w) tensor, a histogram's
    # node masks read transposed from (N, n), y formed on the card
    for label, steps in PARTS_STEPS.items():
        reds, absr, sids, pays, nbytes, ops_n = [], [], [], [], 0, 0
        for kind, S, widths in steps:
            spill = max(1, S // 25)
            code = torch.randint(-spill, S + spill, (n,), generator=gen, device="cuda",
                                 dtype=torch.int32)
            ok = (code >= 0) & (code < S)
            rows_in = int(ok.sum())
            if kind == "seg":
                vals = [torch.randn((n, w) if w > 1 else (n,), generator=gen, device="cuda")
                        for w in widths]
                offs = [sum(widths[:i]) for i in range(len(widths))]
                reds.append(ops.Parts("seg", code, tuple(map(ops.Part, vals, offs)), S))
                absr.append(ops.Parts("seg", code, tuple(ops.Part(v.abs(), o)
                                                         for v, o in zip(vals, offs)), S))
                pay = torch.cat([v.reshape(n, -1) for v in vals], 1)
                width = sum(widths)
                ops_n += rows_in * width
            else:
                (n_cond,) = widths
                mask = (torch.rand((n_cond, n), generator=gen, device="cuda") < 0.5).float()
                y = torch.randn((n,), generator=gen, device="cuda")
                reds.append(ops.Parts("hist", code, (mask.t(), y), S))
                absr.append(ops.Parts("hist", code, (mask.t(), y.abs()), S))
                yk = torch.stack([torch.ones_like(y), y, y * y], 1)
                pay = (mask.t()[:, :, None] * yk[:, None, :]).reshape(n, 3 * n_cond)
                width = 3 * n_cond
                ops_n += 2 * rows_in * width
            nbytes += 4 * (n + n * sum(widths) + (n if kind == "hist" else 0) + S * width)
            sids.append(torch.where(ok, code, torch.zeros_like(code)).long())
            pays.append((pay * ok[:, None].float()).contiguous())
        got = ops.fused_scan_parts(reds)
        want = ref.fused_scan_parts_ref(reds)
        abs_want = ref.fused_scan_parts_ref(absr)
        torch.cuda.synchronize()
        max_abs, max_rel = compare(got, want, abs_want, f"fused_scan_parts[{label}]")
        outs = [torch.zeros_like(g) for g in got]

        def library():
            for o, i, p in zip(outs, sids, pays):
                o.index_add_(0, i, p)

        shapes = tuple(kseg.Shape("seg", S, tuple(ws), sum(ws)) if kind == "seg" else
                       kseg.Shape("hist", S, (ws[0], 1), 3 * ws[0]) for kind, S, ws in steps)
        case = dict(case=label, form="parts", n=n,
                    specs=[[kind, S, len(ws), sum(ws)] for kind, S, ws in steps],
                    geometry=launch_geometry(kseg.launch_plan(n, shapes, code.device)),
                    max_abs_err=max_abs, max_rel_err=max_rel,
                    ms=cuda_ms(lambda: ops.fused_scan_parts(reds)),
                    plain_ms=cuda_ms(lambda: ref.fused_scan_parts_ref(reds)),
                    library_ms=cuda_ms(library),
                    library_call="the sum of one index_add_ per reduction on payloads "
                                 "packed beforehand",
                    **bound(nbytes, ops_n, bw, flops))
        emit("kernel", name="fused_scan_block", **case)
        fused_cases.append(case)
        del reds, absr, sids, pays, outs, got, want, abs_want
    # -- fused_scan_block at the fact's delta step of a maintained covar
    # batch (every query rooted at the fact), as the lowering passes it:
    # one 1-segment reduction that every row enters, its parts the views'
    # aggregate columns at a stride of their view's aggregates; the same
    # parts with each part's columns adjacent (stride 1); and the same
    # layout with values like a tick's (case ivm_fact_one_hot): one column
    # of a part's row ±1, the rest 0 (a one-hot group-by column times a
    # signed row weight)
    S, parts, width = plan_specs["ivm_fact"]
    code = torch.zeros((n,), dtype=torch.int32, device="cuda")
    vals = [torch.randn((n, w) if w > 1 else (n,), generator=gen, device="cuda")
            for w, _, _ in parts]
    reds = [ops.Parts("seg", code, tuple(ops.Part(v, o, s) for v, (_, o, s) in zip(vals, parts)),
                      S, width)]
    absr = [ops.Parts("seg", code, tuple(ops.Part(v.abs(), o, s)
                                         for v, (_, o, s) in zip(vals, parts)), S, width)]
    offs = [sum(w for w, _, _ in parts[:i]) for i in range(len(parts))]
    adjacent = [ops.Parts("seg", code, tuple(map(ops.Part, vals, offs)), S, width)]
    sign = torch.randint(0, 2, (n, 1), generator=gen, device="cuda").float() * 2 - 1

    def signed_one_hot(w):
        x = torch.zeros((n, w), device="cuda").scatter_(
            1, torch.randint(0, w, (n, 1), generator=gen, device="cuda"), sign)
        return x[:, 0] if w == 1 else x

    hot = [signed_one_hot(w) for w, _, _ in parts]
    onehot = [ops.Parts("seg", code, tuple(ops.Part(v, o, s) for v, (_, o, s) in zip(hot, parts)),
                        S, width)]
    got = ops.fused_scan_parts(reds)
    want = ref.fused_scan_parts_ref(reds)
    abs_want = ref.fused_scan_parts_ref(absr)
    torch.cuda.synchronize()
    max_abs, max_rel = compare(got, want, abs_want, "fused_scan_parts[ivm_fact_parts]")
    del absr
    abs_hot = [ops.Parts("seg", code, tuple(ops.Part(v.abs(), o, s)
                                            for v, (_, o, s) in zip(hot, parts)), S, width)]
    got = ops.fused_scan_parts(onehot)
    want = ref.fused_scan_parts_ref(onehot)
    abs_want = ref.fused_scan_parts_ref(abs_hot)
    torch.cuda.synchronize()
    hot_abs, hot_rel = compare(got, want, abs_want,
                               "fused_scan_parts[ivm_fact_parts, signed one-hot]")
    del abs_hot, abs_want
    pay = torch.cat([v.reshape(n, -1) for v in vals], 1)
    hot_pay = torch.cat([v.reshape(n, -1) for v in hot], 1)
    sid = code.long()
    lib_out = torch.zeros((S, width), device="cuda")
    case = dict(case="ivm_fact_parts", form="parts", n=n,
                specs=[["seg", S, len(parts), width]],
                geometry=launch_geometry(kseg.launch_plan(
                    n, (kseg.Shape("seg", S, tuple(w for w, _, _ in parts), width),),
                    code.device)),
                max_abs_err=max_abs, max_rel_err=max_rel,
                ms=cuda_ms(lambda: ops.fused_scan_parts(reds)),
                adjacent_columns_ms=cuda_ms(lambda: ops.fused_scan_parts(adjacent)),
                plain_ms=cuda_ms(lambda: ref.fused_scan_parts_ref(reds)),
                library_ms=cuda_ms(lambda: lib_out.index_add_(0, sid, pay)),
                library_call="index_add_ on the payload packed beforehand",
                **bound(4 * (n + n * width + S * width), n * width, bw, flops))
    emit("kernel", name="fused_scan_block", **case)
    fused_cases.append(case)
    # the same launch on a tick's values
    case = dict(case, case="ivm_fact_one_hot", max_abs_err=hot_abs, max_rel_err=hot_rel,
                ms=cuda_ms(lambda: ops.fused_scan_parts(onehot)),
                plain_ms=cuda_ms(lambda: ref.fused_scan_parts_ref(onehot)),
                library_ms=cuda_ms(lambda: lib_out.index_add_(0, sid, hot_pay)))
    del case["adjacent_columns_ms"]
    emit("kernel", name="fused_scan_block", **case)
    fused_cases.append(case)
    del reds, adjacent, onehot, hot, sign, vals, pay, hot_pay, sid, lib_out, got, want, code
    # the main path launches the parts form: its covar fact case leads
    fused_cases.sort(key=lambda c: c["case"] != "fact_parts")
    results["fused_scan_block"] = fused_cases

    # -- seg_aggregate at the unfused fact bucket (the widest spec)
    fact = plan_specs["fact"]
    sp = max(fact, key=lambda s: s.n_segments * s.width)
    codes, fpay = random_inputs((ops.ReduceSpec("seg", 0, sp.n_segments, sp.width, 0),), n, gen)
    seg = codes[:, 0].contiguous()
    plan = kseg.seg_plan(n, sp.n_segments, sp.width, seg.device)
    lay, (grid,) = plan.launch.layouts[0], plan.launch.grids
    geometry = dict(mode=("one block", "segment ranges")[lay.mode],
                    blocks_at_once=grid.wave_blocks,
                    blocks=[(it[1], it[3]) for it in lay.items],
                    ring_stages=(kseg.STAGES_A, 1)[lay.mode],
                    stage_rows=lay.stage_rows if lay.mode == 0 else kseg.STAGE_ROWS_B,
                    chunks=grid.n_chunks, chunk_rows=grid.chunk_rows,
                    smem_bytes=lay.smem_bytes,
                    scratch_bytes=4 * plan.launch.scratch_numel,
                    ptxas=ptxas_report(_build.build_log, "seg_reduce"))
    got = ops.seg_aggregate(seg, fpay, sp.n_segments)
    want = ref.seg_aggregate_ref(seg, fpay, sp.n_segments)
    abs_want = ref.seg_aggregate_ref(seg, fpay.abs(), sp.n_segments)
    max_abs, max_rel = compare([got], [want], [abs_want], "seg_aggregate")
    ok = (seg >= 0) & (seg < sp.n_segments)
    sid = torch.where(ok, seg, torch.zeros_like(seg)).long()
    pay = fpay * ok[:, None].float()
    lib_out = torch.zeros((sp.n_segments, sp.width), device="cuda")
    case = dict(case="fact", n=n, n_segments=sp.n_segments, width=sp.width,
                geometry=geometry, max_abs_err=max_abs, max_rel_err=max_rel,
                ms=cuda_ms(lambda: ops.seg_aggregate(seg, fpay, sp.n_segments)),
                plain_ms=cuda_ms(lambda: ref.seg_aggregate_ref(seg, fpay, sp.n_segments)),
                library_ms=cuda_ms(lambda: lib_out.index_add_(0, sid, pay)),
                **bound((seg.numel() + fpay.numel() + sp.n_segments * sp.width) * 4,
                        int(ok.sum()) * sp.width, bw, flops))
    emit("kernel", name="seg_aggregate", **case)
    results["seg_aggregate"] = [case]
    del codes, fpay, seg, got, want, abs_want, sid, pay

    # -- tree_hist at the Items step's hist view
    hs = next(s for s in plan_specs["items"] if s.kind == "hist")
    D = hs.n_segments
    spill = max(1, D // 25)
    codes = torch.randint(-spill, D + spill, (n,), generator=gen, device="cuda", dtype=torch.int32)
    y = torch.randn((n,), generator=gen, device="cuda")
    cond = (torch.rand((n,), generator=gen, device="cuda") < 0.5).float()
    got = ops.tree_hist(codes, y, cond, D)
    want = ref.tree_hist_ref(codes, y, cond, D)
    abs_want = ref.tree_hist_ref(codes, y.abs(), cond, D)
    max_abs, max_rel = compare([got], [want], [abs_want], "tree_hist")
    ok = (codes >= 0) & (codes < D)
    sid = torch.where(ok, codes, torch.zeros_like(codes)).long()
    pay = torch.stack([cond, cond * y, cond * y * y], 1) * ok[:, None].float()
    lib_out = torch.zeros((D, 3), device="cuda")
    case = dict(case="items", n=n, n_buckets=D, max_abs_err=max_abs,
                max_rel_err=max_rel,
                ms=cuda_ms(lambda: ops.tree_hist(codes, y, cond, D)),
                plain_ms=cuda_ms(lambda: ref.tree_hist_ref(codes, y, cond, D)),
                library_ms=cuda_ms(lambda: lib_out.index_add_(0, sid, pay)),
                **bound(n * 12 + D * 12, int(ok.sum()) * 5, bw, flops))
    emit("kernel", name="tree_hist", **case)
    results["tree_hist"] = [case]
    del codes, y, cond, got, want, abs_want, sid, pay

    # -- tree_hist_batched at the tree plan's sku histogram (unfused path)
    hs = max((s for s in plan_specs["tree_fact"] if s.kind == "hist"),
             key=lambda s: s.n_segments)
    D, N = hs.n_segments, hs.n_cond
    spill = max(1, D // 25)
    codes = torch.randint(-spill, D + spill, (n,), generator=gen, device="cuda", dtype=torch.int32)
    y = torch.randn((n,), generator=gen, device="cuda")
    cond = (torch.rand((n, N), generator=gen, device="cuda") < 0.5).float()
    got = ops.tree_hist_batched(codes, y, cond, D)
    want = ref.tree_hist_batched_ref(codes, y, cond, D)
    abs_want = ref.tree_hist_batched_ref(codes, y.abs(), cond, D)
    max_abs, max_rel = compare([got], [want], [abs_want], "tree_hist_batched")
    ok = (codes >= 0) & (codes < D)
    sid = torch.where(ok, codes, torch.zeros_like(codes)).long()
    yk = torch.stack([torch.ones_like(y), y, y * y], 1)
    pay = ((cond[:, :, None] * yk[:, None, :]).reshape(n, 3 * N)
           * ok[:, None].float())
    lib_out = torch.zeros((D, 3 * N), device="cuda")
    case = dict(case="tree_fact", n=n, n_buckets=D, n_nodes=N,
                geometry=launch_geometry(kseg.launch_plan(
                    n, (kseg.Shape("hist", D, (N, 1), 3 * N),), codes.device)),
                max_abs_err=max_abs, max_rel_err=max_rel,
                ms=cuda_ms(lambda: ops.tree_hist_batched(codes, y, cond, D)),
                plain_ms=cuda_ms(lambda: ref.tree_hist_batched_ref(codes, y, cond, D)),
                library_ms=cuda_ms(lambda: lib_out.index_add_(0, sid, pay)),
                **bound(n * (8 + 4 * N) + D * 3 * N * 4,
                        int(ok.sum()) * 3 * N * 2, bw, flops))
    emit("kernel", name="tree_hist_batched", **case)
    results["tree_hist_batched"] = [case]
    del codes, y, cond, got, want, abs_want, sid, pay, yk

    # -- covar_xtx at the fused covar path's blocks: Retailer's p = 70 and
    # Favorita's p = 142 feature columns, w 0/1.  Bound: its bytes against
    # its three TF32 products of the upper triangle on the tensor cores
    xtx_cases = []
    for f in XTX_WIDTHS:
        x = torch.randn((n, f), generator=gen, device="cuda")
        w = (torch.rand((n,), generator=gen, device="cuda") < 0.9).float()
        rows = kxtx.step_rows(f)
        stages = kxtx.ring_stages(f, rows)
        smem = kxtx.smem_bytes(f, stages, rows)
        groups = kxtx.groups(f)
        wave = kxtx._wave(x.device, stages, rows, smem, _build.library())
        chunk_rows, n_chunks = kxtx.chunking(n, max(1, wave // len(groups)))
        geometry = dict(pieces=kxtx.pieces(f), groups=len(groups), step_rows=rows,
                        ring_stages=stages, smem_bytes=smem,
                        chunks=n_chunks, chunk_rows=chunk_rows,
                        ptxas=ptxas_report(_build.build_log, "3xtx"))
        got = ops.covar_xtx(x, w)
        want = ref.covar_xtx_ref(x, w)
        abs_want = ref.covar_xtx_ref(x.abs(), w)
        max_abs, max_rel = compare([got], [want], [abs_want], f"covar_xtx[{f}]")
        check(torch.equal(got, got.t()), f"covar_xtx[{f}]: not symmetric")
        case = dict(case=f"p{f}", n=n, f=f, geometry=geometry, max_abs_err=max_abs,
                    max_rel_err=max_rel,
                    ms=cuda_ms(lambda: ops.covar_xtx(x, w)),
                    plain_ms=cuda_ms(lambda: ref.covar_xtx_ref(x, w)),
                    library_ms=cuda_ms(lambda: torch.mm(x.t(), x * w[:, None])),
                    bound_rate="3xTF32 at the dense TF32 tensor-core rate",
                    **bound((n * f + n + f * f) * 4, 3 * n * f * (f + 1), bw, tf32))
        emit("kernel", name="covar_xtx", **case)
        xtx_cases.append(case)
        del x, w, got, want, abs_want
    results["covar_xtx"] = xtx_cases
    return results


def bound(nbytes: int, n_ops: int, bw: float, flops: float):
    t_bytes, t_ops = nbytes / bw * 1e3, n_ops / flops * 1e3
    return dict(bytes=nbytes, ops=n_ops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------- main path

class FactJoin:
    """The Retailer join gathered on the card, a chunk of fact rows at a
    time.  Every dimension row is addressed by a dense key of the fact row:
    Weather by date·n_locn + locn, Location by locn, Census by
    Location.zip[locn], Items by sku."""

    def __init__(self, data, chunk: int = 1 << 22):
        import torch

        self.rel = {name: data.relation(name).columns for name in data.relations}
        inv, wea, loc, cen, itm = (self.rel[r] for r in ("Inventory", "Weather", "Location", "Census", "Items"))
        self.n_locn = loc["locn"].shape[0]
        ar = lambda t: torch.arange(t.shape[0], device=t.device, dtype=t.dtype)
        check(bool((wea["date"].long() * self.n_locn + wea["locn"].long() == ar(wea["date"]).long()).all())
              and bool((loc["locn"] == ar(loc["locn"])).all())
              and bool((cen["zip"] == ar(cen["zip"])).all())
              and bool((itm["sku"] == ar(itm["sku"])).all()),
              "oracle: dimension tables are not densely keyed")
        self.home = {a: r for r, cols in (("Weather", wea), ("Location", loc), ("Census", cen), ("Items", itm))
                     for a in cols}
        self.n = inv["date"].shape[0]
        self.chunk = chunk

    def chunks(self):
        """Yields ``(rows, col)`` per chunk: ``col(attr)`` is the attribute's
        column over the chunk's joined rows."""
        inv, loc = self.rel["Inventory"], self.rel["Location"]
        for s in range(0, self.n, self.chunk):
            e = min(self.n, s + self.chunk)
            locn = inv["locn"][s:e].long()
            rows = {"Weather": inv["date"][s:e].long() * self.n_locn + locn,
                    "Location": locn, "Census": loc["zip"].long()[locn],
                    "Items": inv["sku"][s:e].long()}

            def col(a, s=s, e=e, rows=rows):
                if a in inv:
                    return inv[a][s:e]
                return self.rel[self.home[a]][a][rows[self.home[a]]]

            yield e - s, col


def oracle_covar(join, layout):
    """float64 XᵀX of the gathered join, on the card."""
    import torch

    p = layout.p
    G = torch.zeros((p, p), dtype=torch.float64, device="cuda")
    for m, col in join.chunks():
        X = torch.zeros((m, p), dtype=torch.float64, device="cuda")
        X[:, 0] = 1.0
        for a in layout.cont:
            X[:, layout.cont_idx(a)] = col(a).double()
        for a in layout.cat:
            X.scatter_(1, (layout.cat_offsets[a] + col(a).long())[:, None], 1.0)
        X[:, layout.label_idx] = col(layout.label).double()
        G += X.T @ X
    return G.cpu().numpy(), float(join.n)


def device_breakdown(fn, top: int = 8, classify=None):
    """Run ``fn`` once under ``torch.profiler``: device time by kernel name
    (the ``top`` largest), the device's busy time (sum of kernel times: one
    stream, so they do not overlap) and the host wall of the profiled run;
    with ``classify`` (kernel name -> group), device time by group too."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = e.name[:100]
            by_name[key] = by_name.get(key, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    busy = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    out = dict(profiled_wall_ms=wall * 1e3, device_busy_ms=busy,
               idle_share=1 - busy / (wall * 1e3) if wall > 0 else None,
               n_kernel_names=len(by_name), trace_read_s=time.perf_counter() - t0,
               top=[[k, v] for k, v in ranked])
    if classify is not None:
        groups = {}
        for k, v in by_name.items():
            g = classify(k)
            groups[g] = groups.get(g, 0.0) + v
        out["groups_ms"] = dict(sorted(groups.items(), key=lambda kv: -kv[1]))
    return out


def kernel_group(name: str) -> str:
    """The port's kernel a device kernel belongs to, by its namespace (the
    partial and combine passes together), or "other"."""
    for prefix, group in (("seg_reduce::", "seg_reduce (fused_scan_block, seg_aggregate, tree_hist*)"),
                          ("xtx::", "covar_xtx")):
        if name.startswith(prefix) or f" {prefix}" in name:
            return group
    return "other"


def scaled_err(C, G):
    import numpy as np

    d = np.sqrt(np.maximum(np.outer(np.diag(G), np.diag(G)), 1e-300))
    return float((np.abs(C - G) / d).max())


def load_data(args):
    """Retailer at ``args.scale`` on the card: ``(dataset, session)``."""
    import torch

    from repro_torch.api import ExecutionConfig, connect
    from repro_torch.data import datasets as TD

    t0 = time.perf_counter()
    ds = TD.make("retailer", scale=args.scale, seed=args.seed)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    db = connect(ds, config=ExecutionConfig(block_size=args.block_size), device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    sizes = db.sizes()
    emit("main.data", scale=args.scale, rows=sizes, fact_rows=sizes[ds.fact],
         block_size=args.block_size, generate_s=gen_s, to_device_s=load_s,
         reduced=None if args.scale >= 1400 else
         f"scale {args.scale} instead of 1400 (fact rows {sizes[ds.fact]} of 84,000,000)")
    return ds, db


def main_phase(ds, db, join):
    import numpy as np
    import torch

    from repro_torch.api import connect
    from repro_torch.kernels import ops
    from repro_torch.ml.covar import compute_covar

    cfg = db.config
    sizes = db.sizes()
    runs = {}
    for label, fuse in (("fused", True), ("unfused", False)):
        sess = connect(ds.schema, data=db.data, edges=ds.edges,
                       config=cfg.replace(fuse_kernels=fuse))
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        C, N, layout, batch = compute_covar(ds, database=sess)
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        # a second, warm pass of the compiled batch: no compile in its wall
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = batch(sess.data)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        del out
        emit(f"main.{label}.profile", **device_breakdown(lambda: batch(sess.data),
                                                          classify=kernel_group))
        stats = batch.stats
        n_blocks = sum(-(-sizes[st.rel] // min(cfg.block_size, sizes[st.rel]))
                       for st in batch.schedule.steps)
        runs[label] = dict(C=C, N=N, layout=layout, launches=launches)
        emit(f"main.{label}", wall_s=wall, warm_wall_s=warm, launches=launches,
             static_launches=stats.n_kernel_launches, scan_steps=stats.n_scan_steps,
             row_blocks=n_blocks, summary=stats.summary(),
             peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
        check(np.isfinite(C).all() and C.shape == (layout.p, layout.p),
              f"{label}: covar not finite or of shape {C.shape}")
        check(np.allclose(C, C.T), f"{label}: covar not symmetric")
        check(N == float(np.float32(sizes[ds.fact])),
              f"{label}: N={N} is not {sizes[ds.fact]} fact rows in float32")
        if fuse:
            check(stats.n_kernel_launches == 8, f"fused static launches {stats.n_kernel_launches} != 8")
            check(launches["fused_scan_block"] == n_blocks,
                  f"fused run launched fused_scan_block {launches['fused_scan_block']} times, "
                  f"expected {n_blocks}")
        else:
            check(stats.n_kernel_launches == 28, f"unfused static launches {stats.n_kernel_launches} != 28")
            check(launches["seg_aggregate"] > 0 and launches["tree_hist"] > 0
                  and launches["fused_scan_block"] == 0,
                  f"unfused run launches {launches}")

    layout = runs["fused"]["layout"]
    C, N = runs["fused"]["C"], runs["fused"]["N"]
    t0 = time.perf_counter()
    G, n_o = oracle_covar(join, layout)
    oracle_s = time.perf_counter() - t0
    err_fused = scaled_err(C, G)
    err_unfused = scaled_err(runs["unfused"]["C"], G)
    err_pair = scaled_err(runs["unfused"]["C"], C)
    emit("main.oracle", oracle_s=oracle_s, tol=COVAR_TOL,
         fused_vs_oracle=err_fused, unfused_vs_oracle=err_unfused,
         unfused_vs_fused=err_pair, N=N, N_oracle=n_o)
    check(n_o == sizes[ds.fact], f"oracle N {n_o} != {sizes[ds.fact]} fact rows")
    check(err_fused <= COVAR_TOL, f"fused covar vs oracle {err_fused:.3e} > {COVAR_TOL}")
    check(err_unfused <= COVAR_TOL, f"unfused covar vs oracle {err_unfused:.3e} > {COVAR_TOL}")
    check(err_pair <= COVAR_TOL, f"unfused vs fused covar {err_pair:.3e} > {COVAR_TOL}")

    ridge_checks("main.ridge", C, N, layout, G, n_o)
    # each kernel's launches on the path that runs it
    launches = {"fused_scan_block": runs["fused"]["launches"]["fused_scan_block"],
                "seg_aggregate": runs["unfused"]["launches"]["seg_aggregate"],
                "tree_hist": runs["unfused"]["launches"]["tree_hist"]}
    return launches, dict(G=G, n=n_o, layout=layout, C=C)


def ridge_checks(phase: str, C, N, layout, G, n_o):
    """Ridge (closed form and BGD) on ``C`` against ridge on the oracle's
    covar ``G``: training RMSE (evaluated on ``G``) and θ."""
    import numpy as np

    from repro_torch.ml import ridge

    def fit_rmse(theta):
        t = np.append(theta, -1.0)
        return math.sqrt(max(float(t @ G @ t) / n_o, 0.0))

    th_cf, th_cf_o = ridge.closed_form(C, N, layout), ridge.closed_form(G, n_o, layout)
    t0 = time.perf_counter()
    res, res_o = ridge.bgd(C, N, layout), ridge.bgd(G, n_o, layout)
    bgd_s = time.perf_counter() - t0
    r_o = fit_rmse(th_cf_o)
    theta_err = float(np.linalg.norm(th_cf - th_cf_o) / np.linalg.norm(th_cf_o))
    bgd_err = float(np.linalg.norm(res.theta - res_o.theta) / np.linalg.norm(res_o.theta))
    rmse_err = abs(fit_rmse(th_cf) / r_o - 1)
    bgd_rmse_err = abs(fit_rmse(res.theta) / fit_rmse(res_o.theta) - 1)
    label_std = float(np.sqrt(G[layout.label_idx, layout.label_idx] / n_o
                              - (G[0, layout.label_idx] / n_o) ** 2))
    emit(phase, rmse_oracle=r_o, label_std=label_std,
         closed_form_theta_rel=theta_err, closed_form_rmse_rel=rmse_err,
         bgd_theta_rel=bgd_err, bgd_rmse_rel=bgd_rmse_err,
         bgd_iterations=res.iterations, bgd_s=bgd_s,
         theta_tol=THETA_TOL, rmse_tol=RMSE_TOL)
    check(r_o < 0.8 * label_std, f"{phase}: ridge does not learn: rmse {r_o} vs std {label_std}")
    check(theta_err <= THETA_TOL, f"{phase}: closed-form θ vs oracle {theta_err:.3e} > {THETA_TOL}")
    check(bgd_err <= THETA_TOL, f"{phase}: BGD θ vs oracle {bgd_err:.3e} > {THETA_TOL}")
    check(rmse_err <= RMSE_TOL, f"{phase}: closed-form RMSE vs oracle {rmse_err:.3e} > {RMSE_TOL}")
    check(bgd_rmse_err <= RMSE_TOL, f"{phase}: BGD RMSE vs oracle {bgd_rmse_err:.3e} > {RMSE_TOL}")


# ---------------------------------------------------------------- trees

def oracle_level(join, features, label, masks):
    """float64 tree statistics of one level from the gathered join, on the
    card: ``(stats, scale)`` per feature, each (N, D, 3) — stats are
    [Σcond, Σcond·y, Σcond·y²] per bucket and frontier node with
    cond_j = Π_g mask_j,g[code_g], scale the same sums of |terms|."""
    import numpy as np
    import torch

    N = len(masks)
    M = {f.attr: torch.tensor(np.stack([m[f.attr] for m in masks]), dtype=torch.float64,
                              device="cuda") for f in features}
    acc = {f.attr: torch.zeros((f.domain, 4 * N), dtype=torch.float64, device="cuda")
           for f in features}
    for m, col in join.chunks():
        codes = {f.attr: col(f.attr).long() for f in features}
        cond = torch.ones((m, N), dtype=torch.float64, device="cuda")
        for f in features:
            cond *= M[f.attr][:, codes[f.attr]].T
        y = col(label).double()[:, None]
        pay = torch.stack([cond, cond * y, cond * y * y, cond * y.abs()], 2).reshape(m, 4 * N)
        for f in features:
            acc[f.attr].index_add_(0, codes[f.attr], pay)
    out = {}
    for f in features:
        a = acc[f.attr].view(f.domain, N, 4).permute(1, 0, 2).cpu().numpy()
        out[f.attr] = (a[..., :3], a[..., [0, 3, 2]])
    return out


def walk_sse(join, trees, features, label):
    """Σ (y − mean over trees of the tree's prediction)² over the gathered
    join, each tree walked on the card; and Σy, Σy², n for the label's
    spread."""
    import torch

    fidx = {f.attr: i for i, f in enumerate(features)}
    dev = dict(device="cuda")
    walkers = []
    for t in trees:
        nd = t.nodes
        walkers.append(dict(
            feat=torch.tensor([fidx[n.feature] if n.feature else 0 for n in nd], **dev),
            thr=torch.tensor([n.threshold for n in nd], **dev),
            ordered=torch.tensor([n.kind == "ordered" for n in nd], **dev),
            leaf=torch.tensor([n.is_leaf for n in nd], **dev),
            left=torch.tensor([n.left for n in nd], **dev),
            right=torch.tensor([n.right for n in nd], **dev),
            pred=torch.tensor([n.prediction for n in nd], dtype=torch.float64, **dev),
            depth=t.max_depth))
    sse = sy = syy = 0.0
    for m, col in join.chunks():
        codes = torch.stack([col(f.attr).long() for f in features], 1)
        y = col(label).double()
        p = torch.zeros(m, dtype=torch.float64, **dev)
        for w in walkers:
            idx = torch.zeros(m, dtype=torch.long, **dev)
            for _ in range(w["depth"]):
                c = codes.gather(1, w["feat"][idx][:, None])[:, 0]
                go_left = torch.where(w["ordered"][idx], c <= w["thr"][idx], c == w["thr"][idx])
                nxt = torch.where(go_left, w["left"][idx], w["right"][idx])
                idx = torch.where(w["leaf"][idx], idx, nxt)
            p += w["pred"][idx]
        p /= len(walkers)
        sse += float(((y - p) ** 2).sum())
        sy += float(y.sum())
        syy += float((y * y).sum())
    return sse, sy, syy


def rmse_and_std(join, trees, features, label):
    sse, sy, syy = walk_sse(join, trees, features, label)
    n = join.n
    return math.sqrt(sse / n), math.sqrt(max(syy / n - (sy / n) ** 2, 0.0))


def tree_phase(ds, db, join, n_fact: int):
    """A depth-4 regression tree (the reference's defaults), fused then
    unfused, level by level through the stepping API; each level's
    statistics against the float64 oracle."""
    import numpy as np
    import torch

    from repro_torch.api import connect
    from repro_torch.kernels import ops
    from repro_torch.ml.trees import DecisionTree, split_stats, stack_mask_params

    launches = {}
    for label, fuse, sites in (("fused", True, 9), ("unfused", False, 19)):
        sess = connect(ds.schema, data=db.data, edges=ds.edges,
                       config=db.config.replace(fuse_kernels=fuse))
        t0 = time.perf_counter()
        dt = DecisionTree(ds, database=sess)
        compile_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        levels = []
        t0 = time.perf_counter()
        dt.init_fit()
        while dt.growing:
            masks = dt.frontier_masks()
            stats = split_stats(dt.view.run_batched(stack_mask_params(dt.features, masks)),
                                dt.features)
            levels.append((masks, stats))
            dt.advance(stats)
        wall = time.perf_counter() - t0
        launches[label] = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        last = stack_mask_params(dt.features, levels[-1][0])
        prof = device_breakdown(lambda: dt.view.run_batched(last))
        stats_ = dt.batch.stats
        level_n = [len(m) for m, _ in levels]

        t0 = time.perf_counter()
        oracles = [oracle_level(join, dt.features, ds.label, m) for m, _ in levels]
        oracle_s = time.perf_counter() - t0
        worst_stat = 0.0
        for d, ((_, stats), orc) in enumerate(zip(levels, oracles)):
            for f in dt.features:
                o, sc = orc[f.attr]
                err = np.abs(stats[f.attr] - o)
                check(bool((err <= STAT_TOL * sc).all()),
                      f"trees.{label}: level {d} {f.attr} statistics off the oracle "
                      f"by {float((err / np.maximum(sc, 1e-300)).max()):.3e} of Σ|terms|")
                worst_stat = max(worst_stat, float((err / np.maximum(sc, 1e-300)).max()))
        worst_gain, n_splits = 0.0, 0
        for d, orc in enumerate(oracles):
            ids = [n.node_id for n in dt.nodes if n.depth == d]
            check(len(ids) == level_n[d], f"trees.{label}: level {d} has {level_n[d]} "
                  f"frontier nodes but the tree {len(ids)}")
            for i, nid in enumerate(ids):
                node = dt.nodes[nid]
                if node.is_leaf:
                    continue
                gains = {f.attr: dt.split_gains(orc[f.attr][0][i], f.kind) for f in dt.features}
                best = max(float(g.max()) for g in gains.values())
                chosen = float(gains[node.feature][node.threshold])
                rel = (best - chosen) / abs(best)
                check(math.isfinite(chosen) and rel <= GAIN_TOL,
                      f"trees.{label}: node {nid} splits on {node.feature}<={node.threshold} "
                      f"with oracle gain {chosen} against the best {best}")
                worst_gain = max(worst_gain, rel)
                n_splits += 1
        rmse, std = rmse_and_std(join, [dt], dt.features, ds.label)
        root_n = dt.nodes[0].n
        emit(f"trees.{label}", fit_s=wall, compile_s=compile_s, levels=level_n,
             dispatches=dt.batch.n_dispatches, launches=launches[label],
             static_launches=stats_.n_kernel_launches, scan_steps=stats_.n_scan_steps,
             summary=stats_.summary(), peak_mem_gb=peak, n_nodes=len(dt.nodes),
             n_splits=n_splits, root_n=root_n, rmse=rmse, label_std=std,
             max_stat_err_over_abs=worst_stat, worst_gain_rel=worst_gain,
             oracle_s=oracle_s, tol=dict(stat=STAT_TOL, gain=GAIN_TOL,
                                         root_n=ROOT_N_TOL, rmse_ratio=RMSE_RATIO),
             splits=[[n.feature, n.threshold] for n in dt.nodes if not n.is_leaf])
        emit(f"trees.{label}.profile", n_nodes=level_n[-1], **prof)
        check(stats_.n_kernel_launches == sites,
              f"trees.{label}: static launches {stats_.n_kernel_launches} != {sites}")
        check(dt.batch.n_dispatches == len(levels) + 1,
              f"trees.{label}: {dt.batch.n_dispatches} passes for {len(levels)} levels "
              "and the profiled one")
        check(abs(root_n - n_fact) <= ROOT_N_TOL * n_fact,
              f"trees.{label}: root count {root_n} is not {n_fact} fact rows")
        check(all(n.n > 0 for n in dt.nodes), f"trees.{label}: a node holds no rows")
        check(n_splits > 0, f"trees.{label}: the tree did not split")
        check(rmse <= RMSE_RATIO * std, f"trees.{label}: RMSE {rmse} vs label std {std}")
        got = launches[label]
        if fuse:
            check(got["fused_scan_block"] > 0 and got["seg_aggregate"] == 0
                  and got["tree_hist"] == 0 and got["tree_hist_batched"] == 0,
                  f"trees.fused launches {got}")
        else:
            check(got["tree_hist_batched"] > 0 and got["seg_aggregate"] > 0
                  and got["fused_scan_block"] == 0, f"trees.unfused launches {got}")
        del dt, sess, levels, oracles
    return launches


def forest_phase(ds, db, join, seed: int):
    """A 4-tree random forest of depth 3 (up to 32 frontier nodes a pass),
    fused."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.ml.forest import RandomForest

    t0 = time.perf_counter()
    rf = RandomForest(ds, n_trees=4, max_depth=3, seed=seed, database=db)
    compile_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    rf.fit()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    rmse, std = rmse_and_std(join, rf.trees, rf.features, ds.label)
    emit("forest", fit_s=wall, compile_s=compile_s, dispatches=rf.batch.n_dispatches,
         launches=launches, peak_mem_gb=peak, rmse=rmse, label_std=std,
         n_nodes=[len(t.nodes) for t in rf.trees],
         subsets=[sorted(map(str, t.allowed_attrs)) for t in rf.trees])
    check(launches["fused_scan_block"] > 0
          and sum(launches.values()) == launches["fused_scan_block"],
          f"forest launches {launches}")
    check(rmse <= RMSE_RATIO * std, f"forest: RMSE {rmse} vs label std {std}")


# ---------------------------------------------------------------- batch workloads

def fused_covar_phase(ds, db, orc):
    """``make_fused_covar`` over the session's relations: one ``covar_xtx``
    launch per block of fact rows; the covar against the main phase's
    float64 oracle, then ridge on it."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.ml.covar_fused import make_fused_covar

    n = db.sizes()[ds.fact]
    block = db.config.block_size
    t0 = time.perf_counter()
    fn, layout = make_fused_covar(ds, block_size=block, database=db)
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    prof = device_breakdown(fn, classify=kernel_group)
    C = out.cpu().numpy().astype(np.float64)
    N = float(n)
    err = scaled_err(C, orc["G"])
    err_engine = scaled_err(C, orc["C"])
    n_blocks = -(-n // block)
    emit("fused_covar", setup_s=setup_s, cold_wall_s=cold, warm_wall_s=warm,
         launches=launches, blocks=n_blocks, block_size=block, p=layout.p,
         peak_mem_gb=peak, vs_oracle=err, vs_engine=err_engine, tol=COVAR_TOL,
         N=N, C00=float(C[0, 0]))
    emit("fused_covar.profile", **prof)
    check(layout.p == orc["layout"].p, f"fused_covar: p = {layout.p}, engine {orc['layout'].p}")
    check(np.isfinite(C).all() and C.shape == (layout.p, layout.p),
          f"fused_covar: covar not finite or of shape {C.shape}")
    check(bool((C == C.T).all()), "fused_covar: covar not symmetric")
    check(N == orc["n"] == n, f"fused_covar: N={N} is not {n} fact rows")
    check(C[0, 0] == float(np.float32(n)), f"fused_covar: C[0, 0] = {C[0, 0]} is not {n}")
    check(err <= COVAR_TOL, f"fused_covar vs oracle {err:.3e} > {COVAR_TOL}")
    check(launches["covar_xtx"] == n_blocks
          and sum(launches.values()) == launches["covar_xtx"],
          f"fused_covar launches {launches}, expected {n_blocks} covar_xtx")
    ridge_checks("fused_covar.ridge", C, N, layout, orc["G"], orc["n"])
    return launches["covar_xtx"]


def max_spanning_weight(mi, edges_idx=None):
    """Total MI of Kruskal's maximum spanning tree over ``mi`` (or of the
    given edges)."""
    n = mi.shape[0]
    if edges_idx is None:
        parent = list(range(n))

        def find(x):
            while parent[x] != x:
                x = parent[x]
            return x

        edges_idx = []
        for _, i, j in sorted(((mi[i, j], i, j) for i in range(n)
                               for j in range(i + 1, n)), reverse=True):
            ri, rj = find(i), find(j)
            if ri != rj:
                parent[ri] = rj
                edges_idx.append((i, j))
    return float(sum(mi[i, j] for i, j in edges_idx))


def chowliu_phase(ds, db, join):
    """Chow-Liu over the eight categorical features, multi-root and single
    root: pairwise counts, MI and the learned tree against an int64 oracle
    of the gathered join."""
    import numpy as np
    import torch

    from repro_torch.api import connect
    from repro_torch.kernels import ops
    from repro_torch.ml.chowliu import chow_liu, mi_queries, mutual_information

    attrs = list(ds.features_cat)
    dom = {a: ds.schema.domain(a) for a in attrs}
    pairs = [(a, b) for i, a in enumerate(attrs) for b in attrs[i + 1:]]
    t0 = time.perf_counter()
    cnt = {p: torch.zeros(dom[p[0]] * dom[p[1]], dtype=torch.int64, device="cuda")
           for p in pairs}
    for _, col in join.chunks():
        codes = {a: col(a).long() for a in attrs}
        for a, b in pairs:
            cnt[(a, b)] += torch.bincount(codes[a] * dom[b] + codes[b],
                                          minlength=dom[a] * dom[b])
    joint_o = {p: c.view(dom[p[0]], dom[p[1]]).cpu().numpy() for p, c in cnt.items()}
    marg_o = {a: (joint_o[pairs[0]].sum(1) if a == attrs[0] else
                  joint_o[(attrs[0], a)].sum(0)) for a in attrs}
    total = float(join.n)
    n_a = len(attrs)
    mi_o = np.zeros((n_a, n_a))
    for i, a in enumerate(attrs):
        for j in range(i + 1, n_a):
            b = attrs[j]
            mi_o[i, j] = mi_o[j, i] = mutual_information(
                joint_o[(a, b)].astype(np.float64), marg_o[a], marg_o[b], total)
    best = max_spanning_weight(mi_o)
    oracle_s = time.perf_counter() - t0

    emit("chowliu.oracle", oracle_s=oracle_s, mi_max=float(mi_o.max()), tree_mi=best)
    del cnt

    launches = {}
    for label, multi in (("multi_root", True), ("single_root", False)):
        sess = db if multi else connect(ds.schema, data=db.data, edges=ds.edges,
                                        config=db.config.replace(multi_root=False))
        # the batch's counts against the oracle's
        view = sess.views(mi_queries(attrs))
        stats = view.stats
        out = {k: v.cpu().numpy().astype(np.float64) for k, v in view.run().items()}
        worst_count = abs(out["mi_total"][0] - total)
        for a, b in pairs:
            worst_count = max(worst_count, float(np.abs(
                out[f"mi_p_{a}_{b}"][..., 0] - joint_o[(a, b)]).max()))
        for a in attrs:
            worst_count = max(worst_count, float(np.abs(
                out[f"mi_m_{a}"][..., 0] - marg_o[a]).max()))
        check(worst_count <= ROOT_N_TOL * total,
              f"chowliu.{label}: a count is {worst_count} off the oracle (> {ROOT_N_TOL} N)")
        del out, view
        t0 = time.perf_counter()
        chow_liu(ds, database=sess)
        cold = time.perf_counter() - t0
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        res = chow_liu(ds, database=sess)
        warm = time.perf_counter() - t0
        launches[label] = dict(ops.LAUNCHES)
        mi_err = float(np.abs(res.mi - mi_o).max())
        idx = {a: i for i, a in enumerate(attrs)}
        got = max_spanning_weight(mi_o, [(idx[a], idx[b]) for a, b in res.edges])
        emit(f"chowliu.{label}", cold_wall_s=cold, warm_wall_s=warm,
             launches=launches[label], roots=sorted(set(stats.roots.values())),
             summary=stats.summary(), n_aggregates=res.n_aggregates,
             max_count_err=worst_count, count_tol=ROOT_N_TOL * total,
             max_mi_err=mi_err, tree_mi=got, tree_mi_rel_gap=(best - got) / best,
             edges=[list(e) for e in res.edges])
        check(mi_err <= 1e-5 * float(mi_o.max()),
              f"chowliu.{label}: MI {mi_err:.3e} off the oracle (> 1e-5 of the largest)")
        check(len(res.edges) == n_a - 1 and got >= (1 - 1e-5) * best,
              f"chowliu.{label}: tree MI {got} against the oracle's best {best}")
        check(launches[label]["fused_scan_block"] > 0
              and sum(launches[label].values()) == launches[label]["fused_scan_block"],
              f"chowliu.{label} launches {launches[label]}")
        check(multi or len(set(stats.roots.values())) == 1,
              f"chowliu.{label}: roots {stats.roots}")
    return launches


def cube_oracle(ds, join):
    """Every cell of the CUBE_DIMS × CUBE_MEASURES cube in float64 from the
    gathered join, on the card: per cell the measures' sums, then their
    Σ|terms|."""
    import itertools

    import numpy as np
    import torch

    from repro_torch.ml.cubes import cube_name

    dims, meas = CUBE_DIMS, CUBE_MEASURES
    dom = [ds.schema.domain(d) for d in dims]
    size = int(np.prod(dom))
    fin = torch.zeros((size, 2 * len(meas)), dtype=torch.float64, device="cuda")
    for _, col in join.chunks():
        flat = col(dims[0]).long()
        for d, k in zip(dims[1:], dom[1:]):
            flat = flat * k + col(d).long()
        vals = torch.stack([col(m).double() for m in meas], 1)
        fin.index_add_(0, flat, torch.cat([vals, vals.abs()], 1))
    fin = fin.view(*dom, 2 * len(meas)).cpu().numpy()
    oracle = {}
    for r in range(len(dims) + 1):
        for sub in itertools.combinations(dims, r):
            axes = tuple(i for i, d in enumerate(dims) if d not in sub)
            oracle[cube_name(sub)] = fin.sum(axis=axes) if axes else fin
    return oracle


def cube_error(phase: str, cells, oracle) -> float:
    """The cells' worst error over Σ|terms|, each held to STAT_TOL."""
    import numpy as np

    worst = 0.0
    check(set(cells) == set(oracle), f"{phase}: cells {sorted(cells)}")
    for k, o in oracle.items():
        err = np.abs(cells[k] - o[..., :len(CUBE_MEASURES)])
        scale = o[..., len(CUBE_MEASURES):]
        worst = max(worst, float((err / np.maximum(scale, 1e-300)).max()))
        check(bool((err <= STAT_TOL * scale).all()),
              f"{phase}: cell {k} off the oracle by more than {STAT_TOL} of Σ|terms|")
    return worst


def cubes_phase(ds, db, join):
    """A data cube over three categorical dimensions of three relations with
    two measures (the fact label and a Weather attribute), through the
    engine and through roll-up, against a float64 oracle."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.ml.cubes import cube_rollup, cube_via_engine

    oracle = cube_oracle(ds, join)
    out = {}
    for label, fn in (("engine", cube_via_engine), ("rollup", cube_rollup)):
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        cells = fn(ds, CUBE_DIMS, CUBE_MEASURES, database=db)
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        worst = cube_error(f"cubes.{label}", cells, oracle)
        emit(f"cubes.{label}", wall_s=wall, launches=launches, n_cells=len(cells),
             max_err_over_abs=worst, tol=STAT_TOL)
        check(launches["fused_scan_block"] > 0, f"cubes.{label} launches {launches}")
        out[label] = launches
    return out


def polyreg_phase(ds, db, join):
    """Degree-2 polynomial regression over the eight continuous features (45
    design columns, 540 aggregates in one query): C and b against a float64
    design-matrix oracle, and the fit's training RMSE on the oracle's
    statistics against the oracle θ's."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.ml.polyreg import compute_poly_covar, fit_polyreg, solve_polyreg

    # one pass under the profiler (its wall includes the profiler's own
    # cost), then the fit's wall: compile, one pass, the solve
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    run = {}
    prof = device_breakdown(lambda: run.update(out=compute_poly_covar(ds, database=db)))
    C, b, N, layout, batch = run["out"]
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    theta, _, _ = fit_polyreg(ds, database=db)
    fit_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    p = len(layout.features)
    G = torch.zeros((p + 1, p + 1), dtype=torch.float64, device="cuda")
    for m, col in join.chunks():
        cols = {a: col(a).double() for a in {a for f in layout.features for a, _ in f}}
        X = torch.empty((m, p + 1), dtype=torch.float64, device="cuda")
        for i, f in enumerate(layout.features):
            X[:, i] = 1.0
            for a, pw in f:
                X[:, i] *= cols[a] ** pw
        X[:, p] = col(layout.label).double()
        G += X.T @ X
    G = G.cpu().numpy()
    oracle_s = time.perf_counter() - t0
    n = float(join.n)
    Go, bo, syy = G[:p, :p], G[:p, p], G[p, p]
    err_C = scaled_err(C, Go)
    err_b = float((np.abs(b - bo) / np.sqrt(np.diag(Go) * syy)).max())
    theta_o = solve_polyreg(Go, bo, n)

    def fit_rmse(t):
        return math.sqrt(max(float(t @ Go @ t - 2 * t @ bo + syy) / n, 0.0))

    r, r_o = fit_rmse(theta), fit_rmse(theta_o)
    std = math.sqrt(max(syy / n - (bo[0] / n) ** 2, 0.0))   # feature 0 is the constant
    emit("polyreg", fit_s=fit_s,
         launches=launches, summary=batch.stats.summary(),
         n_dedup_hits=batch.result.stats.n_dedup_hits, n_features=p,
         peak_mem_gb=peak, C_vs_oracle=err_C, b_vs_oracle=err_b, tol=COVAR_TOL,
         rmse=r, rmse_oracle=r_o, rmse_rel=abs(r / r_o - 1), label_std=std,
         theta_rel=float(np.linalg.norm(theta - theta_o) / np.linalg.norm(theta_o)),
         oracle_s=oracle_s)
    emit("polyreg.profile", **prof)
    check(N == n, f"polyreg: N={N} is not {n} fact rows")
    check(err_C <= COVAR_TOL, f"polyreg: C vs oracle {err_C:.3e} > {COVAR_TOL}")
    check(err_b <= COVAR_TOL, f"polyreg: b vs oracle {err_b:.3e} > {COVAR_TOL}")
    check(abs(r / r_o - 1) <= POLY_RMSE_TOL,
          f"polyreg: RMSE {r} against the oracle θ's {r_o}")
    check(r_o < std, f"polyreg does not learn: RMSE {r_o} vs std {std}")
    check(launches["fused_scan_block"] > 0
          and sum(launches.values()) == launches["fused_scan_block"],
          f"polyreg launches {launches}")
    return launches


def moments_phase(ds, db, join, seed: int):
    """``feature_moments`` of the eight continuous features against float64
    sums over the gathered join, and ``expert_load_aggregate`` against
    ``bincount``."""
    import numpy as np
    import torch

    from repro_torch.data.statistics import expert_load_aggregate, feature_moments
    from repro_torch.kernels import ops

    attrs = list(ds.features_cont)
    acc = torch.zeros((len(attrs), 3), dtype=torch.float64, device="cuda")
    for _, col in join.chunks():
        x = torch.stack([col(a).double() for a in attrs], 1)
        acc += torch.stack([x.sum(0), x.abs().sum(0), (x * x).sum(0)], 1)
    acc = acc.cpu().numpy() / join.n
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    got = feature_moments(ds, database=db)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    worst_mean = worst_var = 0.0
    for i, a in enumerate(attrs):
        mean_o, abs_o, sq_o = acc[i]
        var_o = sq_o - mean_o * mean_o
        worst_mean = max(worst_mean, abs(got[a]["mean"] - mean_o) / abs_o)
        worst_var = max(worst_var, abs(got[a]["var"] - var_o) / sq_o)
        check(got[a]["count"] == join.n, f"moments: {a} count {got[a]['count']}")
    emit("moments", wall_s=wall, launches=launches, max_mean_err_over_abs=worst_mean,
         max_var_err_over_sq=worst_var, tol=STAT_TOL)
    # mean within STAT_TOL of E|x|; var = E[x²] − mean², within 3·STAT_TOL of E[x²]
    check(worst_mean <= STAT_TOL and worst_var <= 3 * STAT_TOL,
          f"moments off the oracle: mean {worst_mean:.3e}, var {worst_var:.3e}")
    check(launches["fused_scan_block"] > 0, f"moments launches {launches}")

    ids = np.random.default_rng(seed).integers(0, 64, 1_000_003)
    load = expert_load_aggregate(ids, 64, device="cuda")
    check(np.array_equal(load, np.bincount(ids, minlength=64)),
          "expert_load_aggregate differs from bincount")
    return launches


# ---------------------------------------------------------------- ivm

def ivm_group(name: str) -> str:
    """A tick's device kernel by its work: the delta scans' reduction
    (``seg_reduce``), the resident relation's compaction and append (the
    keep mask's running sum, the destinations, the row moves), or the rest:
    the delta tuples' assembly, the payloads' products and gathers, the
    state fold."""
    g = kernel_group(name)
    if g != "other":
        return g
    if any(k in name for k in ("Scan", "scan", "index_copy", "index_fill", "where")):
        return "compaction (cumsum, where, index_fill_, index_copy_)"
    return "other"


def fact_updates(ds, seed: int, n_ticks: int):
    """benchmarks/bench_ivm.py's ``_fact_update`` ``n_ticks`` times from
    ``default_rng(seed)``: IVM_FRAC of the fact rows inserted (drawn with
    replacement from the fact table) and as many distinct positions
    deleted."""
    import numpy as np

    from repro_torch.data.relations import DeltaBatchUpdate

    rng = np.random.default_rng(seed)
    fact = ds.tables[ds.fact]
    n = len(next(iter(fact.values())))
    k = max(int(n * IVM_FRAC), 1)
    out = []
    for _ in range(n_ticks):
        pick = rng.integers(0, n, k)
        out.append(DeltaBatchUpdate()
                   .insert(ds.fact, {a: np.asarray(c)[pick] for a, c in fact.items()})
                   .delete(ds.fact, rng.choice(n, k, replace=False)))
    return out


def ivm_phase(ds, db, seed: int, card_line: str):
    """``OnlineRidge`` (the covar batch, every query rooted at the fact
    table) maintained under IVM_TICKS 1% fact ticks; the steady ticks
    under ``set_sync_debug_mode("error")``; the state against the host's
    ``apply_delta`` sequence, a float64 oracle of the post-update join and
    a fresh batch pass; a pinned epoch across a tick; a snapshot's round
    trip; then ``StreamingCube`` over two of the ticks."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.data import relations as TR
    from repro_torch.data.relations import _resident_advance
    from repro_torch.kernels import ops
    from repro_torch.ml import ridge
    from repro_torch.ml.covar import assemble_covar, covar_queries
    from repro_torch.ml.cubes import StreamingCube
    from repro_torch.ml.online import OnlineRidge

    fact = ds.fact
    t0 = time.perf_counter()
    updates = fact_updates(ds, seed, IVM_TICKS + 1)
    updates_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_db = TR.from_numpy(ds.schema, ds.tables, "cpu")
    host_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    olr = OnlineRidge(ds, database=db)
    olr.fit()
    fit_s = time.perf_counter() - t0
    mb = olr.maintained
    fit_launches = ops.LAUNCHES["fused_scan_block"]
    sizes = db.sizes()
    B = db.config.block_size
    fit_blocks = sum(-(-sizes[st.rel] // min(B, sizes[st.rel]))
                     for st in mb.batch.schedule.steps)
    check(fit_launches == fit_blocks,
          f"ivm fit launched fused_scan_block {fit_launches} times, expected {fit_blocks}")
    dp = mb.delta_program(fact)
    check(len(dp.steps) == 1 and dp.steps[0].scans_delta and not dp.base_rels,
          f"ivm: the fact's delta program is not one delta scan: {dp.summary()}")

    walls, solves, launches, builds, host_apply = [], [], [], [], []
    profile = None
    for i, upd in enumerate(updates[:IVM_TICKS]):
        steady = i >= IVM_WARM
        before, built = ops.LAUNCHES["fused_scan_block"], mb.n_fold_traces
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if steady:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = olr.view.apply(upd)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        host = {k: v.cpu().numpy() for k, v in out.items()}
        walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        olr.refresh(host)
        solves.append(time.perf_counter() - t0)
        launches.append(ops.LAUNCHES["fused_scan_block"] - before)
        builds.append(mb.n_fold_traces - built)
        t0 = time.perf_counter()
        host_db = TR.apply_delta(host_db, upd)
        host_apply.append(time.perf_counter() - t0)
    steady_walls = walls[IVM_WARM:]
    median = float(np.median(steady_walls))
    check(sum(builds[IVM_WARM:]) == 0, f"ivm: steady ticks built tick runners: {builds}")
    n_ins = updates[0].updates[fact].n_inserts
    delta_rows = TR.next_pow2(n_ins) + TR.next_pow2(updates[0].updates[fact].n_deletes)
    tick_blocks = -(-delta_rows // B)
    check(all(n == tick_blocks for n in launches),
          f"ivm: fused_scan_block launches per tick {launches}, expected {tick_blocks}")

    # (a) the resident fact table against the host's apply_delta sequence
    rr = mb.epoch_state().relations[fact]
    want = host_db.relation(fact)
    check(rr.n_valid == want.n_rows, f"ivm: {rr.n_valid} resident rows, host {want.n_rows}")
    for a, c in rr.columns().items():
        check(torch.equal(c.cpu(), want.columns[a]),
              f"ivm: resident {fact}.{a} differs from the host apply_delta sequence")
    del host_db, want

    # (b) against a float64 oracle of the post-update join
    C, N = olr.C, olr.N
    G, n_o = oracle_covar(FactJoin(mb.db), olr.layout)
    err_oracle = scaled_err(C, G)
    th, th_o = ridge.closed_form(C, N, olr.layout), ridge.closed_form(G, n_o, olr.layout)
    theta_err = float(np.linalg.norm(th - th_o) / np.linalg.norm(th_o))
    check(n_o == sizes[fact] and N == float(np.float32(n_o)),
          f"ivm: N={N}, oracle {n_o}, fact rows {sizes[fact]}")
    check(err_oracle <= COVAR_TOL, f"ivm: covar vs oracle {err_oracle:.3e} > {COVAR_TOL}")
    check(theta_err <= THETA_TOL, f"ivm: θ vs oracle {theta_err:.3e} > {THETA_TOL}")

    # (c) against fresh passes over the post-update relations, warm (the
    # fit's scan built the maintained batch's kernel plans): the maintained
    # batch itself, every query rooted at the fact, and the session's
    # ordinary batch of the same queries (roots found by the planner); the
    # faster of the two walls is the full recompute
    post = mb.db
    qs, _ = covar_queries(ds)
    ordinary = db.views(qs).compiled
    ordinary(post)
    fresh_s, errs_fresh = {}, {}
    for label, batch in (("rooted", mb.batch), ("ordinary", ordinary)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh = batch(post)
        fresh_host = {k: v.cpu().numpy() for k, v in fresh.items()}
        fresh_s[label] = time.perf_counter() - t0
        C_f, N_f = assemble_covar(fresh_host, olr.layout)
        errs_fresh[label] = scaled_err(C, C_f)
        check(N_f == N, f"ivm: fresh {label} pass N={N_f}, maintained {N}")
        check(errs_fresh[label] <= COVAR_TOL,
              f"ivm: covar vs a fresh {label} pass {errs_fresh[label]:.3e} > {COVAR_TOL}")
    full_s = min(fresh_s.values())
    del post, ordinary, fresh, fresh_host

    # a profiled tick, and the compaction alone on its inputs
    extra = updates[IVM_TICKS]
    d = extra.updates[fact]
    rr = mb.epoch_state().relations[fact]
    del_dev = torch.from_numpy(np.sort(d.delete_idx)).cuda()
    ins_dev = {a: torch.from_numpy(np.asarray(c)).cuda() for a, c in d.inserts.items()}
    compaction_ms = cuda_ms(lambda: _resident_advance(
        rr.buffers, rr.n_valid, ins_dev, del_dev, d.n_inserts, d.n_deletes, rr.capacity),
        reps=5)
    del rr, del_dev, ins_dev

    # (d) a pinned epoch stays bitwise unchanged across a further tick
    with mb.pinned() as e:
        before = {k: v.clone() for k, v in mb.results(epoch=e).items()}
        profile = device_breakdown(lambda: olr.view.apply(extra), classify=ivm_group)
        check(mb.epoch == e + 1, f"ivm: epoch {mb.epoch} after a tick from {e}")
        check(all(torch.equal(v, before[k]) for k, v in mb.results(epoch=e).items()),
              "ivm: a pinned epoch's results changed across a tick")
    del before

    # (e) snapshot, then restore into a fresh maintained handle
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        olr.view.snapshot(tmp)
        snapshot_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        other = db.views(qs, maintain=True, roots={q.name: fact for q in qs})
        check(other.restore(tmp) == mb.step, "ivm: restored a different step")
        restore_s = time.perf_counter() - t0
    want_res = mb.results()
    got_res = other.results()
    check(want_res.keys() == got_res.keys()
          and all(torch.equal(got_res[k], v) for k, v in want_res.items()),
          "ivm: restored results differ from the snapshot's")
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches_total = dict(ops.LAUNCHES)
    del other, want_res, got_res, olr, mb

    emit("ivm", card=card_line, fact_rows=sizes[fact], inserts=n_ins,
         deletes=updates[0].updates[fact].n_deletes, delta_rows=delta_rows,
         fit_blocks=fit_blocks, tick_blocks=tick_blocks, fit_s=fit_s,
         tick_walls_s=walls, steady_median_s=median, solve_s=solves,
         full_recompute_s=full_s, full_rooted_s=fresh_s["rooted"],
         full_ordinary_s=fresh_s["ordinary"], tick_over_full=median / full_s,
         ratio_limit=IVM_TICK_RATIO, launches_per_tick=launches,
         fit_launches=fit_launches, runner_builds_per_tick=builds,
         compaction_ms=compaction_ms, snapshot_s=snapshot_s, restore_s=restore_s,
         covar_vs_oracle=err_oracle, covar_vs_fresh=errs_fresh, theta_vs_oracle=theta_err,
         N=N, tol=COVAR_TOL, theta_tol=THETA_TOL, peak_mem_gb=peak,
         launches=launches_total, updates_s=updates_s, host_tables_s=host_s,
         host_apply_delta_s=host_apply)
    emit("ivm.tick.profile", **profile)
    check(median < IVM_TICK_RATIO * full_s,
          f"ivm: median steady tick {median:.4f} s is not below {IVM_TICK_RATIO} "
          f"of the faster full recompute ({full_s:.4f} s; rooted "
          f"{fresh_s['rooted']:.4f}, ordinary {fresh_s['ordinary']:.4f})")

    # StreamingCube over two of the same ticks
    torch.cuda.empty_cache()
    ops.reset_launches()
    t0 = time.perf_counter()
    cube = StreamingCube(ds, CUBE_DIMS, CUBE_MEASURES, database=db)
    cube_fit_s = time.perf_counter() - t0
    cube_walls = []
    for upd in updates[:IVM_CUBE_TICKS]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cells = cube.update(upd)
        cube_walls.append(time.perf_counter() - t0)
    worst = cube_error("ivm.cube", cells, cube_oracle(ds, FactJoin(cube.maintained.db)))
    cube_launches = dict(ops.LAUNCHES)
    emit("ivm.cube", fit_s=cube_fit_s, tick_walls_s=cube_walls, n_cells=len(cells),
         launches=cube_launches, max_err_over_abs=worst, tol=STAT_TOL)
    check(cube_launches["fused_scan_block"] > 0, f"ivm.cube launches {cube_launches}")
    del cube
    torch.cuda.empty_cache()
    return launches_total


# ---------------------------------------------------------------- LM

#: flash_attention's cases: (label, B, H, H_kv, S, D, causal, window, dtype);
#: the first is the summary line's (internlm2-1.8b's prefill at B = 4)
ATTN_CASES = (
    ("internlm2-1.8b", 4, 16, 8, 4096, 128, True, 0, "bfloat16"),
    ("internlm2-1.8b.f32", 4, 16, 8, 4096, 128, True, 0, "float32"),
    ("llama3-8b", 2, 32, 8, 4096, 128, True, 0, "bfloat16"),
    ("minicpm-2b", 4, 36, 36, 2048, 64, True, 0, "bfloat16"),
    ("h2o-danube-3-4b", 1, 32, 8, 8192, 120, True, 4096, "bfloat16"),
    ("ragged.noncausal", 2, 8, 4, 1000, 16, False, 0, "float32"),
    ("ragged.bf16", 2, 8, 4, 1000, 128, True, 0, "bfloat16"),
    ("prefill_32k", 1, 16, 8, 32768, 128, True, 0, "bfloat16"),
)
#: query rows of the prefill_32k case held against the plain version (the
#: full plain version's float32 scores would take 68 GB)
SAMPLED_ROWS = 512
#: the LM configuration: internlm2-1.8b at full width and depth
LM_ARCH = "internlm2-1.8b"
#: prefill batches (float32 checks, bf16 timing), sequence length, serving
#: batch, prompt and generated tokens
LM_F32_BATCH, LM_BF16_BATCH, LM_SEQ = 2, 4, 4096
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 64, 64


def unmasked_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask allows in one (batch, head)."""
    import numpy as np

    i = np.arange(sq, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros_like(i)
    hi = np.minimum(i, sk - 1) if causal else np.full_like(i, sk - 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def plain_rows(q, k, v, rows, causal: bool, window: int = 0, drop=(0, 0)):
    """The plain version for the query rows ``rows`` only, over the keys
    those rows see, in float32.  Keys ``drop[0]:drop[1]`` are left out of
    every row: a planted fault."""
    import torch

    group = q.shape[1] // k.shape[1]
    t = int(rows.max()) + 1 if causal else k.shape[2]
    kr = k[:, :, :t].float().repeat_interleave(group, dim=1)
    vr = v[:, :, :t].float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, rows].float(), kr) / math.sqrt(q.shape[-1])
    cols = torch.arange(t, device=q.device)[None, :]
    hidden = (cols >= drop[0]) & (cols < drop[1])
    if causal:
        hidden = hidden | (cols > rows[:, None])
    if window > 0:
        hidden = hidden | (cols <= rows[:, None] - window)
    s = s.masked_fill(hidden, float("-inf"))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), vr)


def row_rel(got, want) -> float:
    """max over query rows of max |got − want| ÷ the rms of ``want``'s row
    (a row of zeros must come back zeros)."""
    rms = want.float().pow(2).mean(-1, keepdim=True).sqrt().clamp_min(1e-30)
    return float(((got.float() - want.float()).abs().amax(-1, keepdim=True) / rms).max())


def planted_fault_rel(q, k, v, got, causal: bool, window: int) -> float:
    """``row_rel`` of the kernel's last 64 query rows against the plain
    version with a planted fault: the window's edge one key too far, or
    else the first 64-key tile left out."""
    import torch

    s = q.shape[2]
    rows = torch.arange(s - 64, s, device=q.device)
    if window > 0:
        bad = plain_rows(q, k, v, rows, causal, window + 1)
    else:
        bad = plain_rows(q, k, v, rows, causal, drop=(0, 64))
    return row_rel(got[:, :, rows], bad)


def attention_kernel_cases(args, rates):
    """``flash_attention`` against its plain version at the dense models'
    attention shapes, on (B, H, S, D) views of (B, S, H, D) tensors as the
    model passes them: error, kernel, plain and SDPA times, bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    bw, f32_flops, bf16_flops = rates
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    cases = []
    for label, b, h, hkv, s, d, causal, window, dt in ATTN_CASES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn((b, s, n, d), generator=gen, device="cuda")
                   .to(dtype).transpose(1, 2) for n in (h, hkv, hkv))
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        reps = 3 if s > 8192 else 5
        if label == "prefill_32k":
            rows = torch.randperm(s, generator=gen, device="cuda")[:SAMPLED_ROWS - 1]
            rows = torch.cat([rows, torch.tensor([s - 1], device="cuda")]).sort().values
            want = plain_rows(q, k, v, rows, causal)
            got_cmp = got[:, :, rows].float()
            plain_ms = None
            plain_rows_ms = cuda_ms(lambda: plain_rows(q, k, v, rows, causal), reps)
        else:
            want = ref.attention_ref(q.float(), k.float(), v.float(), causal=causal,
                                     window=window)
            got_cmp = got.float()
            plain_ms = cuda_ms(lambda: ref.attention_ref(q, k, v, causal=causal,
                                                         window=window), reps)
            plain_rows_ms = None
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got_cmp).all()), f"flash_attention[{label}]: non-finite output")
        err = (got_cmp - want).abs()
        max_abs = float(err.max())
        tol = ATTN_TOL[dt]
        worst = float((err / (tol + tol * want.abs())).max())
        rel = row_rel(got_cmp, want)
        del want, got_cmp, err
        fault_rel = planted_fault_rel(q, k, v, got, causal, window)
        del got
        ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=causal, window=window), reps)
        if window > 0:
            rr = torch.arange(s, device="cuda")
            allowed = (rr[None, :] <= rr[:, None]) & (rr[None, :] > rr[:, None] - window)
            library = lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=allowed, enable_gqa=True)
        else:
            library = lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True)
        library_ms = cuda_ms(library, reps)
        nbytes = q.element_size() * b * s * d * (2 * h + 2 * hkv)
        pairs = b * h * unmasked_pairs(s, s, causal, window)
        peak = bf16_flops if dt == "bfloat16" else f32_flops
        case = dict(case=label, B=b, H=h, H_kv=hkv, S=s, D=d, causal=causal,
                    window=window, dtype=dt, max_abs_err=max_abs,
                    err_over_tol=worst, tol=tol, row_rel_err=rel,
                    row_rel_tol=ROW_REL_TOL[dt], planted_fault_row_rel=fault_rel,
                    planted_fault="window + 1" if window > 0 else "keys 0:64 left out",
                    ms=ms, plain_ms=plain_ms,
                    plain_sampled_rows_ms=plain_rows_ms,
                    sampled_rows=SAMPLED_ROWS if plain_rows_ms is not None else None,
                    library_ms=library_ms,
                    library_call="scaled_dot_product_attention"
                    + (" with an explicit band mask" if window > 0 else ""),
                    unmasked_pairs=pairs, achieved_tflops=4 * d * pairs / ms / 1e9,
                    **bound(nbytes, 4 * d * pairs, bw, peak))
        emit("kernel", name="flash_attention", **case)
        check(worst <= 1.0, f"flash_attention[{label}]: |kernel - plain| exceeds "
              f"{tol} + {tol}·|plain| (max abs {max_abs:.3e})")
        check(rel <= ROW_REL_TOL[dt], f"flash_attention[{label}]: |kernel - plain| "
              f"reaches {rel:.3e} of a row's rms (limit {ROW_REL_TOL[dt]})")
        check(fault_rel > ROW_REL_TOL[dt], f"flash_attention[{label}]: a planted fault "
              f"reads {fault_rel:.3e}, within the limit {ROW_REL_TOL[dt]}")
        cases.append(case)
        del q, k, v
        torch.cuda.empty_cache()
    return cases


def lm_params(cfg, seed: int):
    """Random weights of ``cfg`` on the card, from a seeded generator."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.models.layers import init_params

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = init_params(M.model_specs(cfg), gen, cfg.torch_dtype, "cuda")
    torch.cuda.synchronize()

    def numel(tree):
        return (sum(numel(v) for v in tree.values()) if isinstance(tree, dict)
                else tree.numel())

    check(numel(params) == cfg.param_count(),
          f"{cfg.name}: {numel(params)} parameters, expected {cfg.param_count()}")
    return params


def allclose_excess(got, want, tol: float) -> float:
    """max |got − want| / (tol + tol·|want|): ≤ 1 is allclose at rtol = atol
    = tol."""
    return float(((got - want).abs() / (tol + tol * want.abs())).max())


def lm_f32_phase(seed: int):
    """internlm2-1.8b in float32 at full width and depth: the flash prefill
    against the dense one, generate, and teacher-forced decode against the
    prefill."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models.layers import init_params
    from repro_torch.serve.engine import BatchedServer

    cfg = configs.get(LM_ARCH).with_(dtype="float32")
    t0 = time.perf_counter()
    params = lm_params(cfg, seed)
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (LM_F32_BATCH, LM_SEQ))).cuda()
    ops.reset_launches()
    flash, _ = M.forward(params, {"tokens": tokens}, cfg, impl="flash")
    torch.cuda.synchronize()
    fwd_launches = dict(ops.LAUNCHES)
    dense, _ = M.forward(params, {"tokens": tokens}, cfg, impl="dense")
    prefill_excess = allclose_excess(flash, dense, ATTN_TOL["float32"])
    prefill_err = float((flash - dense).abs().max())
    logits_max = float(dense.abs().max())
    check(bool(torch.isfinite(flash).all()) and tuple(flash.shape) == (LM_F32_BATCH, LM_SEQ, cfg.vocab),
          f"lm.f32: prefill logits not finite or of shape {tuple(flash.shape)}")
    del flash, dense

    server = BatchedServer(cfg, params, max_len=SERVE_PROMPT + SERVE_GEN,
                           batch=SERVE_BATCH, device="cuda")
    prompts = rng.integers(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
    ops.reset_launches()
    t0 = time.perf_counter()
    out = server.generate(prompts, SERVE_GEN)
    gen_s = time.perf_counter() - t0
    gen_launches = dict(ops.LAUNCHES)
    seq = torch.from_numpy(out.astype(np.int64)).cuda()
    full, _ = M.forward(params, {"tokens": seq}, cfg, impl="flash")
    cache = init_params(M.cache_specs(cfg, SERVE_BATCH, seq.shape[1]), None,
                        cfg.torch_dtype, "cuda")
    ops.reset_launches()
    decode_excess = decode_err = 0.0
    for pos in range(seq.shape[1]):
        lg, cache = M.decode_step(params, cache, seq[:, pos:pos + 1], pos, cfg)
        decode_excess = max(decode_excess, allclose_excess(lg[:, 0], full[:, pos], DECODE_TOL))
        decode_err = max(decode_err, float((lg[:, 0] - full[:, pos]).abs().max()))
    decode_launches = dict(ops.LAUNCHES)
    agree = float((full[:, SERVE_PROMPT - 1:-1].argmax(-1) == seq[:, SERVE_PROMPT:]).float().mean())
    emit("lm.f32", arch=LM_ARCH, layers=cfg.n_layers, d_model=cfg.d_model,
         vocab=cfg.vocab, params=cfg.param_count(), init_s=init_s,
         prefill_batch=LM_F32_BATCH, seq=LM_SEQ,
         flash_vs_dense_max_abs=prefill_err, flash_vs_dense_over_tol=prefill_excess,
         logits_max_abs=logits_max, tol=ATTN_TOL["float32"],
         forward_launches=fwd_launches, generate_s=gen_s,
         generate_launches=gen_launches, decode_launches=decode_launches,
         decode_vs_prefill_max_abs=decode_err, decode_vs_prefill_over_tol=decode_excess,
         decode_tol=DECODE_TOL, greedy_agreement=agree,
         serve=dict(batch=SERVE_BATCH, prompt=SERVE_PROMPT, gen=SERVE_GEN))
    check(fwd_launches["flash_attention"] == cfg.n_layers
          and sum(fwd_launches.values()) == cfg.n_layers,
          f"lm.f32: a forward launched {fwd_launches}, expected {cfg.n_layers} flash_attention")
    check(sum(gen_launches.values()) == 0 and sum(decode_launches.values()) == 0,
          f"lm.f32: decode launched kernels: {gen_launches}, {decode_launches}")
    check(prefill_excess <= 1.0, f"lm.f32: flash prefill vs dense {prefill_err:.3e} "
          f"beyond {ATTN_TOL['float32']} (allclose)")
    check(decode_excess <= 1.0, f"lm.f32: decode vs prefill {decode_err:.3e} beyond "
          f"{DECODE_TOL} (allclose)")
    check(out.shape == (SERVE_BATCH, SERVE_PROMPT + SERVE_GEN)
          and (out[:, :SERVE_PROMPT] == prompts).all()
          and ((out >= 0) & (out < cfg.vocab)).all(), "lm.f32: generate's tokens")


def lm_kernel_group(name: str) -> str:
    """A device kernel's group in the prefill breakdown."""
    if "flash_kernel" in name:
        return "flash_attention"
    if any(t in name for t in ("gemm", "nvjet", "cutlass", "xmma", "sm90_")):
        return "matrix products"
    if "reduce_kernel" in name:
        return "reductions (rms_norm, softmax)"
    if "CatArray" in name:
        return "cat (rope)"
    if "elementwise" in name:
        return "elementwise (norm, rope, SiLU, residual, casts)"
    if "index" in name.lower():
        return "embedding gather"
    return "other"


def tapped_kernel_rel(prefill):
    """Run ``prefill()`` with every ``flash_attention`` call's output held
    against the plain version on that layer's own q, k, v (strided views,
    the model's activations): per-layer ``row_rel``, and per layer the
    reading of the planted tile-drop fault."""
    from repro_torch.kernels import ops, ref

    launch = ops.flash_attention
    rels, faults = [], []

    def tap(q, k, v, *, causal=True, window=0):
        o = launch(q, k, v, causal=causal, window=window)
        rels.append(row_rel(o, ref.attention_ref(q.float(), k.float(), v.float(),
                                                 causal=causal, window=window)))
        faults.append(planted_fault_rel(q, k, v, o, causal, window))
        return o

    ops.flash_attention = tap
    try:
        logits = prefill()
    finally:
        ops.flash_attention = launch
    return logits, rels, faults


def as_float(tree):
    """A parameter tree cast to float32."""
    if isinstance(tree, dict):
        return {k: as_float(v) for k, v in tree.items()}
    return tree.float()


def bf16_prefill_checks(cfg, params, seed: int):
    """The bf16 flash prefill against the float32 dense prefill on the same
    bf16 weights, for BF16_CHECK_SEEDS seeds of weights and tokens, and for
    two planted faults on the first seed's: every layer's window cut to
    S − 64 (the last query tile loses up to one key tile) and to S / 2."""
    import numpy as np
    import torch

    from repro_torch.models import model as M

    f32 = cfg.with_(dtype="float32")

    def rel(got, want):
        return float((got.float() - want).abs().max()) / float(want.abs().max())

    readings, faults, tap = [], {}, {}
    for i in range(BF16_CHECK_SEEDS):
        p = params if i == 0 else lm_params(cfg, seed + i)
        rng = np.random.default_rng(seed + 100 + i)
        batch = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab, (LM_BF16_BATCH, LM_SEQ))).cuda()}
        want = M.forward(as_float(p), batch, f32, impl="dense")[0]
        if i == 0:
            got, tap["row_rel"], tap["planted_fault_row_rel"] = tapped_kernel_rel(
                lambda: M.forward(p, batch, cfg, impl="flash")[0])
            check(bool(torch.isfinite(got).all()), "lm.bf16: prefill logits not finite")
            for label, w in (("window S-64", LM_SEQ - 64), ("window S/2", LM_SEQ // 2)):
                faults[label] = rel(M.forward(p, batch, cfg.with_(window=w),
                                              impl="flash")[0], want)
        else:
            got = M.forward(p, batch, cfg, impl="flash")[0]
        readings.append(rel(got, want))
        del got, want, p
        torch.cuda.empty_cache()
    return dict(flash_bf16_vs_dense_f32_rel=readings, planted_faults_rel=faults,
                tol=BF16_PREFILL_TOL, per_layer_kernel=dict(
                    tap, row_rel_tol=ROW_REL_TOL["bfloat16"]))


def lm_bf16_phase(seed: int):
    """internlm2-1.8b in bf16: prefill and serving walls, the dense prefill
    beside the flash one, peak memory, device breakdowns and
    ``bf16_prefill_checks``; returns the launches of the main path (one
    prefill, then generate)."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serve.engine import BatchedServer

    cfg = configs.get(LM_ARCH)
    params = lm_params(cfg, seed)
    rng = np.random.default_rng(seed + 1)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (LM_BF16_BATCH, LM_SEQ))).cuda()}
    prompts = rng.integers(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
    server = BatchedServer(cfg, params, max_len=SERVE_PROMPT + SERVE_GEN,
                           batch=SERVE_BATCH, device="cuda")

    def prefill(impl):
        return M.forward(params, batch, cfg, impl=impl)[0]

    # the main path: one prefill, then serving, counters zeroed before
    torch.cuda.synchronize()
    ops.reset_launches()
    prefill("flash")
    out = server.generate(prompts, SERVE_GEN)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)

    walls = {}
    peak = {}
    for impl in ("flash", "dense"):
        prefill(impl)                                   # warm
        ws = []
        for _ in range(3):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            lg = prefill(impl)
            torch.cuda.synchronize()
            ws.append(time.perf_counter() - t0)
            del lg
        walls[impl] = ws
        peak[impl] = torch.cuda.max_memory_allocated() / 2**30
    prof = device_breakdown(lambda: prefill("flash"), top=10, classify=lm_kernel_group)

    gen_walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out2 = server.generate(prompts, SERVE_GEN)
        gen_walls.append(time.perf_counter() - t0)
    steps = SERVE_PROMPT + SERVE_GEN - 1
    gen_prof = device_breakdown(lambda: server.generate(prompts[:, :8], 8), top=6,
                                classify=lm_kernel_group)
    del server
    checks = bf16_prefill_checks(cfg, params, seed)
    tokens = LM_BF16_BATCH * LM_SEQ
    med = sorted(walls["flash"])[1]
    gmed = min(gen_walls)
    emit("lm.bf16", arch=LM_ARCH, params=cfg.param_count(), prefill_batch=LM_BF16_BATCH,
         seq=LM_SEQ, prefill_walls_s=walls["flash"], prefill_tokens_per_s=tokens / med,
         dense_prefill_walls_s=walls["dense"],
         dense_prefill_tokens_per_s=tokens / sorted(walls["dense"])[1],
         peak_mem_gb=peak, launches=launches,
         generate_walls_s=gen_walls, decode_steps=steps,
         ms_per_decode_step=gmed / steps * 1e3,
         generated_tokens_per_s=SERVE_BATCH * SERVE_GEN / gmed,
         same_tokens_as_first_generate=bool((out2 == out).all()),
         serve=dict(batch=SERVE_BATCH, prompt=SERVE_PROMPT, gen=SERVE_GEN))
    emit("lm.bf16.prefill.profile", **prof)
    emit("lm.bf16.decode.profile", steps=15, **gen_prof)
    emit("lm.bf16.checks", **checks)
    worst = max(checks["flash_bf16_vs_dense_f32_rel"])
    check(worst <= BF16_PREFILL_TOL, f"lm.bf16: flash prefill vs the float32 dense one "
          f"{worst:.3e} of max|logits| > {BF16_PREFILL_TOL}")
    check(checks["planted_faults_rel"]["window S/2"] > BF16_PREFILL_TOL,
          "lm.bf16: the prefill check does not see a window of S/2")
    layer = checks["per_layer_kernel"]
    check(max(layer["row_rel"]) <= ROW_REL_TOL["bfloat16"]
          and min(layer["planted_fault_row_rel"]) > ROW_REL_TOL["bfloat16"],
          f"lm.bf16: per-layer kernel readings {layer}")
    check(launches["flash_attention"] == cfg.n_layers and sum(launches.values()) == cfg.n_layers,
          f"lm.bf16: the prefill and generate launched {launches}, expected "
          f"{cfg.n_layers} flash_attention")
    del params
    return launches


def plan_specs_for(scale: float, block_size: int):
    """The fused specs of the covar plan's fact step and of its Items step
    with the histogram view, and of the tree plan's fact step for
    TREE_NODES frontier nodes, compiled at this run's relation sizes; and
    the one reduction of the fact's delta step of ``OnlineRidge``'s batch
    (every covar query rooted at the fact) as the lowering passes it:
    ``(segments, parts, width)``, a part ``(columns, first output column,
    output column stride)`` per aggregate column with products, of its
    view's pulled width, at a stride of the view's aggregates."""
    import math

    from repro_torch.core.engine import Engine
    from repro_torch.core.ivm import build_delta_program
    from repro_torch.core.lowering.cuda import flat_width, fused_layout, step_split
    from repro_torch.data import datasets as TD
    from repro_torch.ml.covar import covar_queries
    from repro_torch.ml.trees import build_tree_features, tree_queries

    dims = TD.make("retailer", scale=min(scale, 4.0))   # dimension tables
    sizes = {r: len(next(iter(c.values()))) for r, c in dims.tables.items()}
    sizes[dims.fact] = int(60_000 * scale)
    eng = Engine(dims.schema, edges=dims.edges, sizes=sizes)
    qs, _ = covar_queries(dims)
    batch = eng._compile(qs, block_size=block_size)
    out = {}
    for step, prog in zip(batch.schedule.steps, batch.plan.step_programs):
        specs, _ = fused_layout(prog)
        if step.rel == dims.fact:
            out["fact"] = specs
        elif any(sp.kind == "hist" for sp in specs):
            out["items"] = specs
    tqs = tree_queries(build_tree_features(dims, None, None), "regression",
                       dims.label, 0)
    tree = eng._compile(tqs, block_size=block_size)
    for step, prog in zip(tree.schedule.steps, tree.plan.step_programs):
        if step.rel == dims.fact:
            out["tree_fact"], _ = fused_layout(prog, TREE_NODES)
    maintained = eng._compile(qs, block_size=block_size,
                              root_override={q.name: dims.fact for q in qs})
    (delta,) = build_delta_program(dims.schema, maintained.plan.views, dims.fact).steps
    hist_views, buckets = step_split(delta.prog)
    check(not hist_views and len(buckets) == 1 and not buckets[0][0],
          "ivm: the fact's delta step is not one 1-segment reduction")
    parts, o = [], 0
    for vp in buckets[0][1]:
        parts += [(math.prod(vp.pulled_dims), o + a, vp.n_aggs)
                  for a, cp in enumerate(vp.cols) if cp.products]
        o += flat_width(vp)
    out["ivm_fact"] = (1, tuple(parts), o)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1400.0,
                    help="Retailer scale: 60,000 fact rows per unit (1400 = 84M)")
    ap.add_argument("--block-size", type=int, default=1 << 20,
                    help="rows per kernel launch on the main path")
    ap.add_argument("--seed", type=int, default=1,
                    help="seed of the Retailer tables and the kernel inputs "
                         "(1: the generator's own default)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: {src}/repro_torch not found; run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    t_start = time.perf_counter()

    # 1. card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    rates = card_rates(name)
    emit("card", name=name, nvidia_smi=card_line, count=torch.cuda.device_count(),
         hbm_bytes_per_s=rates[0], fp32_flops=rates[1], bf16_flops=rates[2],
         torch=torch.__version__, cuda=torch.version.cuda)

    try:
        # 2. build
        from repro_torch.kernels import _build

        t0 = time.perf_counter()
        path = _build.build()
        _build.library()
        emit("build", seconds=time.perf_counter() - t0, library=os.path.relpath(path, HERE),
             sources=[os.path.relpath(p, HERE) for p in _build.sources()],
             ptxas=[ln.strip() for ln in _build.build_log.splitlines()
                    if "Used" in ln or "spill" in ln])

        # 3. kernels
        specs = plan_specs_for(args.scale, args.block_size)
        kern = kernel_phase(args, specs, rates)
        kern["flash_attention"] = attention_kernel_cases(args, rates)

        # 4. main path: covar -> ridge
        ds, db = load_data(args)
        join = FactJoin(db.data)
        launches, orc = main_phase(ds, db, join)

        # 5. the gathered-XᵀX covar path, against the main phase's oracle
        launches["covar_xtx"] = fused_covar_phase(ds, db, orc)
        del orc

        # 6.-7. the tree path: a decision tree fused and unfused, a forest
        tree_launches = tree_phase(ds, db, join, db.sizes()[ds.fact])
        launches["tree_hist_batched"] = tree_launches["unfused"]["tree_hist_batched"]
        forest_phase(ds, db, join, args.seed)

        # 8.-11. the batch workloads on the engine
        chowliu_phase(ds, db, join)
        cubes_phase(ds, db, join)
        polyreg_phase(ds, db, join)
        moments_phase(ds, db, join, args.seed)

        # 12. incremental view maintenance, while Retailer is on the card
        ivm_phase(ds, db, args.seed, card_line)

        # 13.-14. the LM prefill and serving path, after freeing Retailer
        del ds, db, join
        torch.cuda.empty_cache()
        lm_f32_phase(args.seed)
        torch.cuda.empty_cache()
        launches["flash_attention"] = lm_bf16_phase(args.seed)["flash_attention"]
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    sources = {"fused_scan_block": ("fused_scan.cu", "src/repro/kernels/fused_scan.py:168"),
               "seg_aggregate": ("seg_aggregate.cu", "src/repro/kernels/seg_aggregate.py:39"),
               "tree_hist": ("tree_hist.cu", "src/repro/kernels/tree_hist.py:51"),
               "tree_hist_batched": ("tree_hist_batched.cu",
                                     "src/repro/kernels/tree_hist.py:99"),
               "covar_xtx": ("covar_xtx.cu", "src/repro/kernels/covar_xtx.py:41"),
               "flash_attention": ("flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:68")}
    summary = []
    for kname, cases in kern.items():
        main_case = cases[0]
        src_file, replaces = sources[kname]
        summary.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src_file}",
            "replaces": replaces,
            "launches": launches[kname],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
            "case": main_case["case"],
            "cases": [{k: c[k] for k in ("case", "ms", "bound_ms", "plain_ms", "library_ms")}
                      for c in cases]})
    print(json.dumps({"kernels": summary}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
