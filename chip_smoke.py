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
               fact case leads the summary), the parts form also on
               segment ranges' sorted path at the covar fact bucket's
               real shape and at a tree level's widest histograms.
  4. main    — ``make_retailer(scale)`` (84M fact rows at 1400),
               ``connect(..., device="cuda")`` and ``compute_covar`` fused,
               then unfused; launch counters of each run; the covar held
               against a float64 oracle computed on the card from the
               gathered join; ridge (closed form and BGD) against ridge on
               the oracle's covar.
  4b. config — the choices at ``connect`` over the same tables, against
               the main oracle: ``backend="torch"`` (the covar batch's cold
               and warm walls beside ``main.fused``'s and its device
               breakdown, no launch; the depth-4 tree fit held as the
               ``trees`` phase holds it); ``block_size="auto"`` on a fresh
               cache under ``build/`` (the block chosen per step, the
               tuning seconds, ``fused_scan_block`` launches equal to the
               blocks those choices give, a second session that times
               nothing, a maintained copy rooted at the fact whose delta
               lane tunes at its first 1% tick and whose three steady ticks
               run under ``set_sync_debug_mode("error")`` with no runner
               built, against a fresh pass); ``explain().summary()`` of a
               batch, a maintained and a served handle.
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
 13. serve   — ad-hoc query serving over the same resident tables: a second
               session (route cache of 2) with ``wide`` (date × locn × sku:
               COUNT, Σinventoryunits, Σmaxtemp) maintained and served and
               ``by_cat`` a batch view; routed requests in every tier
               (exact and subsumed from the maintained epoch, exact on the
               batch view's scan, compiled misses churning the cache, an
               untagged UDAF's fallback scan) against float64 oracles of the
               gathered join, with ``fused_scan_block`` launches per request
               (none on the hit tiers) and the widest launch of the first
               miss held against its plain version; caller latencies with the
               writer idle and running; 1% fact ticks through
               ``ViewServer.apply`` while the hit tiers route, all under
               ``set_sync_debug_mode("error")``, the routed answers against a
               float64 re-aggregation of their own epoch's view; a snapshot
               held across publishes (bitwise), a checkpoint taken while the
               writer runs and restored bitwise; a traced round whose chrome
               export (``build/serve_trace.json``) holds the engine's spans.
 13b. shard  — the engine's domain parallelism (``core/distributed.py``)
               over the same tables, through the port's mesh
               (``launch/mesh.py``): ``shard.w1``, world size 1 over NCCL in
               this process — the fused covar batch against ``main.fused``'s
               (88 launches, N, the float64 oracle; its run-to-run rounding
               reported beside a bitwise comparison), one frontier-batched
               tree level of 16 random masks against the unsharded level
               and its float64 oracle, a sharded maintained covar with three
               1% fact ticks, the steady ones under sync-debug "error" with
               no runner built, each against an unsharded copy and the
               float64 oracle of the post-tick join to 1e-4 of Σ|terms|;
               ``shard.w2``, two ranks as processes on this card over gloo
               (the arrays written once under ``build/`` and mapped by each
               rank): the covar (rank 0 against the float64 oracle, N
               exact, both ranks bitwise alike), three ticks against
               ``shard.w1``'s, each rank's launches, walls and peak memory
               (two ranks share one card, this process having freed its
               Retailer first: no scaling figure).
 14. examples — the five engine examples of the port
               (``examples/torch_*.py``) in-process on the card at
               ``EXAMPLES_SCALE`` 10 (600,000 Favorita and Retailer fact
               rows), each one's returned numbers held by its own oracle
               (BGD's RMSE against the closed form's, the trees against the
               mean and the majority class, cube against roll-up, tick
               steps, a pinned epoch frozen, maintained against fresh), its
               wall and launches; no JAX and no ``repro`` module loaded.
 15. lm.f32  — internlm2-1.8b at full width and depth in float32, random
               weights from ``--seed`` on the card: the prefill
               ``forward(impl="flash")`` against ``forward(impl="dense")``
               (B = 2, S = 4096), ``BatchedServer.generate`` (batch 8,
               64-token prompts, 64 new tokens), then teacher-forced
               ``decode_step`` logits at all 128 positions against the flash
               forward over the same sequence; 24 kernel launches a forward,
               none in decode.
 16. lm.bf16 — the same model in its own dtype, bf16: warm prefill walls and
               tokens/s at B = 4, S = 4096 against the dense prefill, warm
               ``generate`` walls (ms per decode step), peak memory, and a
               device breakdown of one prefill and of a short decode; then
               the flash prefill against the float32 dense prefill on the
               same bf16 weights for three seeds, each layer's kernel output
               against the plain version on that layer's q, k, v, and the
               readings of planted faults.
 17.-19. lm.moe, lm.ssm, lm.hybrid — qwen3-moe-235b-a22b, mamba2-2.7b and
               zamba2-1.2b at full width from ``configs/``, random weights
               from ``--seed``; depth cut where the weights do not fit
               (qwen3-moe: 4 layers in float32, 8 in bf16) and for time
               (mamba2's float32 checks: 32 of 64 layers); listed under
               ``reduced``.  Float32: the flash prefill against the dense
               one (``ATTN_TOL``), teacher-forced ``decode_step`` over 256
               tokens against the prefill (``DECODE_TOL``; for Mamba2 the
               recurrence against the chunked SSD across two chunks; for
               MoE with the capacity at E/k so nothing is dropped), MoE
               logits held only where every (layer, token) top-k set up to
               that token agreed (the share that agreed is reported).  bf16:
               the main path (a prefill at B 4 × 4,096, then ``generate``)
               with ``flash_attention`` launches equal to the attention
               layers (n_layers, 0, one a hybrid group) and none in decode;
               prefill walls and tokens/s, peak memory, a device breakdown,
               ms a decode step.

 23. lm.train — training, where no kernel runs (none has a backward):
               (a) internlm2-1.8b whole in bf16 from ``--seed``, six steps of
               B 8 × 4,096 (``train_4k``'s length; its batch of 256 cut to
               8, two microbatches of 4, chunked attention and CE, remat)
               through ``TrainLoop``, the steps after the first under
               ``set_sync_debug_mode("error")`` (lifted only for the loss
               read): step walls, losses, grad norms, lr, tokens/s, the
               state's bytes, peak memory, no kernel launch, and one warm
               step's device time by group (``train_kernel_group``);
               (b) on the same weights at B 1 × 512, TF32 off: float32
               gradients against float64 per leaf, ⟨∇L, d⟩ in float64
               against the central difference, bf16 against float32, and a
               planted detach of one layer's attention output that must read
               beyond both limits; (c) two bf16 steps of each other family at
               full width (depth cut where the state passes 40 GB) and the
               float64 directional derivative on its smoke config; (d)
               ``examples/torch_train_lm.py`` at its default size, again
               crashed after 100 steps and resumed (bitwise against the
               straight run under deterministic algorithms), the reference
               test's compressed smoke run, ``examples/torch_serve_lm.py``.
 24. lm.shard — the LM on a ("data", "model") mesh of (1, 1) over NCCL at
               world size 1 (``distributed/sharding.py``: DTensor placements,
               every constraint and collective of the sharded steps),
               internlm2-1.8b whole in bf16, against the unsharded port in
               the same run: the sharded prefill at B 4 × 4,096 with
               ``"flash"`` (24 ``flash_attention`` launches on each rank's
               local heads; last-position logits, tokens/s), sharded decode
               (batch 8, 64 new tokens; ms a step), sharded training at
               lm.train's B 8 × 4,096 (the first step's loss and grad norm
               from the unsharded step's state, three warm steps under
               sync-debug "error", tokens/s and peak memory beside
               lm.train's), and in float32 at 4 layers of full width the
               params after one step and 16 decode steps' logits.
 25. dryrun  — the multi-pod dry run (``launch/dryrun.py``) on fake CUDA
               tensors over a fake process group, in processes of its own:
               ``--arch whisper-small --shape decode_32k --mesh both`` (256
               and 512 ranks, two ``traced`` records), and lm.train's cell
               (internlm2-1.8b whole, B 8 × 4,096, two microbatches) traced
               at world size 1, its argument bytes equal to the state and
               batch bytes lm.train measured, its traced peak beside
               lm.train's measured peak; no kernel launched.

The ``kernels`` phase also holds ``flash_attention`` against its plain
version at the attention shapes of internlm2-1.8b's prefill (the summary's
case), llama3-8b, minicpm-2b, h2o-danube-3-4b (window 4,096), a ragged
non-causal float32 case, a ragged causal bf16 one, ``prefill_32k``,
qwen3-moe-235b-a22b's prefill (GQA 16:1) and zamba2-1.2b's (D 64), MLA's
(D_q 192, D_v 128), the VLM's cross-attention and whisper's encoder, and in
float32 at internlm2's, MLA's, zamba2's and the VLM's cross-attention
shapes and a small ``<192, 192>`` case, the plain version on sampled rows
where its float32 scores would pass 16 GB (``prefill_32k``, qwen3-moe),
with ``scaled_dot_product_attention`` as the library time (at GQA shapes
the faster of ``enable_gqa=True`` and K and V expanded beforehand, each
call's backend recorded), on (B, H, S, D) views of (B, S, H, D) tensors
as the model passes them; float32's bound is three TF32 products a term
on the tensor cores (the CUDA cores' bound beside it).  Besides allclose
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
import contextlib
import gc
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
#: covar plan has them; the tree fact bucket's 48 columns at TREE_NODES.
#: Segment ranges on the sorted path (seg_aggregate.SORTED_MIN_RANGES or
#: more): the (dateid, locn) reduction of the covar fact (Inventory) step
#: at the scale-1400 plan's real shape, 1,158,960 segments × 489
#: one-column parts in 13,170 ranges; and a tree level's (date, store_nbr)
#: histograms over Favorita's 90,936 buckets, at 64 nodes (392 ranges,
#: sorted) beside 16 (98 ranges, scan path) in the same launch
PARTS_STEPS = {
    "fact_parts": [("seg", 4960, (1,) * 45 + (5, 6, 10, 25, 8)), ("seg", 40, (1,) * 4),
                   ("seg", 480, (1,) * 9 + (5, 6))],
    "tree_fact_parts": [("seg", 4960, (1,) * 48), ("hist", 40, (TREE_NODES,)),
                        ("hist", 480, (TREE_NODES,))],
    "covar_fact_sorted": [("seg", 1_158_960, (1,) * 489)],
    "tree_hist_sorted": [("hist", 90_936, (64,)), ("hist", 90_936, (16,))],
}
#: rows of a PARTS_STEPS case where not KERNEL_ROWS: the main path's row
#: block, 2^20
PARTS_ROWS = {"covar_fact_sorted": 1 << 20}
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
#: serve: rounds of the four maintained requests behind the idle
#: percentiles, the writer's ticks in each concurrent window, and the most
#: routes a window's reader makes (each q_exact answer is a copy of the
#: 28.6 MB view, kept until the window's checks)
SERVE_ROUNDS = 50
SERVE_TICKS = 4
SERVE_MAX_ROUTES = 200
#: serve: the spans its traced round must hold: tests/test_obs.py's set,
#: the verifier's and the checkpoint's
SERVE_SPANS = frozenset({
    "compile", "compile.roots", "compile.pushdown", "compile.group", "compile.ir",
    "compile.schedule", "compile.bind", "ivm.init", "ivm.apply", "ivm.validate",
    "ivm.tick", "ivm.publish", "serve.read", "compile.verify", "serve.checkpoint"})
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
    names = ("one block SEG", "segment ranges SEG", "one block HIST", "segment ranges HIST",
             "sorted ranges SEG", "sorted ranges HIST")
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
        n = PARTS_ROWS.get(label, KERNEL_ROWS)
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
        ops.reset_launches()
        got = ops.fused_scan_parts(reds)
        paths = dict(ops.RANGE_REDUCTIONS)
        want = ref.fused_scan_parts_ref(reds)
        abs_want = ref.fused_scan_parts_ref(absr)
        torch.cuda.synchronize()
        max_abs, max_rel = compare(got, want, abs_want, f"fused_scan_parts[{label}]")
        modes = [kseg.reduction_mode(kind, S, sum(ws) if kind == "seg" else 3 * ws[0])
                 for kind, S, ws in steps]
        check(paths == {"scan": modes.count(1), "sorted": modes.count(2)},
              f"fused_scan_parts[{label}]: range reductions {paths}, modes {modes}")
        outs = [torch.zeros_like(g) for g in got]

        def library():
            for o, i, p in zip(outs, sids, pays):
                o.index_add_(0, i, p)

        shapes = tuple(kseg.Shape("seg", S, tuple(ws), sum(ws)) if kind == "seg" else
                       kseg.Shape("hist", S, (ws[0], 1), 3 * ws[0]) for kind, S, ws in steps)
        case = dict(case=label, form="parts", n=n,
                    specs=[[kind, S, len(ws), sum(ws)] for kind, S, ws in steps],
                    geometry=launch_geometry(kseg.launch_plan(n, shapes, code.device)),
                    range_reductions=paths,
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
        vals = pay = mask = yk = None
        torch.cuda.empty_cache()
    n = KERNEL_ROWS
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
    geometry = dict(mode=("one block", "segment ranges", "sorted ranges")[lay.mode],
                    blocks_at_once=grid.wave_blocks,
                    blocks=[(it[1], it[3]) for it in lay.items],
                    ring_stages=(kseg.STAGES_A, 1, 1)[lay.mode],
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
        self.device = inv["date"].device
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


def oracle_covar(join, layout, with_abs: bool = False):
    """float64 XᵀX of the gathered join, on the card: ``(G, n)``, or ``(G,
    n, A)`` with ``with_abs``, A = |X|ᵀ|X| from the same pass (Σ|terms| of
    each entry)."""
    import torch

    p = layout.p
    G = torch.zeros((p, p), dtype=torch.float64, device="cuda")
    A = torch.zeros_like(G) if with_abs else None
    for m, col in join.chunks():
        X = torch.zeros((m, p), dtype=torch.float64, device="cuda")
        X[:, 0] = 1.0
        for a in layout.cont:
            X[:, layout.cont_idx(a)] = col(a).double()
        for a in layout.cat:
            X.scatter_(1, (layout.cat_offsets[a] + col(a).long())[:, None], 1.0)
        X[:, layout.label_idx] = col(layout.label).double()
        G += X.T @ X
        if with_abs:
            X.abs_()
            A += X.T @ X
    if with_abs:
        return G.cpu().numpy(), float(join.n), A.cpu().numpy()
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
        range_reductions = dict(ops.RANGE_REDUCTIONS)
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
        runs[label] = dict(C=C, N=N, layout=layout, launches=launches, warm=warm)
        emit(f"main.{label}", wall_s=wall, warm_wall_s=warm, launches=launches,
             range_reductions=range_reductions, static_launches=stats.n_kernel_launches, scan_steps=stats.n_scan_steps,
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
    return launches, dict(G=G, n=n_o, layout=layout, C=C, warm_s=runs["fused"]["warm"])


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


#: the tree fits of the ``trees`` phase: (phase, config overrides, static
#: launch sites)
TREE_VARIANTS = (("trees.fused", dict(fuse_kernels=True), 9),
                 ("trees.unfused", dict(fuse_kernels=False), 19))


def tree_phase(ds, db, join, n_fact: int, variants=TREE_VARIANTS):
    """A depth-4 regression tree (the reference's defaults) per variant
    (fused, then unfused), level by level through the stepping API; each
    level's statistics against the float64 oracle."""
    import numpy as np
    import torch

    from repro_torch.api import connect
    from repro_torch.kernels import ops
    from repro_torch.ml.trees import DecisionTree, split_stats, stack_mask_params

    launches = {}
    for phase, overrides, sites in variants:
        sess = connect(ds.schema, data=db.data, edges=ds.edges,
                       config=db.config.replace(**overrides))
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
        launches[phase] = dict(ops.LAUNCHES)
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
                      f"{phase}: level {d} {f.attr} statistics off the oracle "
                      f"by {float((err / np.maximum(sc, 1e-300)).max()):.3e} of Σ|terms|")
                worst_stat = max(worst_stat, float((err / np.maximum(sc, 1e-300)).max()))
        worst_gain, n_splits = 0.0, 0
        for d, orc in enumerate(oracles):
            ids = [n.node_id for n in dt.nodes if n.depth == d]
            check(len(ids) == level_n[d], f"{phase}: level {d} has {level_n[d]} "
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
                      f"{phase}: node {nid} splits on {node.feature}<={node.threshold} "
                      f"with oracle gain {chosen} against the best {best}")
                worst_gain = max(worst_gain, rel)
                n_splits += 1
        rmse, std = rmse_and_std(join, [dt], dt.features, ds.label)
        root_n = dt.nodes[0].n
        emit(phase, fit_s=wall, compile_s=compile_s, levels=level_n,
             dispatches=dt.batch.n_dispatches, launches=launches[phase],
             static_launches=stats_.n_kernel_launches, scan_steps=stats_.n_scan_steps,
             summary=stats_.summary(), peak_mem_gb=peak, n_nodes=len(dt.nodes),
             n_splits=n_splits, root_n=root_n, rmse=rmse, label_std=std,
             max_stat_err_over_abs=worst_stat, worst_gain_rel=worst_gain,
             oracle_s=oracle_s, tol=dict(stat=STAT_TOL, gain=GAIN_TOL,
                                         root_n=ROOT_N_TOL, rmse_ratio=RMSE_RATIO),
             splits=[[n.feature, n.threshold] for n in dt.nodes if not n.is_leaf])
        emit(f"{phase}.profile", n_nodes=level_n[-1], **prof)
        check(stats_.n_kernel_launches == sites,
              f"{phase}: static launches {stats_.n_kernel_launches} != {sites}")
        check(dt.batch.n_dispatches == len(levels) + 1,
              f"{phase}: {dt.batch.n_dispatches} passes for {len(levels)} levels "
              "and the profiled one")
        check(abs(root_n - n_fact) <= ROOT_N_TOL * n_fact,
              f"{phase}: root count {root_n} is not {n_fact} fact rows")
        check(all(n.n > 0 for n in dt.nodes), f"{phase}: a node holds no rows")
        check(n_splits > 0, f"{phase}: the tree did not split")
        check(rmse <= RMSE_RATIO * std, f"{phase}: RMSE {rmse} vs label std {std}")
        got = launches[phase]
        if overrides.get("backend") == "torch":
            check(sum(got.values()) == 0, f"{phase}: the torch backend launched {got}")
        elif overrides["fuse_kernels"]:
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


# ---------------------------------------------------------------- config

def config_phase(ds, db, join, orc, seed: int):
    """The choices a user makes at ``connect``, over the main session's
    tables: ``backend="torch"`` (the covar batch and the depth-4 tree fit
    reduced by ``index_add_``: the whole-path library baseline, no kernel
    launched), ``block_size="auto"`` on a fresh cache (the tuned block per
    step, the launches it implies, a second session that tunes nothing, a
    maintained copy whose delta lane tunes at its first tick and whose
    steady ticks sync nothing), and ``explain()`` of a batch, a maintained
    and a served handle."""
    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.data.relations import next_pow2
    from repro_torch.kernels import ops
    from repro_torch.ml.covar import assemble_covar, covar_queries

    sizes = db.sizes()
    fact, n_fact = ds.fact, sizes[ds.fact]
    qs, layout = covar_queries(ds)

    def covar_run(handle):
        """One pass of the covar views to C and N on the host."""
        out = handle.run()
        return assemble_covar({k: v.cpu().numpy() for k, v in out.items()}, layout)

    def warm_wall(handle):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handle.run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def covar_checks(phase, C, N, err):
        """Run after the phase's line is printed, so a failure shows it."""
        check(np.isfinite(C).all() and C.shape == (layout.p, layout.p),
              f"{phase}: covar not finite or of shape {C.shape}")
        check(N == float(np.float32(n_fact)), f"{phase}: N={N} is not {n_fact} fact rows")
        check(err <= COVAR_TOL, f"{phase}: covar vs oracle {err:.3e} > {COVAR_TOL}")

    # config.torch — the whole-path library baseline
    tdb = db.with_config(backend="torch")
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    th = tdb.views(qs)
    C, N = covar_run(th)
    cold = time.perf_counter() - t0
    warm = warm_wall(th)
    launches = dict(ops.LAUNCHES)
    prof = device_breakdown(lambda: th.run(), classify=kernel_group)
    err = scaled_err(C, orc["G"])
    emit("config.torch", cold_wall_s=cold, warm_wall_s=warm,
         main_fused_warm_wall_s=orc["warm_s"], over_fused=warm / orc["warm_s"],
         launches=launches, static_launches=th.stats.n_kernel_launches,
         summary=th.explain().summary(), vs_oracle=err, N=N, tol=COVAR_TOL)
    emit("config.torch.profile", **prof)
    covar_checks("config.torch", C, N, err)
    check(sum(launches.values()) == 0 and th.stats.n_kernel_launches == 0,
          f"config.torch: the torch backend launched {launches}")
    del th
    tree_phase(ds, db, join, n_fact, variants=(("config.torch.tree", dict(backend="torch"), 0),))

    # config.autotune — a fresh cache under build/
    cache = os.path.join(HERE, "build", "autotune_smoke.json")
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    if os.path.exists(cache):
        os.remove(cache)
    adb = db.with_config(block_size="auto", autotune_cache=cache)
    obs.clear_trace()
    obs.enable_tracing()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ah = adb.views(qs)
        C, N = covar_run(ah)
        cold = time.perf_counter() - t0
        tune_s = sum(e["dur"] for e in obs.get_tracer().events()
                     if e["name"] == "compile.autotune") / 1e6
    finally:
        obs.disable_tracing()
        obs.clear_trace()
    plan = ah.compiled.plan
    choices = [[r["rel"], r["block_size"]] for r in ah.explain().autotune]
    ops.reset_launches()
    warm = warm_wall(ah)
    launches = dict(ops.LAUNCHES)
    expected = sum(-(-sizes[st.rel] // min(bs, sizes[st.rel]))
                   for st, (_, bs) in zip(plan.schedule.steps, choices))
    err = scaled_err(C, orc["G"])
    second = db.with_config(block_size="auto", autotune_cache=cache).views(qs)
    C2, N2 = covar_run(second)
    emit("config.autotune", choices=choices, n_timed=plan.autotuner.n_timed,
         tune_s=tune_s, cold_wall_s=cold, warm_wall_s=warm,
         static_warm_wall_s=orc["warm_s"], launches=launches,
         expected_launches=expected, vs_oracle=err, N=N,
         second_session_n_timed=second.compiled.plan.autotuner.n_timed,
         second_session_vs_first=scaled_err(C2, C), tol=COVAR_TOL)
    covar_checks("config.autotune", C, N, err)
    check(plan.autotuner.n_timed > 0, "config.autotune: nothing was timed on a fresh cache")
    check(launches["fused_scan_block"] == expected
          and sum(launches.values()) == expected,
          f"config.autotune: launches {launches}, expected {expected} fused_scan_block")
    check(second.compiled.plan.autotuner.n_timed == 0
          and all(r["from_cache"] for r in second.explain().autotune),
          "config.autotune: a second session on the same cache tuned again")
    check(N2 == N and scaled_err(C2, C) <= COVAR_TOL,
          "config.autotune: the second session's covar differs")
    del second

    # the maintained copy under "auto": delta lane, steady ticks
    roots = {q.name: fact for q in qs}
    mh = adb.views(qs, maintain=True, roots=roots)
    mb = mh.maintained
    t0 = time.perf_counter()
    mh.run()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    updates = fact_updates(ds, seed + 2, 4)
    d0 = updates[0].updates[fact]
    n_delta = next_pow2(d0.n_inserts) + next_pow2(d0.n_deletes)
    walls, launches_tick, builds, timed = [], [], [], []
    for i, upd in enumerate(updates):
        steady = i >= 1
        before, built = ops.LAUNCHES["fused_scan_block"], mb.n_fold_traces
        n_timed = mb.plan.autotuner.n_timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if steady:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = mh.apply(upd)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        host = {k: v.cpu().numpy() for k, v in out.items()}
        walls.append(time.perf_counter() - t0)
        launches_tick.append(ops.LAUNCHES["fused_scan_block"] - before)
        builds.append(mb.n_fold_traces - built)
        timed.append(mb.plan.autotuner.n_timed - n_timed)
    Cm, Nm = assemble_covar(host, layout)
    delta = mb.plan.last_autotune_delta
    delta_bs = [r["block_size"] for r in delta if r["delta"]]
    fresh = adb.views(qs).compiled(mb.db)
    Cf, Nf = assemble_covar({k: v.cpu().numpy() for k, v in fresh.items()}, layout)
    del fresh
    summary_m = mh.explain().summary()
    emit("config.autotune.ivm", init_s=init_s, tick_walls_s=walls,
         launches_per_tick=launches_tick, runner_builds=builds,
         timed_per_tick=timed, delta_choices=[[r["rel"], r["block_size"], r["delta"]]
                                             for r in delta],
         batch_choices=[[r["rel"], r["block_size"]] for r in mb.plan.last_autotune],
         vs_fresh=scaled_err(Cm, Cf), N=Nm, summary=summary_m)
    check("autotune[delta]:" in summary_m, "config.autotune: no autotune[delta] line")
    check(len(delta_bs) == 1, f"config.autotune: delta lane {delta}")
    check(builds[0] == 1 and sum(builds[1:]) == 0 and sum(timed[1:]) == 0,
          f"config.autotune: runner builds {builds}, probes {timed} per tick")
    # the first tick's count also holds the delta lane's probes
    check(all(n == -(-n_delta // min(delta_bs[0], n_delta)) for n in launches_tick[1:]),
          f"config.autotune: launches per steady tick {launches_tick[1:]} for "
          f"blocks of {delta_bs[0]} over {n_delta} delta rows")
    check(Nm == Nf and scaled_err(Cm, Cf) <= COVAR_TOL,
          f"config.autotune: maintained covar vs a fresh pass {scaled_err(Cm, Cf):.3e}")

    # config.explain — one report across the three modes
    srv = mh.serve(max_pinned_epochs=4)
    for _ in range(3):
        srv.read()
    summaries = {"batch": ah.explain().summary(), "maintained": summary_m,
                 "served": mh.explain().summary()}
    emit("config.explain", **summaries)
    check(summaries["batch"].startswith("[batch] backend=cuda dispatches=")
          and "autotune[batch]:" in summaries["batch"],
          f"config.explain: batch summary {summaries['batch']!r}")
    check(summaries["maintained"].startswith("[maintained] backend=cuda")
          and "ivm: epoch=4 step=4" in summaries["maintained"],
          f"config.explain: maintained summary {summaries['maintained']!r}")
    check(summaries["served"].startswith("[served] backend=cuda")
          and "serve: reads=3" in summaries["served"],
          f"config.explain: served summary {summaries['served']!r}")
    del mh, mb, srv, ah, adb, tdb
    torch.cuda.empty_cache()


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
    (``seg_reduce``), a sharded tick's routing of deletes and renumbering
    by global row id (``searchsorted``), the resident relation's compaction
    and append (the keep mask's running sum, the destinations, the row
    moves), or the rest:
    the delta tuples' assembly, the payloads' products and gathers, the
    state fold."""
    g = kernel_group(name)
    if g != "other":
        return g
    if "searchsorted" in name:
        return "gid routing (searchsorted)"
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


# ---------------------------------------------------------------- serve

def serve_requests():
    """The routed requests of the serve phase: (query, expected tier); one
    round is these five in order."""
    from repro_torch.core.aggregates import COUNT, query, sum_of

    return {
        "q_exact": (query("q_exact", ["sku", "locn", "date"],
                          [sum_of("maxtemp"), COUNT, sum_of("inventoryunits")]), "exact"),
        "q_locn": (query("q_locn", ["locn"], [COUNT, sum_of("inventoryunits")]), "subsumed"),
        "q_date_sku": (query("q_date_sku", ["sku", "date"], [sum_of("maxtemp")]), "subsumed"),
        "q_total": (query("q_total", [], [COUNT]), "subsumed"),
        "q_cat": (query("q_cat", ["category"], [sum_of("prize"), COUNT]), "exact"),
    }


def group_oracle(join, schema, specs):
    """Float64 group-bys of the gathered join, on its device, in one pass:
    ``specs`` maps a name to ``(group_by, values)``, a value ``None`` (a
    count) or an attribute; returns per name ``(sums, Σ|terms|)`` shaped
    ``(*domains, len(values))``."""
    import math

    import torch

    out = {}
    for name, (gb, vals) in specs.items():
        dom = [schema.domain(a) for a in gb]
        out[name] = torch.zeros((math.prod(dom), 2 * len(vals)), dtype=torch.float64,
                                device=join.device)
    for m, col in join.chunks():
        for name, (gb, vals) in specs.items():
            flat = torch.zeros((m,), dtype=torch.int64, device=join.device)
            for a in gb:
                flat = flat * schema.domain(a) + col(a).long()
            v = torch.stack([torch.ones((m,), dtype=torch.float64, device=join.device)
                             if a is None else col(a).double() for a in vals], 1)
            out[name].index_add_(0, flat, torch.cat([v, v.abs()], 1))
    res = {}
    for name, (gb, vals) in specs.items():
        t = out[name].view(*[schema.domain(a) for a in gb], 2 * len(vals))
        res[name] = (t[..., :len(vals)], t[..., len(vals):])
    return res


def reaggregate(t, src_dims, dims, cols):
    """``t`` (*src domains, k) summed over the source dims not in ``dims``,
    its axes put in ``dims`` order and its columns ``cols`` picked."""
    import torch

    drop = tuple(i for i, d in enumerate(src_dims) if d not in dims)
    if drop:
        t = t.sum(dim=drop)
    kept = [d for d in src_dims if d in dims]
    t = t.permute(*[kept.index(d) for d in dims], len(kept))
    return t.index_select(-1, torch.tensor(cols, device=t.device))


def held(what, got, want, scale):
    """|got − want| ≤ STAT_TOL · Σ|terms| in every cell; returns the worst
    ratio."""
    check(tuple(got.shape) == tuple(want.shape),
          f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = (got.double() - want).abs()
    worst = float((err / scale.clamp_min(1e-300)).max()) if err.numel() else 0.0
    check(bool((err <= STAT_TOL * scale).all()),
          f"{what}: {worst:.3e} of Σ|terms| off the float64 oracle > {STAT_TOL}")
    return worst


def percentiles(us):
    import numpy as np

    return dict(n=len(us), p50_us=float(np.percentile(us, 50)) if us else None,
                p99_us=float(np.percentile(us, 99)) if us else None)


class CaptureLaunch:
    """``with CaptureLaunch() as cap:`` keeps the reductions of the widest
    ``fused_scan_parts`` launch made in the block (the main path's launch
    itself runs and counts as it would)."""

    def __enter__(self):
        from repro_torch.kernels import ops

        self._ops, self._orig = ops, ops.fused_scan_parts
        self.reds = None

        def capture(reds):
            reds = tuple(reds)
            if self.reds is None or reds[0].codes.shape[0] > self.reds[0].codes.shape[0]:
                self.reds = reds
            return self._orig(reds)

        ops.fused_scan_parts = capture
        return self

    def __exit__(self, *exc):
        self._ops.fused_scan_parts = self._orig
        return False


def captured_case(reds, label, rates):
    """A captured launch of the main path against its plain version on the
    same inputs, timed with the plain version, the sum of one
    ``index_add_`` per reduction on payloads packed beforehand, and the
    least time the card could take."""
    import torch

    from repro_torch.kernels import ops, ref

    bw, flops = rates[0], rates[1]
    n = reds[0].codes.shape[0]
    absr = tuple(ops.Parts(r.kind, r.codes, (r.parts[0], r.parts[1].abs()), r.n_segments)
                 if r.kind == "hist" else
                 ops.Parts(r.kind, r.codes, tuple(ops.Part(p.values.abs(), p.ocol, p.ostride)
                                                  for p in r.parts), r.n_segments, r.width)
                 for r in reds)
    got = ops.fused_scan_parts(reds)
    want = ref.fused_scan_parts_ref(reds)
    abs_want = ref.fused_scan_parts_ref(absr)
    torch.cuda.synchronize()
    max_abs, max_rel = compare(got, want, abs_want, f"fused_scan_parts[{label}]")
    sids, pays, outs, nbytes, n_ops, codes_seen = [], [], [], 0, 0, set()
    for r, o in zip(reds, got):
        ok = (r.codes >= 0) & (r.codes < r.n_segments)
        sids.append(torch.where(ok, r.codes, torch.zeros_like(r.codes)).long())
        if r.kind == "hist":
            cond, y = r.parts
            yk = torch.stack([torch.ones_like(y), y, y * y], 1)
            pay = (cond[:, :, None] * yk[:, None, :]).reshape(n, -1)
            nbytes += 4 * (cond.numel() + y.numel())
        else:
            pay = torch.zeros((n, r.out_width), device=r.codes.device)
            for p in r.parts:
                v = p.values.reshape(n, -1)
                pay[:, p.ocol + p.ostride * torch.arange(v.shape[1], device=v.device)] = v
                nbytes += 4 * v.shape[1] * (n if p.values.stride(0) != 0 else 1)
        pays.append((pay * ok[:, None].float()).contiguous())
        outs.append(torch.zeros_like(o))
        if r.codes.data_ptr() not in codes_seen:
            codes_seen.add(r.codes.data_ptr())
            nbytes += 4 * n
        nbytes += 4 * o.numel()
        n_ops += int(ok.sum()) * r.out_width * (2 if r.kind == "hist" else 1)

    def library():
        for o, i, p in zip(outs, sids, pays):
            o.index_add_(0, i, p)

    case = dict(case=label, form="parts", n=n,
                specs=[[r.kind, r.n_segments, len(r.parts), r.out_width] for r in reds],
                max_abs_err=max_abs, max_rel_err=max_rel,
                ms=cuda_ms(lambda: ops.fused_scan_parts(reds)),
                plain_ms=cuda_ms(lambda: ref.fused_scan_parts_ref(reds)),
                library_ms=cuda_ms(library),
                library_call="the sum of one index_add_ per reduction on payloads packed beforehand",
                **bound(nbytes, n_ops, bw, flops))
    return case


def serve_phase(ds, db, join, seed: int, card_line: str, rates):
    """Ad-hoc query serving over the resident Retailer tables: a second
    session (route cache of 2) with ``wide`` maintained and served and
    ``by_cat`` registered as a batch view; the routed requests of
    ``serve_requests`` in every tier against float64 oracles of the
    gathered join; compiled misses churning the cache; latencies with the
    writer idle and running; 1% fact ticks through ``ViewServer.apply``
    while the hit tiers route, all under ``set_sync_debug_mode("error")``;
    a snapshot held across publishes; a checkpoint taken while the writer
    runs and restored bitwise; a traced round and its chrome export."""
    import json as _json
    import tempfile
    import threading

    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.api import ExecutionConfig, connect
    from repro_torch.core import subsume
    from repro_torch.core.aggregates import COUNT, Lambda, agg, query, sum_of
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    schema = ds.schema
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    updates = fact_updates(ds, seed + 1, 3 + 2 * SERVE_TICKS + 1)
    fact = ds.fact

    # the routing session over the same resident tables (no copy)
    db2 = connect(db.data, config=ExecutionConfig(block_size=db.config.block_size,
                                                  route_cache_capacity=2),
                  edges=ds.edges)
    check(db2.data is db.data, "serve: the routing session copied the tables")
    wide_q = query("wide", ["date", "locn", "sku"],
                   [COUNT, sum_of("inventoryunits"), sum_of("maxtemp")])
    wide_dims = tuple(wide_q.group_by)
    t0 = time.perf_counter()
    wide_h = db2.views([wide_q], maintain=True)
    srv = wide_h.serve(max_pinned_epochs=4, warn_epoch_lag=2)
    torch.cuda.synchronize()
    start_s = time.perf_counter() - t0
    by_cat = db2.views([query("by_cat", ["category"], [COUNT, sum_of("prize")])])
    mb = wide_h.maintained
    reqs = serve_requests()

    # float64 oracles of the gathered join (the tables before any tick)
    t0 = time.perf_counter()
    misses = {"q_rgn": ["rgn_cd"], "q_clim": ["clim_zn"], "q_subcat": ["subcategory"]}
    orc = group_oracle(join, schema, dict(
        wide=(list(wide_dims), [None, "inventoryunits", "maxtemp"]),
        q_cat=(["category"], ["prize", None]),
        q_anon=(["rain"], ["inventoryunits"]),
        **{k: (gb, [None]) for k, gb in misses.items()}))
    W, Wa = orc["wide"]
    cols_of = {"q_exact": (["sku", "locn", "date"], [2, 0, 1]),
               "q_locn": (["locn"], [0, 1]), "q_date_sku": (["sku", "date"], [2]),
               "q_total": ([], [0])}
    for name, (dims, cols) in cols_of.items():
        orc[name] = (reaggregate(W, wide_dims, dims, cols),
                     reaggregate(Wa, wide_dims, dims, cols))
    orc["q_anon"] = (2 * orc["q_anon"][0], 2 * orc["q_anon"][1])
    oracle_s = time.perf_counter() - t0
    errs = {"wide": held("serve: wide", srv.read("wide"), W, Wa)}

    def route(q, sync=True):
        """One routed request: (result, caller wall µs, kernel launches)."""
        ops.reset_launches()
        t0 = time.perf_counter()
        r = db2.route(q)
        if sync:
            torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e6, dict(ops.LAUNCHES)

    # round 1 (cold): every tier against its oracle, launches per request
    first = {}
    for name, (q, tier) in reqs.items():
        r, us, launched = route(q)
        check(r.tier == tier, f"serve: {name} routed {r.tier}, expected {tier}")
        errs[name] = held(f"serve: {name}", r.value, *orc[name])
        scans = launched["fused_scan_block"]
        check(r.scanned == (scans > 0) and (scans > 0) == (name == "q_cat"),
              f"serve: {name} ({r.tier}, scanned={r.scanned}) launched fused_scan_block {scans}")
        first[name] = dict(tier=r.tier, us=us, launches=scans, epoch=r.epoch)

    # the cache churned: three distinct misses through capacity 2, the
    # first again; the widest launch of the first miss kept for the kernel
    # check below
    churn = {}
    for i, name in enumerate(list(misses) + ["q_rgn"]):
        q = query(name, misses[name], [COUNT])
        with CaptureLaunch() as cap:
            r, us, launched = route(q)
        if i == 0:
            miss_reds = cap.reds
        check(r.tier == "compiled" and launched["fused_scan_block"] > 0,
              f"serve: miss {name} routed {r.tier}, launches {launched}")
        errs[name] = held(f"serve: {name}", r.value, *orc[name])
        churn[f"{name}#{i}"] = dict(us=us, launches=launched["fused_scan_block"])
    st = db2.routing_stats()
    check(st["n_plans_compiled"] == 4 and st["n_evictions"] >= 1
          and st["n_admission_failures"] == 0,
          f"serve: compiled {st['n_plans_compiled']}, evicted {st['n_evictions']}, "
          f"admission failures {st['n_admission_failures']}")
    anon = query("q_anon", ["rain"], [agg(Lambda(("inventoryunits",), lambda u, p: u * 2.0))])
    r, us, launched = route(anon)
    check(r.tier == "fallback_scan" and launched["fused_scan_block"] > 0
          and db2.routing_stats()["cache_size"] <= 2,
          f"serve: untagged UDAF routed {r.tier}, launches {launched}")
    errs["q_anon"] = held("serve: q_anon", r.value, *orc["q_anon"])
    churn["q_anon"] = dict(us=us, launches=launched["fused_scan_block"], tier=r.tier)
    kernel_case = captured_case(miss_reds, "serve_miss_rgn_cd", rates)
    emit("serve.kernel", name="fused_scan_block", card=card_line, **kernel_case)
    del miss_reds

    # warm, then SERVE_ROUNDS rounds of the four maintained requests, the
    # caller syncing on each answer
    hit = [k for k in reqs if k != "q_cat"]
    for _ in range(2):
        for name in reqs:
            route(reqs[name][0])
    idle = {name: [] for name in reqs}
    for _ in range(SERVE_ROUNDS):
        for name in hit:
            r, us, launched = route(reqs[name][0])
            check(sum(launched.values()) == 0, f"serve: {name} launched {launched}")
            idle[name].append(us)
    for _ in range(3):
        idle["q_cat"].append(route(reqs["q_cat"][0])[1])
    # one round of the hit tiers under sync-debug "error": no host sync
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        nosync = {name: db2.route(reqs[name][0]) for name in hit}
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for name, r in nosync.items():
        check(r.tier == reqs[name][1], f"serve: {name} under sync-debug routed {r.tier}")
        held(f"serve: {name} (no sync)", r.value, *orc[name])
    del nosync

    # one q_locn re-aggregation on the card against its bound: the wide
    # view read once
    wide_out = srv.read("wide")
    reagg = subsume.lower_secondary(subsume.build_secondary_program(
        subsume.view_shape_of(wide_q, schema), subsume.view_shape_of(reqs["q_locn"][0], schema)))
    wide_bytes = wide_out.numel() * wide_out.element_size()
    reagg_ms = cuda_ms(lambda: reagg(wide_out), reps=20)
    reagg_bound_ms = wide_bytes / rates[0] * 1e3
    del wide_out

    # ticks with no reader: one warm, then timed from apply to the card done
    def tick(upd):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.apply(upd)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    it = iter(updates)
    tick(next(it))
    idle_ticks = [tick(next(it)) for _ in range(2)]

    # window 1: a writer thread folds SERVE_TICKS ticks while this thread
    # routes q_exact / q_locn and holds a snapshot, everything under
    # sync-debug "error"; the answers are checked after the mode is lifted
    views_at = {mb.epoch: dict(mb.epoch_state().views)}
    errors = []

    def writer(ticks, walls, sync):
        try:
            for upd in ticks:
                t0 = time.perf_counter()
                e = srv.apply(upd)
                if sync:
                    torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                views_at[e] = dict(mb.epoch_state().views)
        except Exception as exc:           # surfaced by the main thread
            errors.append(exc)

    w1 = [next(it) for _ in range(SERVE_TICKS)]
    w1_walls, routed = [], []
    e_first = srv.epoch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t = threading.Thread(target=writer, args=(w1, w1_walls, False))
        with srv.snapshot() as snap:
            snap_epoch = snap.epoch
            held_first = snap["wide"]
            held_again = None
            t.start()
            i = 0
            while (t.is_alive() or i < 4) and i < SERVE_MAX_ROUTES:
                name = ("q_exact", "q_locn")[i % 2]
                r = db2.route(reqs[name][0])
                routed.append((name, r.tier, r.epoch, r.value))
                if held_again is None and srv.epoch > snap_epoch:
                    held_again = srv.maintained.results(epoch=snap_epoch)["wide"]
                i += 1
                time.sleep(0.002)
            t.join()
            if held_again is None:
                held_again = srv.maintained.results(epoch=snap_epoch)["wide"]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(not errors, f"serve: the writer failed: {errors}")
    e_last = srv.epoch
    check(e_last == e_first + SERVE_TICKS, f"serve: epochs {e_first} -> {e_last}")
    check(torch.equal(held_first, held_again),
          "serve: two reads through a held snapshot differ across a publish")
    post = {}
    for name, tier, epoch, value in routed:
        check(tier == reqs[name][1] and e_first <= epoch <= e_last,
              f"serve: {name} routed {tier} at epoch {epoch}, published {e_first}..{e_last}")
        w = mb.plan.extract_outputs(views_at[epoch])["wide"].double()
        dims, cols = cols_of[name]
        post[name] = max(post.get(name, 0.0), held(
            f"serve: {name} at epoch {epoch}", value,
            reaggregate(w, wide_dims, dims, cols), reaggregate(w.abs(), wide_dims, dims, cols)))
    n_window1 = len(routed)
    del routed, held_first, held_again

    # window 2: the same with the caller syncing on each answer (latency
    # with the writer running), the writer syncing on each tick, and a
    # checkpoint taken while the writer runs
    w2 = [next(it) for _ in range(SERVE_TICKS)]
    w2_walls, busy, w2_epochs = [], {"q_exact": [], "q_locn": []}, set()
    e2_first = srv.epoch
    with tempfile.TemporaryDirectory() as tmp:
        t = threading.Thread(target=writer, args=(w2, w2_walls, True))
        t.start()
        i, ckpt_s = 0, None
        # routes back to back can hold the interpreter for SERVE_MAX_ROUTES
        # routes before the writer's first tick lands: route on past the
        # cap, while the writer runs, until the checkpoint is taken
        while t.is_alive() and (i < SERVE_MAX_ROUTES or ckpt_s is None):
            name = ("q_exact", "q_locn")[i % 2]
            r, us, _ = route(reqs[name][0])
            check(r.tier == reqs[name][1], f"serve: {name} routed {r.tier} beside the writer")
            busy[name].append(us)
            w2_epochs.add(r.epoch)
            if ckpt_s is None and w2_walls:
                t0 = time.perf_counter()
                srv.checkpoint(tmp)
                ckpt_s = time.perf_counter() - t0
            i += 1
        t.join()
        check(not errors, f"serve: the writer failed: {errors}")
        check(ckpt_s is not None, "serve: no checkpoint taken while the writer ran")
        check(all(e2_first <= e <= srv.epoch for e in w2_epochs),
              f"serve: routed epochs {sorted(w2_epochs)} outside {e2_first}..{srv.epoch}")
        other = db2.views([wide_q], maintain=True, register=False)
        t0 = time.perf_counter()
        other.restore(tmp)
        restore_s = time.perf_counter() - t0
    e_ck = other.maintained.epoch
    want = mb.plan.extract_outputs(views_at[e_ck])["wide"]
    check(torch.equal(other.results()["wide"], want),
          f"serve: the checkpoint of epoch {e_ck} restores a different wide view")
    del other, want

    # a traced round: the five requests, a served read, a tick, a
    # checkpoint, and a fresh maintained view compiled with the verifier on
    build = os.path.join(HERE, "build")
    os.makedirs(build, exist_ok=True)
    trace_path = os.path.join(build, "serve_trace.json")
    obs.clear_trace()
    obs.enable_tracing()
    try:
        for name in reqs:
            db2.route(reqs[name][0])
        srv.read("wide")
        traced_tick = tick(next(it))
        with tempfile.TemporaryDirectory() as tmp:
            srv.checkpoint(tmp)
        db2.views([query("q_traced", ["rain"], [COUNT])], maintain=True,
                  register=False, debug=True).run()
    finally:
        obs.disable_tracing()
    obs.export_chrome(trace_path)
    obs.clear_trace()
    with open(trace_path) as f:
        names = {e["name"] for e in _json.load(f)["traceEvents"]}
    missing = sorted(SERVE_SPANS - names)
    check(not missing, f"serve: the traced round lacks spans {missing}")

    sst = srv.stats()
    rst = db2.routing_stats()
    tiers_idle = {}
    for name, us in idle.items():
        tiers_idle.setdefault(reqs[name][1] if name != "q_cat" else "exact (batch scan)",
                              []).extend(us)
    emit("serve", card=card_line, fact_rows=db.sizes()[fact],
         wide_cells=int(np.prod([schema.domain(a) for a in wide_dims])),
         wide_mb=wide_bytes / 1e6, start_s=start_s, oracle_s=oracle_s,
         first_round=first, churn=churn,
         first_miss_wall_us=churn["q_rgn#0"]["us"],
         latency_idle={k: percentiles(v) for k, v in idle.items()},
         latency_idle_by_tier={k: percentiles(v) for k, v in tiers_idle.items()},
         latency_writer_running={k: percentiles(v) for k, v in busy.items()},
         err_over_abs=errs, err_over_abs_after_ticks=post,
         reagg_q_locn_ms=reagg_ms, reagg_bound_ms=reagg_bound_ms,
         reagg_over_bound=reagg_ms / reagg_bound_ms,
         tick_idle_s=idle_ticks, tick_window1_host_s=w1_walls,
         tick_under_routing_s=w2_walls, tick_traced_s=traced_tick,
         window1_routes=n_window1, epochs=[e_first, e_last],
         checkpoint_s=ckpt_s, restore_s=restore_s, checkpoint_epoch=e_ck,
         hit_rate=rst["hit_rate"], tiers=rst["tiers"],
         n_plans_compiled=rst["n_plans_compiled"], n_evictions=rst["n_evictions"],
         n_admission_checks=rst["n_admission_checks"],
         n_admission_failures=rst["n_admission_failures"],
         route_us=rst["route_us"], read_us=sst["read_us"], tick_us=sst["tick_us"],
         pinned_epochs_hwm=sst["pinned_epochs_hwm"], n_lag_warnings=sst["n_lag_warnings"],
         trace=os.path.relpath(trace_path, HERE), trace_spans=sorted(names),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
         phase_s=time.perf_counter() - t_phase)
    check(rst["n_admission_failures"] == 0, "serve: admission failures")
    del db2, wide_h, srv, by_cat, mb, views_at, orc, W, Wa
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- shard

#: shard phases: 1% fact ticks of each maintained copy (the first warms the
#: tick runner, the rest run under sync-debug "error" on NCCL)
SHARD_TICKS = 3
#: the 2-rank phase's process group timeout, s
SHARD_W2_TIMEOUT = 600
SHARD_W2_NOTE = "2 ranks share one card; gloo stages through the host"


def terms_err(C, D, A) -> float:
    """max |C − D| / Σ|terms| over the covar's entries."""
    import numpy as np

    return float((np.abs(C - D) / np.maximum(A, 1e-300)).max())


def maintained_ticks(ds, db, updates, label: str, sync_free_from: int = 1,
                     after=None):
    """A maintained covar (every query rooted at the fact) over ``db``, its
    init and one tick a update (ticks from ``sync_free_from`` on under
    ``set_sync_debug_mode("error")``): host covars after init and after
    each tick, tick walls, runner builds and fused_scan_block launches per
    tick, the handle, and ``after(maintained batch)`` after init and each
    tick, outside the walls."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.ml.covar import assemble_covar, covar_queries

    qs, layout = covar_queries(ds)
    h = db.views(qs, maintain=True, roots={q.name: ds.fact for q in qs})
    t0 = time.perf_counter()
    out = h.run()
    C0, N0 = assemble_covar({k: v.cpu().numpy() for k, v in out.items()}, layout)
    init_s = time.perf_counter() - t0
    mb = h.maintained
    Cs, Ns, walls, builds, launches = [C0], [N0], [], [], []
    seen = [after(mb)] if after else []
    for i, upd in enumerate(updates):
        before, built = ops.LAUNCHES["fused_scan_block"], mb.n_fold_traces
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i >= sync_free_from:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = h.apply(upd)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        host = {k: v.cpu().numpy() for k, v in out.items()}
        walls.append(time.perf_counter() - t0)
        C, N = assemble_covar(host, layout)
        Cs.append(C)
        Ns.append(N)
        builds.append(mb.n_fold_traces - built)
        launches.append(ops.LAUNCHES["fused_scan_block"] - before)
        if after:
            seen.append(after(mb))
    check(all(np.isfinite(C).all() for C in Cs), f"{label}: a covar is not finite")
    return dict(C=Cs, N=Ns, init_s=init_s, walls=walls, builds=builds,
                launches=launches, layout=layout, handle=h, after=seen)


def shard_w1_phase(ds, db, ref, seed: int, card_line: str):
    """World size 1 over NCCL in this process, through the port's mesh
    (``launch/mesh.py``, a ``HashStore``): the fused covar batch against
    ``main.fused``'s (its launches, N, the float64 oracle); one
    frontier-batched tree level of ``TREE_NODES`` random masks against
    the unsharded level and its float64 oracle; a sharded maintained copy
    with ``SHARD_TICKS`` 1% fact ticks, the steady ones under sync-debug
    "error" with no runner built, each held against an unsharded copy and
    the float64 oracle of the post-tick join to 1e-4 of Σ|terms|.
    Returns what ``shard.w2`` is held against."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.ml.covar import compute_covar
    from repro_torch.ml.trees import DecisionTree, split_stats, stack_mask_params

    t_phase = time.perf_counter()
    dist.init_process_group("nccl", store=dist.HashStore(), world_size=1, rank=0)
    try:
        mesh = make_host_mesh(device_type="cuda")
        sdb = db.with_config(mesh=mesh)

        # (a) the fused covar batch, cold then warm
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        C, N, layout, batch = compute_covar(ds, database=sdb)
        cold = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        C2, N2, _, _ = compute_covar(ds, database=sdb)
        warm = time.perf_counter() - t0
        err_main = scaled_err(C, ref["C"])
        err_oracle = scaled_err(C, ref["G"])
        bitwise = bool(np.array_equal(C, ref["C"]))
        rerun_bitwise = bool(np.array_equal(C, C2))

        # (b) one frontier-batched tree level, sharded and not
        rng = np.random.default_rng(seed)
        dt_s = DecisionTree(ds, database=sdb)
        dt_l = DecisionTree(ds, database=db)
        masks = [{f.attr: (rng.random(f.domain) < 0.7).astype(np.float32)
                  for f in dt_s.features} for _ in range(TREE_NODES)]
        params = stack_mask_params(dt_s.features, masks)
        dt_l.view.run_batched(params)                  # warm both
        dt_s.view.run_batched(params)
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st_s = split_stats(dt_s.view.run_batched(params), dt_s.features)
        tree_s = time.perf_counter() - t0
        tree_launches = ops.LAUNCHES["fused_scan_block"]
        ops.reset_launches()
        t0 = time.perf_counter()
        st_l = split_stats(dt_l.view.run_batched(params), dt_l.features)
        tree_l = time.perf_counter() - t0
        tree_launches_l = ops.LAUNCHES["fused_scan_block"]
        join = FactJoin(db.data)
        orc = oracle_level(join, dt_s.features, ds.label, masks)
        worst_tree, worst_pair = 0.0, 0.0
        for f in dt_s.features:
            o, sc = orc[f.attr]
            worst_tree = max(worst_tree, float((np.abs(st_s[f.attr] - o)
                                                / np.maximum(sc, 1e-300)).max()))
            worst_pair = max(worst_pair, float((np.abs(st_s[f.attr] - st_l[f.attr])
                                                / np.maximum(sc, 1e-300)).max()))
        tree_summary = dt_s.view.explain().summary()
        tree_profiles = {"sharded": device_breakdown(lambda: dt_s.view.run_batched(params)),
                         "local": device_breakdown(lambda: dt_l.view.run_batched(params))}
        del dt_s, dt_l, orc, join

        # (c) a sharded maintained copy and an unsharded one, tick for tick
        updates = fact_updates(ds, seed + 7, SHARD_TICKS)
        ops.reset_launches()
        # after init and each tick: the float64 oracle of the join over the
        # sharded copy's fact, gathered (and its row count)
        sh = maintained_ticks(ds, sdb, updates, "shard.w1", after=lambda mb: (
            oracle_covar(FactJoin(mb.db), layout, with_abs=True),
            mb.epoch_state().relations[ds.fact].n_valid))
        ivm_launches = dict(ops.LAUNCHES)
        lo = maintained_ticks(ds, db, updates, "shard.w1.local")
        msh = sh["handle"].maintained
        topology = msh.shard_topology()
        ivm_summary = sh["handle"].explain().summary()
        # one more tick of each copy, profiled (not held: the checks above
        # cover the three)
        extra = fact_updates(ds, seed + 8, 1)[0]
        tick_profiles = {"sharded": device_breakdown(lambda: sh["handle"].apply(extra),
                                                     classify=ivm_group),
                         "local": device_breakdown(lambda: lo["handle"].apply(extra),
                                                   classify=ivm_group)}
        orcs = [o for o, _ in sh["after"]]
        rows = [r for _, r in sh["after"]]
        vs_local = [terms_err(a, b, o[2]) for a, b, o in zip(sh["C"], lo["C"], orcs)]
        vs_oracle = [terms_err(a, o[0], o[2]) for a, o in zip(sh["C"], orcs)]
        local_vs_oracle = [terms_err(b, o[0], o[2]) for b, o in zip(lo["C"], orcs)]
        del sh["handle"], lo["handle"], msh
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    emit("shard.w1", card=card_line, world_size=1, backend="nccl",
         covar_cold_s=cold, covar_warm_s=warm, main_fused_warm_s=ref["warm_s"],
         launches=launches, main_fused_launches=ref["launches"], N=N,
         covar_vs_main_fused=err_main, covar_bitwise_main_fused=bitwise,
         covar_bitwise_rerun=rerun_bitwise, covar_vs_oracle=err_oracle,
         tree_nodes=TREE_NODES, tree_level_s=tree_s, tree_level_local_s=tree_l,
         tree_launches=tree_launches, tree_launches_local=tree_launches_l,
         tree_vs_oracle=worst_tree, tree_vs_local=worst_pair,
         ivm_init_s=sh["init_s"], ivm_local_init_s=lo["init_s"],
         tick_walls_s=sh["walls"], local_tick_walls_s=lo["walls"],
         runner_builds_per_tick=sh["builds"], launches_per_tick=sh["launches"],
         ivm_launches=ivm_launches, ticks_vs_local_terms=vs_local,
         ticks_vs_oracle_terms=vs_oracle, local_ticks_vs_oracle_terms=local_vs_oracle,
         fact_rows=rows, N_ticks=sh["N"], topology=topology,
         summary=ivm_summary, tree_summary=tree_summary, tol=COVAR_TOL,
         stat_tol=STAT_TOL, phase_s=time.perf_counter() - t_phase)
    emit("shard.w1.tree.profile", **tree_profiles)
    emit("shard.w1.tick.profile", **tick_profiles)
    check(launches["fused_scan_block"] == ref["launches"],
          f"shard.w1: sharded covar launched fused_scan_block {launches['fused_scan_block']} "
          f"times, main.fused {ref['launches']}")
    check(N == ref["N"] and N2 == N, f"shard.w1: N={N} (rerun {N2}), main.fused {ref['N']}")
    check(err_main <= COVAR_TOL, f"shard.w1: covar vs main.fused {err_main:.3e} > {COVAR_TOL}")
    check(err_oracle <= COVAR_TOL, f"shard.w1: covar vs oracle {err_oracle:.3e} > {COVAR_TOL}")
    check(worst_tree <= STAT_TOL and worst_pair <= STAT_TOL,
          f"shard.w1: tree level vs oracle {worst_tree:.3e}, vs unsharded {worst_pair:.3e} "
          f"of Σ|terms| > {STAT_TOL}")
    check(tree_launches == tree_launches_l > 0,
          f"shard.w1: tree level launches {tree_launches}, unsharded {tree_launches_l}")
    check(sh["builds"][0] == 1 and sum(sh["builds"][1:]) == 0,
          f"shard.w1: tick runner builds {sh['builds']}")
    check(max(vs_local) <= COVAR_TOL and max(vs_oracle) <= COVAR_TOL,
          f"shard.w1: ticks vs the unsharded copy {vs_local}, vs the oracle "
          f"{vs_oracle} of Σ|terms| > {COVAR_TOL}")
    check(all(o[1] == r and n == float(np.float32(r))
              for o, r, n in zip(orcs, rows, sh["N"])),
          f"shard.w1: N {sh['N']}, oracle rows {[o[1] for o in orcs]}, rows {rows}")
    check(topology["n_devices"] == 1 and topology["shard_rel"] == ds.fact,
          f"shard.w1: topology {topology}")
    return dict(tick_C=sh["C"], tick_A=[o[2] for o in orcs], tick_N=sh["N"])


def shard_w2_rank(rank, world, root, init_file, seed):
    """One rank of ``shard.w2``: the Retailer arrays mapped from ``root``,
    the session on the card under a 2-rank mesh over gloo, the fused covar
    and ``SHARD_TICKS`` ticks of a sharded maintained copy; results to
    ``root/rank<r>.npz``."""
    import datetime
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=SHARD_W2_TIMEOUT))
    try:
        from repro_torch.api import ExecutionConfig, connect
        from repro_torch.data.datasets import Dataset
        from repro_torch.kernels import ops
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.ml.covar import compute_covar

        t0 = time.perf_counter()
        with open(os.path.join(root, "dataset.pkl"), "rb") as f:
            meta, block_size = pickle.load(f)
        tables = {rel: {a: np.load(os.path.join(root, f"{rel}.{a}.npy"), mmap_mode="r")
                        for a in attrs} for rel, attrs in meta.pop("attrs").items()}
        ds = Dataset(tables=tables, **meta)
        mesh = make_host_mesh(n_data=world, device_type="cuda")
        db = connect(ds, config=ExecutionConfig(block_size=block_size, mesh=mesh))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        ops.reset_launches()
        t0 = time.perf_counter()
        C, N, _, _ = compute_covar(ds, database=db)
        covar_cold = time.perf_counter() - t0
        launches = ops.LAUNCHES["fused_scan_block"]
        t0 = time.perf_counter()
        compute_covar(ds, database=db)
        covar_warm = time.perf_counter() - t0
        updates = fact_updates(ds, seed + 7, SHARD_TICKS)
        res = maintained_ticks(ds, db, updates, f"shard.w2 rank {rank}",
                               sync_free_from=SHARD_TICKS)
        np.savez(os.path.join(root, f"rank{rank}.npz"), C=C, N=N, launches=launches,
                 tick_C=np.stack(res["C"]), tick_N=np.asarray(res["N"]),
                 walls=np.asarray([load_s, covar_cold, covar_warm, res["init_s"]]),
                 tick_walls=np.asarray(res["walls"]), builds=np.asarray(res["builds"]),
                 tick_launches=np.asarray(res["launches"]),
                 peak_gib=np.asarray([torch.cuda.max_memory_allocated(),
                                      torch.cuda.max_memory_reserved()]) / 2**30)
    finally:
        dist.destroy_process_group()


def shard_w2_phase(ds, block_size: int, ref, w1, seed: int, card_line: str):
    """Two ranks as processes on this card over gloo (``torch.multiprocessing``,
    a ``file://`` store under ``build/``): the Retailer arrays written once
    under ``build/`` and mapped by each rank; each runs the fused covar and
    ``SHARD_TICKS`` ticks.  Rank 0's covar against the main float64 oracle
    (N exact), every rank's ticks against ``shard.w1``'s to 1e-4 of
    Σ|terms|.  A rank's failure fails the phase.  This process holds no
    Retailer on the card meanwhile; what it and each rank reserve is in the
    phase's line."""
    import pickle
    import shutil

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    root = os.path.join(HERE, "build", "shard_w2")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t0 = time.perf_counter()
    for rel, cols in ds.tables.items():
        for a, c in cols.items():
            np.save(os.path.join(root, f"{rel}.{a}.npy"), np.asarray(c))
    meta = dict(name=ds.name, schema=ds.schema, edges=ds.edges,
                features_cont=ds.features_cont, features_cat=ds.features_cat,
                label=ds.label, fact=ds.fact,
                attrs={rel: list(cols) for rel, cols in ds.tables.items()})
    with open(os.path.join(root, "dataset.pkl"), "wb") as f:
        pickle.dump((meta, block_size), f)
    write_s = time.perf_counter() - t0
    main_reserved_gib = torch.cuda.memory_reserved() / 2**30
    t0 = time.perf_counter()
    try:
        mp.start_processes(shard_w2_rank, args=(2, root, os.path.join(root, "pg_store"), seed),
                           nprocs=2, start_method="spawn")
    except Exception as e:                     # a rank failed: the phase fails
        raise CheckFailed(f"shard.w2: a rank failed: {e}") from e
    ranks_s = time.perf_counter() - t0
    res = [dict(np.load(os.path.join(root, f"rank{r}.npz"))) for r in range(2)]
    shutil.rmtree(root, ignore_errors=True)
    G, n_o = ref["G"], ref["n"]
    err_oracle = scaled_err(res[0]["C"], G)
    ticks_vs_w1 = [[terms_err(c, w, a) for c, w, a in
                    zip(r["tick_C"], w1["tick_C"], w1["tick_A"])] for r in res]
    ranks_equal = bool(np.array_equal(res[0]["C"], res[1]["C"]))
    walls = {f"rank{r}": dict(zip(("load_s", "covar_cold_s", "covar_warm_s", "ivm_init_s"),
                                  map(float, x["walls"])),
                              tick_walls_s=x["tick_walls"].tolist())
             for r, x in enumerate(res)}
    emit("shard.w2", card=card_line, world_size=2, backend="gloo", note=SHARD_W2_NOTE,
         write_s=write_s, ranks_s=ranks_s, walls=walls, main_reserved_gib=main_reserved_gib,
         rank_peak_allocated_gib=[float(x["peak_gib"][0]) for x in res],
         rank_peak_reserved_gib=[float(x["peak_gib"][1]) for x in res],
         card_gib=torch.cuda.get_device_properties(0).total_memory / 2**30,
         fused_scan_block_per_rank=[int(x["launches"]) for x in res],
         main_fused_launches=ref["launches"],
         tick_launches_per_rank=[x["tick_launches"].tolist() for x in res],
         runner_builds_per_rank=[x["builds"].tolist() for x in res],
         N=float(res[0]["N"]), N_oracle=n_o, covar_vs_oracle=err_oracle,
         covar_ranks_bitwise=ranks_equal, ticks_vs_w1_terms=ticks_vs_w1, tol=COVAR_TOL,
         phase_s=time.perf_counter() - t_phase)
    check(float(res[0]["N"]) == n_o, f"shard.w2: N={res[0]['N']}, oracle {n_o}")
    check(err_oracle <= COVAR_TOL, f"shard.w2: rank 0 covar vs oracle {err_oracle:.3e}")
    check(ranks_equal, "shard.w2: the ranks' covars differ (an all-reduce gives every "
          "rank the same sum)")
    check(max(max(t) for t in ticks_vs_w1) <= COVAR_TOL,
          f"shard.w2: ticks vs shard.w1 {ticks_vs_w1} of Σ|terms| > {COVAR_TOL}")
    check(all((x["tick_N"] == w1["tick_N"]).all() for x in res),
          f"shard.w2: tick N {[x['tick_N'].tolist() for x in res]} vs w1 {w1['tick_N']}")
    check(all(0 < int(x["launches"]) < ref["launches"] for x in res),
          f"shard.w2: launches a rank {[int(x['launches']) for x in res]}")


# ---------------------------------------------------------------- LM

#: flash_attention's cases: (label, B, H, H_kv, S_q, S_k, D_q, D_v, causal,
#: window, dtype); the first is the summary line's (internlm2-1.8b's
#: prefill at B = 4).  MLA's prefill is D_q = 128 + 64 of rope against
#: D_v = 128; the VLM's cross-attention 4,096 text rows against 1,024
#: vision tokens; whisper's encoder 1,500 frames, non-causal.
ATTN_CASES = (
    ("internlm2-1.8b", 4, 16, 8, 4096, 4096, 128, 128, True, 0, "bfloat16"),
    ("internlm2-1.8b.f32", 4, 16, 8, 4096, 4096, 128, 128, True, 0, "float32"),
    ("llama3-8b", 2, 32, 8, 4096, 4096, 128, 128, True, 0, "bfloat16"),
    ("minicpm-2b", 4, 36, 36, 2048, 2048, 64, 64, True, 0, "bfloat16"),
    ("h2o-danube-3-4b", 1, 32, 8, 8192, 8192, 120, 120, True, 4096, "bfloat16"),
    ("ragged.noncausal", 2, 8, 4, 1000, 1000, 16, 16, False, 0, "float32"),
    ("ragged.bf16", 2, 8, 4, 1000, 1000, 128, 128, True, 0, "bfloat16"),
    ("prefill_32k", 1, 16, 8, 32768, 32768, 128, 128, True, 0, "bfloat16"),
    ("qwen3-moe-235b-a22b", 4, 64, 4, 4096, 4096, 128, 128, True, 0, "bfloat16"),
    ("zamba2-1.2b", 4, 32, 32, 4096, 4096, 64, 64, True, 0, "bfloat16"),
    ("deepseek-v2-lite-16b.mla", 4, 16, 16, 4096, 4096, 192, 128, True, 0, "bfloat16"),
    ("deepseek-v2-lite-16b.mla.f32", 4, 16, 16, 4096, 4096, 192, 128, True, 0, "float32"),
    ("llama-3.2-vision-90b.cross", 4, 64, 8, 4096, 1024, 128, 128, False, 0, "bfloat16"),
    ("whisper-small.encoder", 4, 12, 12, 1500, 1500, 64, 64, False, 0, "bfloat16"),
    ("zamba2-1.2b.f32", 4, 32, 32, 4096, 4096, 64, 64, True, 0, "float32"),
    ("llama-3.2-vision-90b.cross.f32", 4, 64, 8, 4096, 1024, 128, 128, False, 0, "float32"),
    ("wide.192x192.f32", 2, 8, 4, 1000, 1000, 192, 192, True, 0, "float32"),
)
#: scaled_dot_product_attention's backends by the aten op each dispatches to
SDPA_BACKENDS = (("flash", "_scaled_dot_product_flash_attention"),
                 ("efficient", "_scaled_dot_product_efficient_attention"),
                 ("cudnn", "_scaled_dot_product_cudnn_attention"),
                 ("math", "_scaled_dot_product_attention_math"))
#: query rows held against the plain version where its float32 scores
#: would pass PLAIN_SCORE_BYTES (prefill_32k: 68 GB; qwen3-moe: 17 GB, and
#: the plain version holds four such tensors at once)
SAMPLED_ROWS = 512
PLAIN_SCORE_BYTES = 16e9
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
    t = min(int(rows.max()) + 1, k.shape[2]) if causal else k.shape[2]
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


def sdpa_backend(fn) -> str:
    """The backend ``scaled_dot_product_attention`` runs in ``fn``, read off
    the aten op it dispatches to (the profiler's host events)."""
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    for backend, op in SDPA_BACKENDS:
        if any(op in n for n in names):
            return backend
    return "unknown"


def attention_kernel_cases(args, rates):
    """``flash_attention`` against its plain version at the models'
    attention shapes, on (B, H, S, D) views of (B, S, H, D) tensors as the
    model passes them: error, kernel, plain and SDPA times (SDPA takes
    E_v ≠ E; at GQA shapes it is timed twice, with ``enable_gqa=True`` and
    on K and V expanded by ``repeat_interleave`` outside the timed call,
    each call's backend recorded, and the faster is the library time),
    bound (unmasked pairs × 2 (D_q + D_v) operations; float32 at 3xTF32,
    three TF32 products a term on the tensor cores, with the CUDA cores'
    bound beside it)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    bw, f32_flops, bf16_flops = rates
    tf32_flops = bf16_flops / 2
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    cases = []
    for label, b, h, hkv, s, sk, d, dv, causal, window, dt in ATTN_CASES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn((b, n, heads, width), generator=gen, device="cuda")
                   .to(dtype).transpose(1, 2)
                   for n, heads, width in ((s, h, d), (sk, hkv, d), (sk, hkv, dv)))
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        reps = 3 if s > 8192 else 5
        if b * h * s * sk * 4 > PLAIN_SCORE_BYTES:
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
            sdpa = lambda k, v, gqa: F.scaled_dot_product_attention(
                q, k, v, attn_mask=allowed, enable_gqa=gqa)
        else:
            sdpa = lambda k, v, gqa: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=gqa)
        library_gqa_ms = cuda_ms(lambda: sdpa(k, v, True), reps)
        backend_gqa = sdpa_backend(lambda: sdpa(k, v, True))
        library_expanded_ms = backend_expanded = None
        if h != hkv:
            ke, ve = (t.repeat_interleave(h // hkv, dim=1) for t in (k, v))
            library_expanded_ms = cuda_ms(lambda: sdpa(ke, ve, False), reps)
            backend_expanded = sdpa_backend(lambda: sdpa(ke, ve, False))
            del ke, ve
        library_ms = min(t for t in (library_gqa_ms, library_expanded_ms) if t is not None)
        nbytes = q.element_size() * b * (d + dv) * (h * s + hkv * sk)
        pairs = b * h * unmasked_pairs(s, sk, causal, window)
        n_ops = 2 * (d + dv) * pairs
        if dt == "bfloat16":
            peak, rate = bf16_flops, "bf16 tensor cores"
            f32_bounds = dict(bound_cuda_cores_ms=None, bound_3xtf32_ms=None)
        else:
            peak, rate = tf32_flops / 3, "3xTF32: three TF32 products a term on the tensor cores"
            f32_bounds = dict(bound_cuda_cores_ms=bound(nbytes, n_ops, bw, f32_flops)["bound_ms"],
                              bound_3xtf32_ms=bound(nbytes, n_ops, bw, peak)["bound_ms"])
        case = dict(case=label, B=b, H=h, H_kv=hkv, S=s, S_k=sk, D=d, D_v=dv,
                    causal=causal,
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
                    library_enable_gqa_ms=library_gqa_ms, library_enable_gqa_backend=backend_gqa,
                    library_expanded_ms=library_expanded_ms,
                    library_expanded_backend=backend_expanded,
                    unmasked_pairs=pairs, achieved_tflops=n_ops / ms / 1e9,
                    bound_rate=rate, **f32_bounds, **bound(nbytes, n_ops, bw, peak))
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

    # the analytic count is exact for attention (MLA too), MoE and
    # cross-attention blocks; it leaves out whisper's learned encoder
    # positions and the encoder's last norm, and for SSM blocks conv_w and
    # D (the reference's param_count)
    if cfg.family not in ("ssm", "hybrid"):
        want = cfg.param_count() + ((cfg.encoder_frames + 1) * cfg.d_model
                                    if cfg.family == "audio" else 0)
        check(numel(params) == want,
              f"{cfg.name}: {numel(params)} parameters, expected {want}")
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
        want = M.forward(tree_cast(p, torch.float32), batch, f32, impl="dense")[0]
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


# ---------------------------------------------------------------- examples

#: the port's engine examples, in tools/torch_examples_smoke.py's order
EXAMPLES = ("torch_quickstart", "torch_ridge_over_joins", "torch_decision_tree",
            "torch_chow_liu_cubes", "torch_streaming_ridge")
#: their data size: 600,000 Favorita and Retailer fact rows
EXAMPLES_SCALE = "10"


def example_checks(name: str, res) -> list:
    """Each example's own oracle on the numbers its ``main()`` returned:
    ``(what, ok)`` pairs."""
    if name == "torch_quickstart":
        want = res["total_units"] + res["inserted_units"]
        return [("epoch 1 after one insert", res["epoch"] == 1),
                ("total after the insert = total + inserted units (rel 1e-4)",
                 abs(res["total_units_after_insert"] - want) <= 1e-4 * abs(want))]
    if name == "torch_ridge_over_joins":
        return [(f"BGD RMSE within {RMSE_TOL} of the closed form's",
                 abs(res["rmse_bgd"] / res["rmse_closed_form"] - 1) <= RMSE_TOL),
                ("ridge learns", res["rmse_closed_form"] < RMSE_RATIO * res["rmse_predict_mean"])]
    if name == "torch_decision_tree":
        return [("regression tree below the mean's RMSE", res["rmse"] < res["rmse_predict_mean"]),
                ("classification accuracy above the majority class",
                 res["accuracy"] > res["majority"])]
    if name == "torch_chow_liu_cubes":
        return [("engine cube equals the lattice roll-up", res["cube_equals_rollup"]),
                ("a tree of 6 edges over 7 attributes", len(res["edges"]) == 6)]
    return [("tick steps 1-5", res["steps"] == [1, 2, 3, 4, 5]),
            (f"maintained vs fresh within {COVAR_TOL}", res["maintained_vs_fresh_rel"] <= COVAR_TOL),
            ("pinned epoch frozen while the next is published",
             res["snapshot_frozen"] and res["published_epoch"] == res["pinned_epoch"] + 1),
            ("N unchanged by equal inserts and deletes", res["N"] == res["N_fit"])]


def examples_phase():
    """The five port examples in-process on the card at EXAMPLES_SCALE:
    each one's numbers held by its own oracle, its wall and its launches;
    no JAX and no ``repro`` module loaded after."""
    import runpy

    import torch

    from repro_torch.kernels import ops

    os.environ["EXAMPLES_SCALE"] = EXAMPLES_SCALE
    t_phase = time.perf_counter()
    for name in EXAMPLES:
        mod = runpy.run_path(os.path.join(HERE, "examples", f"{name}.py"),
                             run_name="example")
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        res = mod["main"](["--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        checks = example_checks(name, res)
        emit("examples", example=name, scale=float(EXAMPLES_SCALE), wall_s=wall,
             launches=launches, result=res, checks={w: bool(ok) for w, ok in checks})
        for what, ok in checks:
            check(ok, f"examples: {name}: {what}")
        if name != "torch_quickstart":                      # backend="torch"
            check(launches.get("fused_scan_block", 0) > 0,
                  f"examples: {name} launched no fused_scan_block: {launches}")
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
    emit("examples.done", phase_s=time.perf_counter() - t_phase, foreign_modules=foreign)
    check(not foreign, f"examples: JAX or the reference loaded: {foreign[:5]}")


# ---------------------------------------------------------------- LM families

#: (phase, architecture, float32 depth, bf16 depth): None is the full depth.
#: (phase, arch, float32 layers, bf16 layers; None: full depth).
#: qwen3-moe-235b-a22b holds 9.93 GB of float32 weights a layer (4.97 GB in
#: bf16; 437 GiB in all): the float32 checks run 4 layers (B 1, with the
#: dense attention's scores), the bf16 walls 8 (41 GB).  deepseek-v2-lite
#: (MLA) is 29.8 GiB in bf16 at its 27 layers, 59.6 GiB in float32: the
#: checks run 8 layers (18.2 GiB).  llama-3.2-vision-90b is 161 GiB in
#: bf16: 20 layers (4 super-blocks, 33.8 GiB) for the walls, one
#: super-block of 5 in float32.  whisper-small runs whole.  For the
#: script's time (the same code paths, and room for lm.train, lm.shard and
#: the families' sharded checks) mamba2-2.7b's float32 checks run 8 of its
#: 64 layers and zamba2-1.2b's 14 of 38 (two groups of six and the tail of
#: two); their bf16 walls run every layer.
LM_FAMILIES = (("lm.moe", "qwen3-moe-235b-a22b", 4, 8),
               ("lm.ssm", "mamba2-2.7b", 8, None),
               ("lm.hybrid", "zamba2-1.2b", 14, None),
               ("lm.mla", "deepseek-v2-lite-16b", 8, None),
               ("lm.vlm", "llama-3.2-vision-90b", 5, 20),
               ("lm.audio", "whisper-small", None, None))
#: whisper's decoder prefill: its own text context (``n_text_ctx`` of
#: openai/whisper's ModelDimensions), against the encoder's 1,500 frames
AUDIO_TEXT_CTX = 448
#: teacher-forced decode length of the families' check: two SSD chunks, so
#: the recurrence is held against the inter-chunk state carry too
DECODE_CHECK_LEN = 256


class RouteLog:
    """Records every ``moe.route`` call's top-k experts (sorted) while
    active: the routing of each (layer, token)."""

    def __enter__(self):
        from repro_torch.models import moe

        self.calls, self._route = [], moe.route

        def route(p, xf, cfg):
            probs, top_w, top_e = self._route(p, xf, cfg)
            self.calls.append(top_e.sort(dim=-1).values)
            return probs, top_w, top_e

        moe.route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.route = self._route

    def prefill(self, b: int, s: int):
        """(layers, B, S, k) from one forward's calls."""
        import torch

        return torch.stack(self.calls).reshape(len(self.calls), b, s, -1)

    def decode(self, b: int, s: int):
        """(layers, B, S, k) from ``s`` decode steps' calls."""
        import torch

        t = torch.stack(self.calls)
        return t.reshape(s, len(self.calls) // s, b, -1).permute(1, 2, 0, 3)


def family_seq(cfg) -> int:
    """The prefill length of a family's checks and walls."""
    return AUDIO_TEXT_CTX if cfg.family == "audio" else LM_SEQ


def family_context(cfg, b: int, rng, device="cuda"):
    """The raw context of a VLM or audio request batch, as the reference's
    ``launch/serve.py`` makes it: 0.02·N(0, 1) from ``rng``, (b, vision
    tokens or frames, d_model) float32 under its batch key ({} for the
    other families)."""
    import torch

    if cfg.family not in ("vlm", "audio"):
        return {}
    key, n = (("vision", cfg.vision_tokens) if cfg.family == "vlm"
              else ("frames", cfg.encoder_frames))
    raw = (0.02 * rng.standard_normal((b, n, cfg.d_model))).astype("float32")
    return {key: torch.from_numpy(raw).to(device)}


def flash_launches_a_forward(cfg) -> int:
    """``flash_attention`` launches of one forward: one an attention layer
    (the VLM's self and cross layers alike; whisper's encoder layers and
    its decoder's self and cross attention), the hybrid's shared block once
    a group, none for the SSM."""
    return {"moe": cfg.n_layers, "ssm": 0, "vlm": cfg.n_layers,
            "hybrid": cfg.n_layers // max(cfg.attn_every, 1),
            "audio": cfg.encoder_layers + 2 * cfg.n_layers}[cfg.family]


def route_agreement(a, b):
    """The share of (layer, token) top-k sets that agree, and the tokens
    whose own routing and every earlier token's in their sequence agreed in
    every layer (their attention and capacity ranks saw the same routing):
    the positions where logits are held."""
    import torch

    agree = (a == b).all(-1)                              # (L, B, S)
    held = torch.cumprod(agree.all(0).int(), dim=1).bool()
    return float(agree.float().mean()), held


def family_f32_checks(cfg, seed: int, mesh=None):
    """Float32 at full width: the flash prefill against the dense one, then
    teacher-forced ``decode_step`` against the flash prefill over
    DECODE_CHECK_LEN tokens (for MoE with the capacity at E/k, so no
    assignment is dropped in either); logits held where routing agreed
    (``route_agreement``); VLM and audio decode read the context that
    ``encode_context`` made once.  ``generate`` runs in the bf16 walls.
    With ``mesh``, the first SHARD_DECODE_CHECK of those steps again on it
    against unsharded ones (``family_shard_decode_f32``)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    moe = cfg.family == "moe"
    b = 1 if moe or cfg.family == "vlm" else LM_F32_BATCH
    seq_len = family_seq(cfg)
    params = lm_params(cfg, seed)
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, seq_len))).cuda()
    batch = {"tokens": tokens, **family_context(cfg, b, rng)}
    ops.reset_launches()
    with RouteLog() as rf:
        flash, _ = M.forward(params, batch, cfg, impl="flash")
        torch.cuda.synchronize()
    fwd_launches = dict(ops.LAUNCHES)
    with RouteLog() as rd:
        dense, _ = M.forward(params, batch, cfg, impl="dense")
    out = dict(prefill_batch=b, seq=seq_len)
    held = torch.ones((b, seq_len), dtype=torch.bool, device="cuda")
    if moe:
        out["prefill_route_agreement"], held = route_agreement(
            rf.prefill(b, seq_len), rd.prefill(b, seq_len))
        out["prefill_held_tokens"] = int(held.sum())
    check(bool(torch.isfinite(flash).all()) and tuple(flash.shape) == (b, seq_len, cfg.vocab),
          f"{cfg.name}: f32 prefill logits not finite or of shape {tuple(flash.shape)}")
    out.update(flash_vs_dense_max_abs=float((flash - dense)[held].abs().max()),
               flash_vs_dense_over_tol=allclose_excess(flash[held], dense[held],
                                                       ATTN_TOL["float32"]),
               logits_max_abs=float(dense.abs().max()), forward_launches=fwd_launches)
    del flash, dense
    torch.cuda.empty_cache()

    n = DECODE_CHECK_LEN
    seq = torch.from_numpy(rng.integers(0, cfg.vocab, (SERVE_BATCH, n))).cuda()
    ctx = family_context(cfg, SERVE_BATCH, rng)
    dcfg = cfg.with_(capacity_factor=cfg.n_experts / cfg.top_k) if moe else cfg
    with RouteLog() as rp:
        full, _ = M.forward(params, {"tokens": seq, **ctx}, dcfg, impl="flash")
    context = M.encode_context(params, ctx, dcfg)
    cache = M.init_cache(dcfg, SERVE_BATCH, n, "cuda")
    ops.reset_launches()
    excess = torch.zeros((SERVE_BATCH, n), device="cuda")
    err = torch.zeros((SERVE_BATCH, n), device="cuda")
    with RouteLog() as rs:
        for pos in range(n):
            lg, cache = M.decode_step(params, cache, seq[:, pos:pos + 1], pos, dcfg,
                                      context=context)
            d = (lg[:, 0] - full[:, pos]).abs()
            err[:, pos] = d.amax(-1)
            excess[:, pos] = (d / (DECODE_TOL + DECODE_TOL * full[:, pos].abs())).amax(-1)
    out["decode_launches"] = dict(ops.LAUNCHES)
    held = torch.ones((SERVE_BATCH, n), dtype=torch.bool, device="cuda")
    if moe:
        out["decode_capacity_factor"] = dcfg.capacity_factor
        out["decode_route_agreement"], held = route_agreement(
            rp.prefill(SERVE_BATCH, n), rs.decode(SERVE_BATCH, n))
        out["decode_held_tokens"] = int(held.sum())
    out.update(decode_len=n, decode_vs_prefill_max_abs=float(err[held].max()),
               decode_vs_prefill_over_tol=float(excess[held].max()))
    del full, cache, context
    if mesh is not None:
        out["shard"] = family_shard_decode_f32(dcfg, params, seq, ctx, mesh)
    del params
    torch.cuda.empty_cache()
    return out


def launches_since(before: dict) -> dict:
    """The launches counted since the snapshot ``before``."""
    from repro_torch.kernels import ops

    return {k: n - before.get(k, 0) for k, n in ops.LAUNCHES.items()}


def family_bf16_walls(cfg, seed: int, mesh=None):
    """bf16: the main path (one flash prefill at B 4 × 4,096 tokens, 448
    for whisper, then a ``BatchedServer`` that encodes its raw context once,
    then ``generate``) with its launches and its tokens checked, warm
    prefill walls, tokens/s, peak memory, a device breakdown, and ms a
    decode step (a second ``generate`` of FAMILY_TIMED_GEN new tokens).
    With ``mesh``, the same weights
    and batch on it against the unsharded port (``family_shard_bf16``)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serve.engine import BatchedServer

    params = lm_params(cfg, seed)
    rng = np.random.default_rng(seed + 1)
    seq_len = family_seq(cfg)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (LM_BF16_BATCH, seq_len))).cuda(),
             **family_context(cfg, LM_BF16_BATCH, rng)}
    prompts = rng.integers(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
    raw = next(iter(family_context(cfg, SERVE_BATCH, rng, "cpu").values()), None)

    def prefill():
        return M.forward(params, batch, cfg, impl="flash")[0]

    torch.cuda.synchronize()
    ops.reset_launches()
    lg = prefill()
    torch.cuda.synchronize()
    prefill_launches = dict(ops.LAUNCHES)
    check(bool(torch.isfinite(lg).all()), f"{cfg.name}: bf16 prefill logits not finite")
    del lg
    server = BatchedServer(cfg, params, max_len=SERVE_PROMPT + SERVE_GEN,
                           batch=SERVE_BATCH, device="cuda",
                           context=None if raw is None else raw.numpy())
    torch.cuda.synchronize()
    encode_launches = launches_since(prefill_launches)
    before_generate = dict(ops.LAUNCHES)
    out = server.generate(prompts, SERVE_GEN)
    torch.cuda.synchronize()
    generate_launches = launches_since(before_generate)
    launches = dict(ops.LAUNCHES)
    check(out.shape == (SERVE_BATCH, SERVE_PROMPT + SERVE_GEN)
          and (out[:, :SERVE_PROMPT] == prompts).all()
          and ((out >= 0) & (out < cfg.vocab)).all(), f"{cfg.name}: generate's tokens")
    walls = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg = prefill()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        del lg
    peak = torch.cuda.max_memory_allocated() / 2**30
    prof = device_breakdown(prefill, top=10, classify=lm_kernel_group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out2 = server.generate(prompts, FAMILY_TIMED_GEN)
    gen_wall = time.perf_counter() - t0
    steps = SERVE_PROMPT + FAMILY_TIMED_GEN - 1
    tokens = LM_BF16_BATCH * seq_len
    del server
    torch.cuda.empty_cache()
    shard = (family_shard_bf16(cfg, params, batch, raw, mesh, rng)
             if mesh is not None else None)
    del params
    torch.cuda.empty_cache()
    return dict(shard=shard, prefill_batch=LM_BF16_BATCH, seq=seq_len, prefill_walls_s=walls,
                prefill_tokens_per_s=tokens / sorted(walls)[1], peak_mem_gb=peak,
                context_shape=None if raw is None else list(raw.shape),
                prefill_launches=prefill_launches, encode_launches=encode_launches,
                generate_launches=generate_launches, launches=launches,
                generate_wall_s=gen_wall, decode_steps=steps,
                ms_per_decode_step=gen_wall / steps * 1e3,
                generated_tokens_per_s=SERVE_BATCH * FAMILY_TIMED_GEN / gen_wall,
                same_tokens_as_first_generate=bool((out2 == out[:, :out2.shape[1]]).all()),
                serve=dict(batch=SERVE_BATCH, prompt=SERVE_PROMPT, gen=SERVE_GEN,
                           timed_gen=FAMILY_TIMED_GEN),
                prefill_profile=prof)


#: the families whose sharded steps are checked in their own phase on a
#: (1, 1) NCCL mesh (lm.shard holds the dense one)
SHARD_FAMILIES = ("mamba2-2.7b", "zamba2-1.2b", "deepseek-v2-lite-16b",
                  "llama-3.2-vision-90b", "whisper-small")
#: the sharded decode walls (the families' and lm.shard's): a prompt of 8
#: teacher-forced tokens and 8 new ones at batch 8, against the
#: unsharded steps of the same shape (DTensor's decode is host-bound: 127
#: steps of mamba2's 64 layers take 41 s on an H100)
SHARD_DECODE_PROMPT, SHARD_DECODE_GEN = 8, 8
#: the families' timed second ``generate``: the 64-token prompt and 16 new
#: tokens (79 steps, not 127, for the script's time)
FAMILY_TIMED_GEN = 16


@contextlib.contextmanager
def one_rank_mesh():
    """A ("data", "model") mesh of (1, 1) over NCCL at world size 1 in this
    process (a ``HashStore``), the group destroyed on exit."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group("nccl", store=dist.HashStore(), world_size=1, rank=0)
    try:
        yield make_host_mesh(device_type="cuda")
    finally:
        dist.destroy_process_group()


def sharded_params(cfg, params, mesh):
    """``params`` placed on ``mesh`` by the reference's specs: on a (1, 1)
    mesh every shard is the whole leaf, its storage shared."""
    from repro_torch.distributed.sharding import param_pspecs, rules_for, shard_tree
    from repro_torch.models import model as M

    return shard_tree(params, param_pspecs(M.model_specs(cfg), rules_for(mesh), mesh), mesh)


def family_shard_decode_f32(cfg, params, seq, ctx, mesh):
    """Float32: SHARD_DECODE_CHECK teacher-forced decode steps of ``seq``'s
    columns on ``mesh`` against the unsharded steps, each from a zero cache
    and the raw context ``ctx`` encoded once its own way
    (``make_encode_step``); logits held where routing agreed (MoE)."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.serve.engine import (init_sharded_cache, make_encode_step,
                                          make_serve_step)

    n, b = SHARD_DECODE_CHECK, seq.shape[0]
    raw = next(iter(ctx.values()), None)
    runs = {}
    for label, m, p in (("sharded", mesh, sharded_params(cfg, params, mesh)),
                        ("unsharded", None, params)):
        cache = (init_sharded_cache(cfg, b, n, m) if m is not None
                 else M.init_cache(cfg, b, n, "cuda"))
        context = make_encode_step(cfg, m)(p, raw)
        step = make_serve_step(cfg, m)
        lgs = []
        with RouteLog() as rl:
            for pos in range(n):
                lg, cache = step(p, cache, seq[:, pos:pos + 1], pos, context)
                lgs.append(lg.full_tensor() if m is not None else lg)
        runs[label] = (torch.cat(lgs, dim=1),
                       rl.decode(b, n) if cfg.family == "moe" else None)
        del cache, context
    (got, rg), (want, rw) = runs["sharded"], runs["unsharded"]
    held = torch.ones((b, n), dtype=torch.bool, device="cuda")
    out = {}
    if cfg.family == "moe":
        out["decode_route_agreement"], held = route_agreement(rw, rg)
        out["decode_held_tokens"] = int(held.sum())
    excess = ((got - want).abs() / (DECODE_TOL + DECODE_TOL * want.abs())).amax(-1)
    out.update(decode_steps=n, decode_batch=b,
               decode_max_abs=float((got - want).abs().amax(-1)[held].max()),
               decode_over_tol=float(excess[held].max()), decode_tol=DECODE_TOL)
    return out


def family_shard_bf16(cfg, params, batch, raw, mesh, rng):
    """bf16 on ``mesh`` against the unsharded port, the same weights: the
    prefill step (``make_prefill_step``, ``"flash"``) of ``batch``, its
    ``flash_attention`` launches counted from 0 for each, the sharded
    last-position logits against the unsharded, then three timed prefills
    each way; and decode at batch SERVE_BATCH, SHARD_DECODE_PROMPT prompt
    and SHARD_DECODE_GEN new tokens from zero caches, the raw context
    ``raw`` encoded once each way, ms a step each way."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serve.engine import (init_sharded_cache, make_encode_step,
                                          make_serve_step)
    from repro_torch.train.step import TrainConfig, make_prefill_step

    sparams = sharded_params(cfg, params, mesh)
    tcfg = TrainConfig(attn_impl="flash")
    steps = {"unsharded": (make_prefill_step(cfg, tcfg), params),
             "sharded": (make_prefill_step(cfg, tcfg, mesh), sparams)}
    launches, last = {}, {}
    for label, (fn, p) in steps.items():
        torch.cuda.synchronize()
        ops.reset_launches()
        lg = fn(p, batch)
        torch.cuda.synchronize()
        launches[label] = dict(ops.LAUNCHES)
        last[label] = lg.full_tensor() if label == "sharded" else lg
    got, want = last["sharded"].float(), last["unsharded"].float()
    out = dict(prefill_batch=int(batch["tokens"].shape[0]), seq=int(batch["tokens"].shape[1]),
               prefill_launches=launches["sharded"],
               unsharded_prefill_launches=launches["unsharded"],
               prefill_finite=bool(torch.isfinite(got).all()),
               prefill_vs_unsharded_rel=float((got - want).abs().max())
               / float(want.abs().max()),
               prefill_bitwise=bool(torch.equal(last["sharded"], last["unsharded"])),
               prefill_tol=SHARD_PREFILL_TOL)
    del last, got, want
    walls = {}
    for label, (fn, p) in steps.items():
        ws = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(p, batch)
            torch.cuda.synchronize()
            ws.append(time.perf_counter() - t0)
        walls[label] = ws
    tokens = batch["tokens"].numel()
    out.update(prefill_walls_s=walls["sharded"], unsharded_prefill_walls_s=walls["unsharded"],
               prefill_tokens_per_s=tokens / sorted(walls["sharded"])[1],
               unsharded_prefill_tokens_per_s=tokens / sorted(walls["unsharded"])[1])

    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (SERVE_BATCH, SHARD_DECODE_PROMPT))
                               .astype(np.int32)).cuda()
    max_len = SHARD_DECODE_PROMPT + SHARD_DECODE_GEN
    dec = {}
    for label, m, p in (("sharded", mesh, sparams), ("unsharded", None, params)):
        def cache():
            return (init_sharded_cache(cfg, SERVE_BATCH, max_len, m) if m is not None
                    else M.init_cache(cfg, SERVE_BATCH, max_len, "cuda"))

        step = make_serve_step(cfg, m)
        context = make_encode_step(cfg, m)(p, raw)
        decode_run(step, p, cache(), prompts[:, :2], 2, context)       # warm
        c = cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = decode_run(step, p, c, prompts, SHARD_DECODE_GEN, context)
        torch.cuda.synchronize()
        dec[label] = (time.perf_counter() - t0, toks)
        del c, context
    dsteps = SHARD_DECODE_PROMPT + SHARD_DECODE_GEN - 1
    out.update(decode_steps=dsteps, serve_batch=SERVE_BATCH,
               ms_per_decode_step=dec["sharded"][0] / dsteps * 1e3,
               unsharded_ms_per_decode_step=dec["unsharded"][0] / dsteps * 1e3,
               decode_same_tokens=bool(torch.equal(dec["sharded"][1], dec["unsharded"][1])))
    del sparams, steps
    torch.cuda.empty_cache()
    return out


def shard_checks(phase: str, cfg, shard: dict, n_attn: int) -> None:
    """The limits of a family's sharded checks: the prefill's launches
    equal to the unsharded prefill's (one an attention layer), its
    last-position logits within SHARD_PREFILL_TOL of max|logits|; float32
    decode logits within DECODE_TOL (allclose)."""
    if "prefill_launches" in shard:
        pl, ul = shard["prefill_launches"], shard["unsharded_prefill_launches"]
        check(pl == ul and pl.get("flash_attention", 0) == n_attn
              and sum(pl.values()) == n_attn,
              f"{phase}.shard: the sharded prefill launched {pl}, the unsharded {ul}, "
              f"expected {n_attn} flash_attention")
        check(shard["prefill_finite"] and shard["prefill_vs_unsharded_rel"] <= SHARD_PREFILL_TOL,
              f"{phase}.shard: sharded prefill vs unsharded "
              f"{shard['prefill_vs_unsharded_rel']:.3e} of max|logits| > {SHARD_PREFILL_TOL} "
              "(or not finite)")
    if "decode_over_tol" in shard:
        check(shard["decode_over_tol"] <= 1.0,
              f"{phase}.shard: float32 sharded decode vs unsharded "
              f"{shard['decode_max_abs']:.3e} beyond {DECODE_TOL} (allclose)")
        if cfg.family == "moe":
            check(shard["decode_route_agreement"] >= 0.99,
                  f"{phase}.shard: routing agreed on fewer than 99% of (layer, token) sets")


def lm_family_phase(phase: str, arch: str, f32_layers, bf16_layers, seed: int,
                    mesh=None, card_line: str = ""):
    """One decoder family at full width from ``configs/``, random weights
    from ``seed``: the float32 checks, then the bf16 walls; depth cut only
    where memory forces it (listed under ``reduced``).  With ``mesh`` (the
    SHARD_FAMILIES, a (1, 1) NCCL mesh) each also runs its sharded checks
    on the same weights, emitted as ``{phase}.shard.{f32,bf16}`` and
    returned by dtype (``lm.shard.family`` reads them)."""
    from repro_torch import configs

    full = configs.get(arch)
    t0 = time.perf_counter()
    shards = {}
    for dtype, depth in (("float32", f32_layers), ("bfloat16", bf16_layers)):
        cfg = full.with_(dtype=dtype, n_layers=depth or full.n_layers)
        n_attn = flash_launches_a_forward(cfg)
        res = (family_f32_checks if dtype == "float32" else family_bf16_walls)(
            cfg, seed, mesh)
        shard = res.pop("shard", None)
        if shard is not None:
            shard.update(layers=cfg.n_layers, dtype=dtype)
            shards["f32" if dtype == "float32" else "bf16"] = shard
            emit(f"{phase}.shard.{'f32' if dtype == 'float32' else 'bf16'}", card=card_line,
                 arch=arch, family=cfg.family, mesh={"data": 1, "model": 1},
                 backend="nccl", **shard)
            shard_checks(phase, cfg, shard, n_attn)
        gib = full.param_count() * (4 if dtype == "float32" else 2) / 2**30
        why = ("the weights of the full depth and the phase's activations do not "
               "fit in 80 GB" if gib > 40 else
               "the script's time: the same code paths at a cut depth")
        res["reduced"] = ({"n_layers": [full.n_layers, cfg.n_layers],
                           "full_depth_weights_gib": gib, "why": why}
                          if depth else {})
        emit(f"{phase}.{'f32' if dtype == 'float32' else 'bf16'}", arch=arch,
             family=cfg.family, layers=cfg.n_layers, d_model=cfg.d_model,
             params=cfg.param_count(), attention_layers=n_attn,
             **{k: v for k, v in res.items() if k != "prefill_profile"})
        if dtype == "float32":
            check(res["flash_vs_dense_over_tol"] <= 1.0,
                  f"{phase}: f32 flash prefill vs dense {res['flash_vs_dense_max_abs']:.3e} "
                  f"beyond {ATTN_TOL['float32']}")
            check(res["decode_vs_prefill_over_tol"] <= 1.0,
                  f"{phase}: decode vs prefill {res['decode_vs_prefill_max_abs']:.3e} "
                  f"beyond {DECODE_TOL}")
            fwd = res["forward_launches"]
            check(fwd.get("flash_attention", 0) == n_attn and sum(fwd.values()) == n_attn,
                  f"{phase}: a forward launched {fwd}, expected {n_attn} flash_attention")
            check(sum(res["decode_launches"].values()) == 0,
                  f"{phase}: decode launched kernels")
            if cfg.family == "moe":
                check(min(res["prefill_route_agreement"], res["decode_route_agreement"]) >= 0.99,
                      f"{phase}: routing agreed on fewer than 99% of (layer, token) sets")
        else:
            emit(f"{phase}.bf16.prefill.profile", **res["prefill_profile"])
            pl = res["prefill_launches"]
            # the encoder runs once, when the server is built: whisper's
            # layers launch the kernel, the VLM's context is cast only
            n_enc = cfg.encoder_layers if cfg.family == "audio" else 0
            enc = res["encode_launches"]
            check(pl.get("flash_attention", 0) == n_attn and sum(pl.values()) == n_attn
                  and enc.get("flash_attention", 0) == n_enc and sum(enc.values()) == n_enc
                  and sum(res["generate_launches"].values()) == 0,
                  f"{phase}: the prefill launched {pl}, the encode {enc} and generate "
                  f"{res['generate_launches']}, expected {n_attn}, {n_enc} and 0 "
                  "flash_attention")
    emit(f"{phase}.done", phase_s=time.perf_counter() - t0)
    return shards


# ---------------------------------------------------------------- lm.train

#: the training configuration of (a): internlm2-1.8b whole in bf16, the
#: sequence length of ``train_4k`` (configs/shapes.py) with the global batch
#: cut from 256 to 8, two microbatches of 4
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 4096, 6
TRAIN_CFG = dict(attn_impl="chunked", ce_chunk=512, grad_accum=2, schedule="cosine",
                 peak_lr=3e-4, warmup=2, total_steps=8)
#: (b): the gradient checks' batch and the layer whose attention output the
#: planted fault detaches
GRAD_BATCH, GRAD_SEQ, FAULT_LAYER = 1, 512, 12
#: float32 gradients against float64, per leaf ‖g32 − g64‖ / ‖g64‖: float32
#: round-off through 24 layers and a 92,544-way softmax reads well under
#: this (about 1e-5 is expected)
GRAD_F32_TOL = 1e-3
#: the float64 central difference (L(p+εd) − L(p−εd)) / 2ε against ⟨∇L, d⟩,
#: d ~ N(0, 1) per element: its O(ε²) error read 9e-7 of the derivative on
#: internlm2's smoke config at ε = 1e-6 (CPU, float64), its round-off is
#: about 1e-16·L/ε
DIRECTIONAL_EPS, DIRECTIONAL_TOL = 1e-6, 1e-5
#: bf16 against float32 on the same bf16 weights: the loss and the gradient
#: norm, relative (bf16 rounds every activation to 2⁻⁸; the loss is a mean
#: over 511 tokens, the norm over 1.7 B gradients)
BF16_LOSS_TOL, BF16_GNORM_TOL = 1e-2, 5e-2
#: (c): (arch, layers; None: whole).  The training state is about 12 bytes
#: a parameter (bf16 weights and gradients, float32 m and v); depth is cut
#: where it would pass 40 GB: qwen3-moe 1 of 94 layers (3.11 B parameters
#: with the embedding), deepseek-v2-lite 5 of 27 (3.13 B), and
#: llama-3.2-vision one super-block of 5 of 100 (5.33 B, 64 GB: a
#: super-block is the least depth the config has)
TRAIN_FAMILIES = (("qwen3-moe-235b-a22b", 1), ("mamba2-2.7b", None),
                  ("zamba2-1.2b", None), ("deepseek-v2-lite-16b", 5),
                  ("llama-3.2-vision-90b", 5), ("whisper-small", None))
FAMILY_TRAIN_BATCH, FAMILY_TRAIN_SEQ = 4, 1024
#: (d): the steps of the crash, and the learning bar of the compressed run
#: (tests/test_fault_tolerance.py:107)
CRASH_AT, LEARN_BY = 100, 0.3


class Crash(Exception):
    """The planted interruption of the resumed example run."""


def tree_cast(tree, dtype):
    """A parameter tree cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: tree_cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def train_kernel_group(chain, kernel: str) -> str:
    """A device kernel's group in a train step: ``chain`` is the names of
    the host ranges that enclose its launch, outermost first (the profiler
    annotations ``optimizer``, ``CE`` and ``attention``, the ops, and in the
    backward the autograd node's ``evaluate_function``)."""
    names = " ".join(chain)
    if "optimizer" in chain:
        return "optimizer"
    if any(t in kernel for t in ("gemm", "nvjet", "cutlass", "xmma", "sm90_")):
        return "matrix products"
    if "CE" in chain or "LogsumexpBackward" in names or "GatherBackward" in names:
        return "CE (softmax, gold pick)"
    if ("attention" in chain or "SoftmaxBackward" in names
            or "MaskedFillBackward" in names or "DivBackward" in names):
        return "attention (scores' softmax, masks, scale)"
    return "elementwise (norms, rope, SiLU, residuals, casts, embedding)"


def chain_breakdown(trace_path: str, wall_s: float):
    """Device time by ``train_kernel_group`` from a chrome trace of
    ``torch.profiler``: each kernel joined to the op that launched it by its
    "External id", that op's enclosing host ranges found on its thread."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "user_annotation"):
            spans.setdefault(e.get("tid"), []).append(e)
    chains = {}
    for tid, evs in spans.items():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        stack = []
        for e in evs:
            while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) <= e["ts"]:
                stack.pop()
            stack.append(e)
            ext = e.get("args", {}).get("External id")
            if ext is not None:
                chains[ext] = [s["name"] for s in stack]
    kernels = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    groups, unjoined = {}, 0
    for k in kernels:
        chain = chains.get(k.get("args", {}).get("External id"))
        if chain is None:
            unjoined += 1
            chain = []
        g = train_kernel_group(chain, k["name"])
        groups[g] = groups.get(g, 0.0) + k.get("dur", 0) / 1e3
    busy = sum(groups.values())
    return dict(profiled_wall_ms=wall_s * 1e3, device_busy_ms=busy,
                idle_share=1 - busy / (wall_s * 1e3), n_kernels=len(kernels),
                unjoined_kernels=unjoined,
                groups_ms=dict(sorted(groups.items(), key=lambda kv: -kv[1])))


class TrainAnnotations:
    """While active, the train step's optimizer (compression, schedule and
    AdamW), chunked CE and attention cores run inside profiler ranges
    named ``optimizer``, ``CE`` and ``attention`` (in their rematerialised
    recomputes too)."""

    def __enter__(self):
        from torch.profiler import record_function

        from repro_torch.models import layers as TL
        from repro_torch.train import adamw
        from repro_torch.train import step as TS

        def wrap(fn, label):
            def inner(*a, **kw):
                with record_function(label):
                    return fn(*a, **kw)
            return inner

        self.saved = [(adamw, "update", adamw.update), (TS, "_ce_sum", TS._ce_sum),
                      (TL, "_dense_attention", TL._dense_attention)]
        adamw.update = wrap(adamw.update, "optimizer")
        TS._ce_sum = wrap(TS._ce_sum, "CE")
        TL._dense_attention = wrap(TL._dense_attention, "attention")
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def train_step_breakdown(step, state, batch):
    """One train step under ``torch.profiler`` (host ops and kernels) with
    ``TrainAnnotations``: device time by group, busy and idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(HERE, "build", "train_step_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.cuda.synchronize()
    with TrainAnnotations(), profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    out = chain_breakdown(path, wall)
    os.remove(path)
    return state, out


def train_state_bytes(params, grad_accum: int) -> dict:
    """The train state's bytes by part: the weights and one microbatch's
    gradients in their dtype, m and v in float32, and the float32 sums of
    the accumulation."""
    from repro_torch.train.adamw import tree_leaves

    leaves = tree_leaves(params)
    n = sum(p.numel() for p in leaves)
    w = sum(p.numel() * p.element_size() for p in leaves)
    out = {"parameters": n, "weights": w, "grads": w, "m": 4 * n, "v": 4 * n,
           "accum_sums": 4 * n if grad_accum > 1 else 0}
    out["total"] = sum(v for k, v in out.items() if k != "parameters")
    return out


def lm_train_full(seed: int):
    """(a) internlm2-1.8b whole in bf16, TRAIN_STEPS steps of B 8 × 4,096
    with two microbatches through ``TrainLoop``, the steps after the first
    under sync-debug "error"; a profiled warm step."""
    import torch

    from repro_torch import configs
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.train.adamw import tree_leaves
    from repro_torch.train.loop import LoopConfig, TrainLoop
    from repro_torch.train.step import TrainConfig, init_state, make_train_step

    cfg = configs.get(LM_ARCH)
    tcfg = TrainConfig(**TRAIN_CFG)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    state = init_state(cfg, tcfg, gen, "cuda")
    pipe = TokenPipeline(PipelineConfig(TRAIN_BATCH, TRAIN_SEQ, cfg.vocab, seed=seed), cfg,
                         device="cuda")
    train_step = make_train_step(cfg, tcfg)
    metrics = []
    # what a step takes: the state's tensors and one batch (the dry run's
    # argument bytes for this cell)
    arg_bytes = dict(state_arg_bytes=sum(t.numel() * t.element_size()
                                         for t in tree_leaves(state)),
                     batch_bytes=sum(t.numel() * t.element_size()
                                     for t in pipe.batch_at(0).values()))

    def step(s, b):
        s, met = train_step(s, b)
        metrics.append(met)
        if len(metrics) == 1:                 # the first step is cold
            torch.cuda.set_sync_debug_mode("error")
        return s, met

    loop = TrainLoop(step, pipe, LoopConfig(max_steps=TRAIN_STEPS, log_every=0),
                     log=lambda m: None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    try:
        state = loop.run(state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    walls = [r.wall for r in loop.records]
    warm = sorted(walls[1:])[len(walls[1:]) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    state, prof = train_step_breakdown(train_step, state, pipe.batch_at(TRAIN_STEPS))
    out = dict(arch=LM_ARCH, params=cfg.param_count(), layers=cfg.n_layers,
               batch=TRAIN_BATCH, seq=TRAIN_SEQ, train=TRAIN_CFG,
               reduced={"global_batch": [256, TRAIN_BATCH],
                        "why": "train_4k's batch of 256 sequences is a cluster's; one "
                               "card takes 8 in two microbatches of 4"},
               steps=len(walls), step_walls_s=walls, losses=loop.losses(),
               grad_norms=[float(m["grad_norm"]) for m in metrics],
               lrs=[float(m["lr"]) for m in metrics],
               median_warm_step_s=warm, tokens_per_step=tokens,
               train_tokens_per_s=tokens / warm, state_bytes=train_state_bytes(
                   state["params"], tcfg.grad_accum),
               peak_mem_gib=peak / 2**30, launches=launches, **arg_bytes,
               sync_debug="error after the first step; lifted only for the loss read",
               profile=prof)
    check(all(math.isfinite(x) for x in out["losses"] + out["grad_norms"]),
          f"lm.train: losses {out['losses']} or grad norms not finite")
    check(sum(launches.values()) == 0,
          f"lm.train: the train steps launched {launches}; no kernel has a backward")
    del state, loop
    torch.cuda.empty_cache()
    return out


class DetachAttention:
    """The planted fault of (b): the attention core's output of one layer
    detached on the autograd side (what a kernel result with no backward
    does), found by that layer's ``wq``."""

    def __init__(self, wq):
        self.ptr = wq.data_ptr()

    def __enter__(self):
        from repro_torch.models import layers as TL
        from repro_torch.models import model as M

        self.apply, self.core, hit = M.attn_apply, TL.attention_core, [False]

        def attn_apply(p, x, cfg, **kw):
            hit[0] = p["wq"].data_ptr() == self.ptr
            return self.apply(p, x, cfg, **kw)

        def attention_core(q, k, v, **kw):
            o = self.core(q, k, v, **kw)
            return o.detach() if hit[0] else o

        M.attn_apply, TL.attention_core = attn_apply, attention_core
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers as TL
        from repro_torch.models import model as M

        M.attn_apply, TL.attention_core = self.apply, self.core


def loss_and_grads(params, batch, cfg, tcfg):
    """The train step's loss and gradient leaves (its ``_loss_fn`` under
    autograd) for a parameter tree that does not otherwise require grad."""
    import torch

    from repro_torch.train.adamw import tree_leaves
    from repro_torch.train.step import _loss_fn

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, _ = _loss_fn(params, batch, cfg, tcfg)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), list(grads)


def directional(params, direction, batch, cfg, tcfg, eps: float) -> float:
    """(L(p + εd) − L(p − εd)) / 2ε, the parameters restored after."""
    import torch

    from repro_torch.train.adamw import tree_leaves
    from repro_torch.train.step import _loss_fn

    leaves = tree_leaves(params)
    with torch.no_grad():
        for p, d in zip(leaves, direction):
            p.add_(d.to(p.dtype), alpha=eps)
        up = _loss_fn(params, batch, cfg, tcfg)[0]
        for p, d in zip(leaves, direction):
            p.add_(d.to(p.dtype), alpha=-2 * eps)
        down = _loss_fn(params, batch, cfg, tcfg)[0]
        for p, d in zip(leaves, direction):
            p.add_(d.to(p.dtype), alpha=eps)
    return float((up - down) / (2 * eps))


def random_direction(params, seed: int):
    """d ~ N(0, 1) per element, float32, from ``seed``."""
    import torch

    from repro_torch.train.adamw import tree_leaves

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return [torch.randn(p.shape, generator=gen, dtype=torch.float32, device="cuda")
            for p in tree_leaves(params)]


def directional_check(params64, batch, cfg64, tcfg, seed: int, fault_wq=None):
    """⟨∇L, d⟩ by autograd in float64 against the central difference;
    with ``fault_wq`` also the readings of the planted detach: its
    ⟨∇L, d⟩ against the central difference, and its largest per-leaf
    ‖g − g64‖ / ‖g64‖."""
    direction = random_direction(params64, seed)
    _, g = loss_and_grads(params64, batch, cfg64, tcfg)
    dot = float(sum((gi * di.to(gi.dtype)).sum() for gi, di in zip(g, direction)))
    fd = directional(params64, direction, batch, cfg64, tcfg, DIRECTIONAL_EPS)
    out = dict(eps=DIRECTIONAL_EPS, autograd=dot, central_difference=fd,
               rel=abs(dot - fd) / abs(fd), tol=DIRECTIONAL_TOL)
    if fault_wq is not None:
        with DetachAttention(fault_wq):
            _, gf = loss_and_grads(params64, batch, cfg64, tcfg)
        fdot = float(sum((gi * di.to(gi.dtype)).sum() for gi, di in zip(gf, direction)))
        out["planted_fault_rel"] = abs(fdot - fd) / abs(fd)
        out["planted_fault_leaf_rel_max"] = max(
            float((a - b).norm() / b.norm()) for a, b in zip(gf, g) if float(b.norm()) > 0)
        del gf
    return out, g


def lm_train_grad_checks(seed: int):
    """(b) at full width and depth on (a)'s weights, TF32 off, B 1 × 512:
    float32 gradients against float64, the float64 directional derivative,
    bf16 against float32, and the planted detach."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.train.adamw import global_norm
    from repro_torch.train.step import TrainConfig

    cfg = configs.get(LM_ARCH)
    tcfg = TrainConfig(attn_impl="chunked", ce_chunk=512)
    rng = np.random.default_rng(seed + 7)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (GRAD_BATCH, GRAD_SEQ))
                                        .astype(np.int32)).cuda()}
    bf16 = lm_params(cfg, seed)
    l16, g16 = loss_and_grads(bf16, batch, cfg, tcfg)
    n16 = float(global_norm(g16))
    del g16
    p32 = tree_cast(bf16, torch.float32)
    del bf16
    l32, g32 = loss_and_grads(p32, batch, cfg.with_(dtype="float32"), tcfg)
    n32 = float(global_norm(g32))
    p64 = tree_cast(p32, torch.float64)
    del p32
    torch.cuda.empty_cache()
    wq = M.layer(p64["layers"], FAULT_LAYER)["attn"]["wq"]
    d, g64 = directional_check(p64, batch, cfg.with_(dtype="float64"), tcfg, seed + 11,
                               fault_wq=wq)
    leaf_rel = [float((a.double() - b).norm() / b.norm()) for a, b in zip(g32, g64)]
    out = dict(arch=LM_ARCH, batch=GRAD_BATCH, seq=GRAD_SEQ, remat=cfg.remat,
               attn_impl=tcfg.attn_impl, ce_chunk=tcfg.ce_chunk, tf32=False,
               f32_vs_f64_leaf_rel=leaf_rel, f32_vs_f64_tol=GRAD_F32_TOL,
               directional=d, fault_layer=FAULT_LAYER,
               bf16_loss=float(l16), f32_loss=float(l32), bf16_grad_norm=n16,
               f32_grad_norm=n32, bf16_vs_f32_loss_rel=abs(float(l16) - float(l32)) / abs(float(l32)),
               bf16_vs_f32_grad_norm_rel=abs(n16 - n32) / n32,
               bf16_tols=dict(loss=BF16_LOSS_TOL, grad_norm=BF16_GNORM_TOL))
    del p64, g64, g32
    torch.cuda.empty_cache()
    check(max(leaf_rel) <= GRAD_F32_TOL,
          f"lm.train.grads: float32 gradients {max(leaf_rel):.3e} off float64")
    check(d["rel"] <= DIRECTIONAL_TOL,
          f"lm.train.grads: ⟨∇L, d⟩ {d['autograd']} against the central difference "
          f"{d['central_difference']}: {d['rel']:.3e}")
    check(d["planted_fault_rel"] > DIRECTIONAL_TOL and d["planted_fault_leaf_rel_max"] > GRAD_F32_TOL,
          f"lm.train.grads: the planted detach reads {d['planted_fault_rel']:.3e} and "
          f"{d['planted_fault_leaf_rel_max']:.3e}, within the limits")
    check(out["bf16_vs_f32_loss_rel"] <= BF16_LOSS_TOL
          and out["bf16_vs_f32_grad_norm_rel"] <= BF16_GNORM_TOL,
          f"lm.train.grads: bf16 against float32: loss {out['bf16_vs_f32_loss_rel']:.3e}, "
          f"grad norm {out['bf16_vs_f32_grad_norm_rel']:.3e}")
    return out


def lm_train_families(seed: int, card_line: str = "", shard_results=None):
    """(c) two bf16 steps of each other family at full width (depth cut
    where the state passes 40 GB), then the float64 directional derivative
    on its smoke config.  For the SHARD_FAMILIES, the first step again on a
    (1, 1) NCCL mesh from the same initial state (drawn again from the
    seed), held against the unsharded first step, and the family's
    ``lm.shard.family`` line with its phase's sharded results
    (``shard_results``, by arch)."""
    with one_rank_mesh() as mesh:
        return [lm_train_family(arch, depth, seed, mesh, card_line,
                                (shard_results or {}).get(arch, {}))
                for arch, depth in TRAIN_FAMILIES]


def lm_train_family(arch: str, depth, seed: int, mesh, card_line: str, shard: dict):
    """One family of ``lm_train_families``; ``shard`` its phase's sharded
    results."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.kernels import ops
    from repro_torch.train.step import (TrainConfig, init_state, make_train_step,
                                        state_pspecs)

    full = configs.get(arch)
    cfg = full.with_(n_layers=depth or full.n_layers)
    seq = AUDIO_TEXT_CTX if cfg.family == "audio" else FAMILY_TRAIN_SEQ
    tcfg = TrainConfig(attn_impl="chunked", ce_chunk=512, peak_lr=3e-4, warmup=2,
                       total_steps=8)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    state = init_state(cfg, tcfg, gen, "cuda")
    pipe = TokenPipeline(PipelineConfig(FAMILY_TRAIN_BATCH, seq, cfg.vocab, seed=seed),
                         cfg, device="cuda")
    step = make_train_step(cfg, tcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    walls, mets = [], []
    for i in range(2):
        batch = pipe.batch_at(i)
        t0 = time.perf_counter()
        state, met = step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        mets.append(met)
    sb = train_state_bytes(state["params"], 1)
    row = dict(arch=arch, family=cfg.family, layers=cfg.n_layers, d_model=cfg.d_model,
               batch=FAMILY_TRAIN_BATCH, seq=seq, step_walls_s=walls,
               losses=[float(m["loss"]) for m in mets],
               grad_norms=[float(m["grad_norm"]) for m in mets],
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               state_gb=sb["total"] / 1e9, launches=dict(ops.LAUNCHES),
               reduced=({"n_layers": [full.n_layers, cfg.n_layers],
                         "why": "the training state (12 bytes a parameter) of the "
                                "whole depth passes 40 GB"} if depth else {}))
    if cfg.family == "audio":
        row["frames"] = cfg.encoder_frames
    if cfg.family == "vlm":
        row["vision_tokens"] = cfg.vision_tokens
    del state
    torch.cuda.empty_cache()
    if arch in SHARD_FAMILIES:
        gen.manual_seed(seed)
        state = shard_tree(init_state(cfg, tcfg, gen, "cuda"),
                           state_pspecs(cfg, tcfg, mesh), mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        state, met = make_train_step(cfg, tcfg, mesh)(state, pipe.batch_at(0))
        torch.cuda.synchronize()
        row["shard"] = dict(
            first_step_loss=float(met["loss"]), unsharded_first_step_loss=row["losses"][0],
            first_step_grad_norm=float(met["grad_norm"]),
            unsharded_first_step_grad_norm=row["grad_norms"][0],
            first_step_s=time.perf_counter() - t0, unsharded_first_step_s=walls[0],
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
            unsharded_peak_mem_gib=row["peak_mem_gib"], launches=dict(ops.LAUNCHES),
            tol=dict(loss=SHARD_LOSS_TOL, grad_norm_rel=SHARD_GNORM_TOL))
        del state
        torch.cuda.empty_cache()
    del pipe
    smoke = configs.get_smoke(arch).with_(dtype="float64", remat=True)
    p64 = lm_params(smoke, seed)
    rng = np.random.default_rng(seed)
    sb = {"tokens": torch.from_numpy(rng.integers(0, smoke.vocab, (2, 16))
                                     .astype(np.int32)).cuda(),
          **{k: v.double() for k, v in family_context(smoke, 2, rng).items()}}
    row["smoke_directional"], _ = directional_check(
        p64, sb, smoke, TrainConfig(attn_impl="chunked", ce_chunk=5), seed + 13)
    emit("lm.train.family", **{k: v for k, v in row.items() if k != "shard"})
    check(all(math.isfinite(x) for x in row["losses"] + row["grad_norms"]),
          f"lm.train.family: {arch}: losses {row['losses']} or grad norms not finite")
    check(sum(row["launches"].values()) == 0,
          f"lm.train.family: {arch}: the steps launched {row['launches']}")
    check(row["smoke_directional"]["rel"] <= DIRECTIONAL_TOL,
          f"lm.train.family: {arch}: smoke directional derivative "
          f"{row['smoke_directional']['rel']:.3e} beyond {DIRECTIONAL_TOL}")
    if "shard" in row:
        sh = row["shard"]
        emit("lm.shard.family", card=card_line, arch=arch, family=cfg.family,
             mesh={"data": 1, "model": 1}, backend="nccl",
             train=dict(sh, layers=cfg.n_layers, batch=FAMILY_TRAIN_BATCH, seq=seq),
             **shard)
        check(sum(sh["launches"].values()) == 0,
              f"lm.shard.family: {arch}: the sharded train step launched {sh['launches']}")
        check(abs(sh["first_step_loss"] - sh["unsharded_first_step_loss"]) <= SHARD_LOSS_TOL
              and abs(sh["first_step_grad_norm"] - sh["unsharded_first_step_grad_norm"])
              <= SHARD_GNORM_TOL * sh["unsharded_first_step_grad_norm"],
              f"lm.shard.family: {arch}: first step loss {sh['first_step_loss']} / "
              f"{sh['unsharded_first_step_loss']}, grad norm {sh['first_step_grad_norm']} / "
              f"{sh['unsharded_first_step_grad_norm']} (sharded / unsharded)")
        check(set(shard) == {"f32", "bf16"},
              f"lm.shard.family: {arch}: its phase ran no sharded prefill or decode")
    return row


def lm_train_examples():
    """(d) ``examples/torch_train_lm.py`` at its default size, again as a
    run "crashed" after CRASH_AT steps and resumed, both against the
    straight run; ``launch/train.py --smoke --compress-grads`` for 30 steps;
    ``examples/torch_serve_lm.py`` once."""
    import runpy
    import shutil
    import warnings

    import torch

    from repro_torch.launch import train as train_launch
    from repro_torch.train.adamw import tree_leaves

    example = runpy.run_path(os.path.join(HERE, "examples", "torch_train_lm.py"),
                             run_name="torch_example")["main"]
    dirs = [os.path.join(HERE, "build", f"train_lm_{n}") for n in ("straight", "crash")]
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)
    out = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            t0 = time.perf_counter()
            straight = example(["--device", "cuda", "--ckpt-dir", dirs[0]])
            out["straight_s"] = time.perf_counter() - t0
            real = train_launch.make_train_step

            def crashing(cfg, tcfg):
                step, n = real(cfg, tcfg), [0]

                def run(state, batch):
                    n[0] += 1
                    if n[0] > CRASH_AT:
                        raise Crash(f"step {CRASH_AT}")
                    return step(state, batch)
                return run

            train_launch.make_train_step = crashing
            try:
                example(["--device", "cuda", "--ckpt-dir", dirs[1]])
            except Crash:
                pass
            finally:
                train_launch.make_train_step = real
            resumed = example(["--device", "cuda", "--ckpt-dir", dirs[1]])
        finally:
            torch.use_deterministic_algorithms(False)
    nondet = sorted({str(w.message)[:160] for w in caught
                     if "deterministic" in str(w.message).lower()})
    tail = straight.losses()[CRASH_AT:]
    bitwise = (resumed.losses() == tail and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(straight.state),
                                          tree_leaves(resumed.state))))
    close = all(abs(a - b) <= 1e-6 + 1e-5 * abs(b) for a, b in zip(resumed.losses(), tail))
    out.update(steps=len(straight.losses()), first_loss=straight.losses()[0],
               last_loss=straight.losses()[-1], params=sum(
                   p.numel() for p in tree_leaves(straight.state["params"])),
               resumed_from=resumed.records[0].step if resumed.records else None,
               resumed_bitwise=bitwise, resumed_within_1e5=close,
               nondeterministic_ops=nondet)
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)
    check(out["resumed_from"] == CRASH_AT and len(resumed.losses()) == len(tail),
          f"lm.train.examples: resumed at {out['resumed_from']}, not {CRASH_AT}")
    check(bitwise or (close and nondet),
          f"lm.train.examples: the resumed run differs from the straight one "
          f"(bitwise {bitwise}, within 1e-5 {close}, nondeterministic ops {nondet})")

    loop = train_launch.main(["--arch", LM_ARCH, "--smoke", "--steps", "30",
                              "--compress-grads", "--device", "cuda"])
    out["compressed_losses"] = [loop.losses()[0], loop.losses()[-1]]
    check(loop.losses()[-1] < loop.losses()[0] - LEARN_BY,
          f"lm.train.examples: compressed training fell {out['compressed_losses']}, "
          f"not by {LEARN_BY}")
    t0 = time.perf_counter()
    served = runpy.run_path(os.path.join(HERE, "examples", "torch_serve_lm.py"),
                            run_name="torch_example")["main"](["--device", "cuda"])
    out["serve_s"] = time.perf_counter() - t0
    out["served_shape"] = list(served.shape)
    return out


def lm_train_phase(seed: int, shard_results=None):
    """(a)-(d) of training on the card; every line carries the card;
    ``shard_results`` the families' sharded results by arch, for (c).
    Returns (a)'s tokens/s and peak memory (``lm.shard`` stands beside
    them)."""
    import torch

    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    full = lm_train_full(seed)
    prof = full.pop("profile")
    emit("lm.train", card=smi, **full)
    emit("lm.train.profile", card=smi, **prof)
    emit("lm.train.grads", card=smi, **lm_train_grad_checks(seed))
    lm_train_families(seed, smi, shard_results)
    torch.cuda.empty_cache()
    emit("lm.train.examples", card=smi, **lm_train_examples())
    emit("lm.train.done", card=smi, phase_s=time.perf_counter() - t0)
    return {k: full[k] for k in ("train_tokens_per_s", "peak_mem_gib",
                                 "state_arg_bytes", "batch_bytes")}


# ------------------------------------------------------------- lm.shard

#: lm.shard: train steps after the cold one; the float32 checks' depth at
#: full width, their batch, and a learning rate that moves the params on
#: the first step (warmup 0); decode steps held against the unsharded ones
SHARD_WARM_STEPS = 3
SHARD_F32_LAYERS = 4
SHARD_F32_BATCH, SHARD_F32_SEQ = 2, 1024
SHARD_F32_TRAIN = dict(attn_impl="chunked", ce_chunk=512, peak_lr=1e-2, warmup=0,
                       total_steps=10)
SHARD_DECODE_CHECK = 16
#: sharded against unsharded in the same run: the loss and the params after
#: a step as tests/test_distributed.py:86-90 holds them (1e-3, 5e-3); the
#: bf16 gradient norm relative (its leaves round to bf16); the bf16
#: prefill's last-position logits relative to their max (bf16's 2⁻⁷)
SHARD_LOSS_TOL, SHARD_PARAM_TOL, SHARD_GNORM_TOL, SHARD_PREFILL_TOL = 1e-3, 5e-3, 1e-2, 1e-2


def decode_run(step, params, cache, prompts, n_new: int, context=None):
    """``BatchedServer.generate``'s loop over a serve step: each prompt
    teacher-forced, then ``n_new`` greedy tokens; (B, P + n_new) on the
    card; ``context`` the encoded context of a VLM or audio batch.  Sharded
    logits are read whole."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.serve.engine import greedy

    plen = prompts.shape[1]
    toks = prompts[:, :1]
    out = [toks]
    for pos in range(plen + n_new - 1):
        lg, cache = step(params, cache, toks, pos, context)
        if isinstance(lg, DTensor):
            lg = lg.full_tensor()
        toks = prompts[:, pos + 1:pos + 2] if pos + 1 < plen else greedy(lg)
        out.append(toks)
    return torch.cat(out, dim=1)


def restore_state(state, params0) -> None:
    """A train state back to its initial values: the params copied from
    ``params0``, moments and step zeroed (``init_state``'s)."""
    from repro_torch.train.adamw import tree_leaves

    for p, q in zip(tree_leaves(state["params"]), params0):
        p.copy_(q)
    for t in tree_leaves(state["m"]) + tree_leaves(state["v"]):
        t.zero_()
    state["step"].zero_()


def lm_shard_phase(seed: int, card_line: str, train_ref=None):
    """internlm2-1.8b on a ("data", "model") mesh of (1, 1) over NCCL at
    world size 1 (``distributed/sharding.py``: every placement, constraint
    and collective of the sharded path, on the card), against the
    unsharded port in the same run: (a) the bf16 prefill at B 4 × 4,096
    with ``"flash"`` (24 kernel launches on the local heads), its
    last-position logits and tokens/s; (b) bf16 decode, batch 8,
    SHARD_DECODE_PROMPT prompt and SHARD_DECODE_GEN new tokens, ms a step; (c) training at lm.train's B 8 × 4,096 in two
    microbatches: the first step's loss and grad norm from the unsharded
    step's state, then SHARD_WARM_STEPS warm steps under sync-debug
    "error", tokens/s and peak memory beside lm.train's (``train_ref``);
    (d) float32 at SHARD_F32_LAYERS layers of full width: the params after
    one step, and SHARD_DECODE_CHECK decode steps' logits."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serve.engine import init_sharded_cache, make_serve_step
    from repro_torch.train.adamw import tree_leaves
    from repro_torch.train.loop import LoopConfig, TrainLoop
    from repro_torch.train.step import (TrainConfig, init_state, make_prefill_step,
                                        make_train_step, state_pspecs)

    t_phase = time.perf_counter()
    with one_rank_mesh() as mesh:
        cfg = configs.get(LM_ARCH)

        # (a) the sharded prefill, counters zeroed just before it
        params = lm_params(cfg, seed)
        sparams = sharded_params(cfg, params, mesh)
        rng = np.random.default_rng(seed + 5)
        batch = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab, (LM_BF16_BATCH, LM_SEQ))).cuda()}
        tcfg = TrainConfig(attn_impl="flash")
        steps = {"sharded": (make_prefill_step(cfg, tcfg, mesh), sparams),
                 "unsharded": (make_prefill_step(cfg, tcfg), params)}
        torch.cuda.synchronize()
        ops.reset_launches()
        got = steps["sharded"][0](sparams, batch)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        local_heads = list(got.placements), tuple(got.to_local().shape)
        got = got.full_tensor()
        want = steps["unsharded"][0](params, batch)
        prefill_rel = float((got.float() - want.float()).abs().max()) / float(
            want.float().abs().max())
        prefill_bitwise = bool(torch.equal(got, want))
        finite = bool(torch.isfinite(got).all())
        del got, want
        walls = {}
        for label, (fn, p) in steps.items():
            fn(p, batch)                                    # warm
            ws = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(p, batch)
                torch.cuda.synchronize()
                ws.append(time.perf_counter() - t0)
            walls[label] = ws
        tokens = LM_BF16_BATCH * LM_SEQ

        # (b) bf16 decode: batch 8, 64 new tokens after a 64-token prompt
        prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT))).cuda()
        max_len = SHARD_DECODE_PROMPT + SHARD_DECODE_GEN
        dec = {}
        for label, step, p, cache in (
                ("sharded", make_serve_step(cfg, mesh), sparams,
                 init_sharded_cache(cfg, SERVE_BATCH, max_len, mesh)),
                ("unsharded", make_serve_step(cfg), params,
                 M.init_cache(cfg, SERVE_BATCH, max_len, "cuda"))):
            decode_run(step, p, cache, prompts[:, :2], 2)   # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = decode_run(step, p, cache, prompts[:, :SHARD_DECODE_PROMPT],
                              SHARD_DECODE_GEN)
            torch.cuda.synchronize()
            dec[label] = (time.perf_counter() - t0, toks)
        dsteps = SHARD_DECODE_PROMPT + SHARD_DECODE_GEN - 1
        dec_ms = {label: w / dsteps * 1e3 for label, (w, _) in dec.items()}
        same_tokens = bool(torch.equal(dec["sharded"][1], dec["unsharded"][1]))
        del params, sparams, steps, dec
        torch.cuda.empty_cache()

        # (c) training: the first step from one state both ways, then warm
        tcfg = TrainConfig(**TRAIN_CFG)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        state = init_state(cfg, tcfg, gen, "cuda")
        params0 = [p.clone() for p in tree_leaves(state["params"])]
        pipe = TokenPipeline(PipelineConfig(TRAIN_BATCH, TRAIN_SEQ, cfg.vocab, seed=seed),
                             cfg, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met_u = make_train_step(cfg, tcfg)(state, pipe.batch_at(0))
        met_u = {k: float(v) for k, v in met_u.items()}
        unsharded_step_s = time.perf_counter() - t0
        restore_state(state, params0)
        del params0
        sstate = shard_tree(state, state_pspecs(cfg, tcfg, mesh), mesh)
        del state
        sstep = make_train_step(cfg, tcfg, mesh)
        metrics = []

        def step(s, b):
            s, met = sstep(s, b)
            metrics.append(met)
            if len(metrics) == 1:                 # the first step is cold
                torch.cuda.set_sync_debug_mode("error")
            return s, met

        loop = TrainLoop(step, pipe, LoopConfig(max_steps=1 + SHARD_WARM_STEPS,
                                                log_every=0), log=lambda m: None)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        try:
            sstate = loop.run(sstate)
        except RuntimeError as e:
            raise CheckFailed(f"lm.shard: a sharded train step failed or "
                              f"synchronised: {e}") from e
        finally:
            torch.cuda.set_sync_debug_mode(0)
        train_launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        train_walls = [r.wall for r in loop.records]
        warm = sorted(train_walls[1:])[len(train_walls[1:]) // 2]
        met_s = {k: float(v) for k, v in metrics[0].items()}
        losses = loop.losses()
        placements = sorted({repr(tuple(t.placements)) for t in tree_leaves(sstate)})
        del sstate, loop, metrics
        torch.cuda.empty_cache()

        # (d) float32 at SHARD_F32_LAYERS layers of full width: the params
        # after one step from one state both ways, then decode
        cfg4 = cfg.with_(n_layers=SHARD_F32_LAYERS, dtype="float32")
        tcfg4 = TrainConfig(**SHARD_F32_TRAIN)
        gen.manual_seed(seed + 3)
        st = init_state(cfg4, tcfg4, gen, "cuda")
        params0 = [p.clone() for p in tree_leaves(st["params"])]
        pipe4 = TokenPipeline(PipelineConfig(SHARD_F32_BATCH, SHARD_F32_SEQ, cfg.vocab,
                                             seed=seed + 3), cfg4, device="cuda")
        b4 = pipe4.batch_at(0)
        st, m4u = make_train_step(cfg4, tcfg4)(st, b4)
        after_u = [p.clone() for p in tree_leaves(st["params"])]
        f32_moved = max(float((p - q).abs().max()) for p, q in zip(after_u, params0))
        restore_state(st, params0)
        del params0
        sst = shard_tree(st, state_pspecs(cfg4, tcfg4, mesh), mesh)
        sst, m4s = make_train_step(cfg4, tcfg4, mesh)(sst, b4)
        f32_param_err = max(float((p.full_tensor() - q).abs().max())
                            for p, q in zip(tree_leaves(sst["params"]), after_u))
        del after_u
        f32_loss = (float(m4u["loss"]), float(m4s["loss"]))
        f32_gnorm = (float(m4u["grad_norm"]), float(m4s["grad_norm"]))
        cache_u = M.init_cache(cfg4, SERVE_BATCH, SHARD_DECODE_CHECK, "cuda")
        cache_s = init_sharded_cache(cfg4, SERVE_BATCH, SHARD_DECODE_CHECK, mesh)
        su, ss = make_serve_step(cfg4), make_serve_step(cfg4, mesh)
        decode_excess = decode_err = 0.0
        for pos in range(SHARD_DECODE_CHECK):
            tk = prompts[:, pos:pos + 1]
            lu, cache_u = su(st["params"], cache_u, tk, pos)
            ls, cache_s = ss(sst["params"], cache_s, tk, pos)
            ls = ls.full_tensor()
            decode_excess = max(decode_excess, allclose_excess(ls, lu, DECODE_TOL))
            decode_err = max(decode_err, float((ls - lu).abs().max()))
        del st, sst, cache_u, cache_s
    torch.cuda.empty_cache()

    ref = train_ref or {}
    train_tokens = TRAIN_BATCH * TRAIN_SEQ
    emit("lm.shard", card=card_line, arch=LM_ARCH, world_size=1, backend="nccl",
         mesh={"data": 1, "model": 1}, layers=cfg.n_layers,
         prefill_batch=LM_BF16_BATCH, seq=LM_SEQ, prefill_launches=launches,
         prefill_logits_placements=[repr(p) for p in local_heads[0]],
         prefill_local_logits_shape=local_heads[1],
         prefill_vs_unsharded_rel=prefill_rel, prefill_bitwise=prefill_bitwise,
         prefill_tol=SHARD_PREFILL_TOL, prefill_walls_s=walls["sharded"],
         unsharded_prefill_walls_s=walls["unsharded"],
         prefill_tokens_per_s=tokens / sorted(walls["sharded"])[1],
         unsharded_prefill_tokens_per_s=tokens / sorted(walls["unsharded"])[1],
         decode_steps=dsteps, ms_per_decode_step=dec_ms["sharded"],
         unsharded_ms_per_decode_step=dec_ms["unsharded"],
         decode_same_tokens=same_tokens,
         serve=dict(batch=SERVE_BATCH, prompt=SHARD_DECODE_PROMPT, gen=SHARD_DECODE_GEN),
         train=TRAIN_CFG, train_batch=TRAIN_BATCH, train_seq=TRAIN_SEQ,
         first_step_loss=met_s["loss"], unsharded_first_step_loss=met_u["loss"],
         first_step_grad_norm=met_s["grad_norm"],
         unsharded_first_step_grad_norm=met_u["grad_norm"],
         unsharded_first_step_s=unsharded_step_s, step_walls_s=train_walls,
         losses=losses, median_warm_step_s=warm,
         train_tokens_per_s=train_tokens / warm,
         lm_train_tokens_per_s=ref.get("train_tokens_per_s"),
         peak_mem_gib=peak, lm_train_peak_mem_gib=ref.get("peak_mem_gib"),
         train_launches=train_launches, state_placements=placements,
         sync_debug="error after the first step; lifted only for the loss read",
         f32_layers=SHARD_F32_LAYERS, f32_batch=SHARD_F32_BATCH, f32_seq=SHARD_F32_SEQ,
         f32_train=SHARD_F32_TRAIN, f32_params_moved=f32_moved,
         f32_param_err=f32_param_err, f32_loss=f32_loss, f32_grad_norm=f32_gnorm,
         f32_decode_steps=SHARD_DECODE_CHECK, f32_decode_max_abs=decode_err,
         f32_decode_over_tol=decode_excess, decode_tol=DECODE_TOL,
         tol=dict(loss=SHARD_LOSS_TOL, params=SHARD_PARAM_TOL,
                  grad_norm_rel=SHARD_GNORM_TOL),
         phase_s=time.perf_counter() - t_phase)
    check(launches["flash_attention"] == cfg.n_layers and sum(launches.values()) == cfg.n_layers,
          f"lm.shard: the sharded prefill launched {launches}, expected "
          f"{cfg.n_layers} flash_attention")
    check(finite and prefill_rel <= SHARD_PREFILL_TOL,
          f"lm.shard: sharded prefill vs unsharded {prefill_rel:.3e} of max|logits| "
          f"> {SHARD_PREFILL_TOL} (or not finite)")
    check(all(math.isfinite(x) for x in losses),
          f"lm.shard: sharded train losses {losses}")
    check(abs(met_s["loss"] - met_u["loss"]) <= SHARD_LOSS_TOL
          and abs(met_s["grad_norm"] - met_u["grad_norm"])
          <= SHARD_GNORM_TOL * met_u["grad_norm"],
          f"lm.shard: first step loss {met_s['loss']} / {met_u['loss']}, grad norm "
          f"{met_s['grad_norm']} / {met_u['grad_norm']} (sharded / unsharded)")
    check(sum(train_launches.values()) == 0,
          f"lm.shard: the train steps launched {train_launches}")
    check(f32_moved > SHARD_PARAM_TOL and f32_param_err <= SHARD_PARAM_TOL
          and abs(f32_loss[0] - f32_loss[1]) <= SHARD_LOSS_TOL,
          f"lm.shard: float32 params after a step {f32_param_err:.3e} (moved "
          f"{f32_moved:.3e}), loss {f32_loss}")
    check(decode_excess <= 1.0, f"lm.shard: float32 sharded decode vs unsharded "
          f"{decode_err:.3e} beyond {DECODE_TOL} (allclose)")
    return launches



# ------------------------------------------------------------- dryrun

#: the dry run's command line on the card: whisper-small's decode_32k on the
#: (16, 16) and (2, 16, 16) meshes (256 and 512 fake ranks, fake CUDA
#: tensors), which must give two traced records
DRYRUN_CLI = ("--arch", "whisper-small", "--shape", "decode_32k", "--mesh", "both")
#: lm.train's cell traced at world size 1 on a (1, 1) mesh: internlm2-1.8b
#: whole, bf16, B 8 × 4,096 in two microbatches, chunked attention (TRAIN_CFG)
DRYRUN_TRAIN = """
import json, sys
from repro_torch import configs
from repro_torch.configs.shapes import SHAPES
from repro_torch.kernels import ops
from repro_torch.launch import dryrun as D
from repro_torch.train.step import TrainConfig
import dataclasses
batch, seq, train = json.loads(sys.argv[1])
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=seq, global_batch=batch)
before = dict(ops.LAUNCHES)
rec = D.trace_cell(configs.get(sys.argv[2]), shape, {"data": 1, "model": 1},
                   tcfg=TrainConfig(**train), device="cuda")
rec["launches_unchanged"] = dict(ops.LAUNCHES) == before
print(json.dumps(rec))
"""


def dryrun_phase(card_line: str, train_ref=None):
    """The multi-pod dry run (``launch/dryrun.py``) on the card's torch, each
    part a process of its own (a dry run starts its own fake process group)
    and both at once: (a) the command line on DRYRUN_CLI, two ``traced``
    records; (b) lm.train's cell traced at world size 1, whose argument
    bytes must equal the state and batch bytes lm.train measured in this
    run (``train_ref``), its traced peak printed beside lm.train's measured
    peak as a ratio.  Nothing here allocates on the card or launches a
    kernel."""
    t0 = time.perf_counter()
    out_dir = os.path.join(HERE, "build", "dryrun_smoke")
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    cli = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun",
                            *DRYRUN_CLI, "--out", out_dir], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    train = subprocess.Popen(
        [sys.executable, "-c", DRYRUN_TRAIN,
         json.dumps([TRAIN_BATCH, TRAIN_SEQ, TRAIN_CFG]), LM_ARCH], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        cli_out, cli_err = cli.communicate(timeout=600)
        train_out, train_err = train.communicate(timeout=600)
    finally:
        for p in (cli, train):
            if p.poll() is None:
                p.kill()
                p.communicate()
    check(cli.returncode == 0, f"dryrun: the command line exited {cli.returncode}:\n"
          f"{cli_out[-2000:]}\n{cli_err[-4000:]}")
    check(train.returncode == 0, f"dryrun: lm.train's cell exited {train.returncode}:\n"
          f"{train_err[-4000:]}")
    records = {}
    for tag in ("single", "multi"):
        with open(os.path.join(out_dir, f"whisper-small__decode_32k__{tag}.json")) as f:
            records[tag] = json.load(f)
    cell = json.loads(train_out.strip().splitlines()[-1])
    ref = train_ref or {}
    want = ref.get("state_arg_bytes", 0) + ref.get("batch_bytes", 0)
    peak_gib = cell["memory"]["peak_bytes"] / 2**30
    keep = ("status", "n_devices", "trace_s", "memory", "cost", "collectives",
            "n_collectives")
    emit("dryrun", card=card_line, cli=" ".join(DRYRUN_CLI),
         cli_lines=cli_out.strip().splitlines(),
         whisper_decode_32k={t: {k: r.get(k) for k in keep} for t, r in records.items()},
         train_cell=dict(arch=LM_ARCH, batch=TRAIN_BATCH, seq=TRAIN_SEQ, train=TRAIN_CFG,
                         mesh={"data": 1, "model": 1},
                         **{k: cell[k] for k in keep if k in cell}),
         train_measured_arg_bytes=want or None,
         traced_peak_gib=peak_gib, measured_peak_gib=ref.get("peak_mem_gib"),
         traced_over_measured_peak=(peak_gib / ref["peak_mem_gib"]
                                    if ref.get("peak_mem_gib") else None),
         phase_s=time.perf_counter() - t0)
    check(all(r["status"] == "traced" for r in records.values()),
          f"dryrun: whisper-small decode_32k gave {[r['status'] for r in records.values()]}")
    check(cell["status"] == "traced" and cell["launches_unchanged"],
          f"dryrun: lm.train's cell {cell['status']}, launches unchanged "
          f"{cell['launches_unchanged']}")
    check(not train_ref or cell["memory"]["argument_bytes"] == want,
          f"dryrun: lm.train's cell traced {cell['memory']['argument_bytes']} argument "
          f"bytes, lm.train measured {want} (state + batch)")

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

    # cuBLAS's workspace for deterministic products (lm.train's resumed
    # run): PyTorch's own default on sm_90, set before cuBLAS starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np
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

        # 4b. the execution choices at connect, against the same oracle
        config_phase(ds, db, join, orc, args.seed)

        # 5. the gathered-XᵀX covar path, against the main phase's oracle
        launches["covar_xtx"] = fused_covar_phase(ds, db, orc)
        shard_ref = dict(C=orc["C"], G=orc["G"], n=orc["n"], warm_s=orc["warm_s"],
                         N=float(np.float32(orc["n"])),
                         launches=launches["fused_scan_block"])
        del orc

        # 6.-7. the tree path: a decision tree fused and unfused, a forest
        tree_launches = tree_phase(ds, db, join, db.sizes()[ds.fact])
        launches["tree_hist_batched"] = tree_launches["trees.unfused"]["tree_hist_batched"]
        forest_phase(ds, db, join, args.seed)

        # 8.-11. the batch workloads on the engine
        chowliu_phase(ds, db, join)
        cubes_phase(ds, db, join)
        polyreg_phase(ds, db, join)
        moments_phase(ds, db, join, args.seed)

        # 12. incremental view maintenance, while Retailer is on the card
        ivm_phase(ds, db, args.seed, card_line)

        # 13. ad-hoc query serving over the same resident tables
        serve_phase(ds, db, join, args.seed, card_line, rates)

        # 13b. domain parallelism: world size 1 over NCCL here, then two
        # ranks over gloo as processes on the same card
        w1 = shard_w1_phase(ds, db, shard_ref, args.seed, card_line)
        # the two ranks share the card with this process: free its Retailer
        block_size = db.config.block_size
        del db, join
        gc.collect()
        torch.cuda.empty_cache()
        shard_w2_phase(ds, block_size, shard_ref, w1, args.seed, card_line)
        del w1, shard_ref

        # 14. the engine examples
        del ds
        examples_phase()
        torch.cuda.empty_cache()

        # 15.-16. the LM prefill and serving path
        lm_f32_phase(args.seed)
        torch.cuda.empty_cache()
        launches["flash_attention"] = lm_bf16_phase(args.seed)["flash_attention"]

        # 17.-22. the MoE, SSM, hybrid, MLA, VLM and audio families, the
        # last five also on a (1, 1) NCCL mesh
        shard_results = {}
        with one_rank_mesh() as mesh:
            for phase, arch, f32_layers, bf16_layers in LM_FAMILIES:
                torch.cuda.empty_cache()
                shard_results[arch] = lm_family_phase(
                    phase, arch, f32_layers, bf16_layers, args.seed,
                    mesh if arch in SHARD_FAMILIES else None, card_line)

        # 23. training: no kernel runs under grad
        torch.cuda.empty_cache()
        train_ref = lm_train_phase(args.seed, shard_results)

        # 24. the LM on a mesh: NCCL at world size 1, the sharded prefill
        # through flash_attention on each rank's local heads
        torch.cuda.empty_cache()
        lm_shard_phase(args.seed, card_line, train_ref)

        # 25. the multi-pod dry run: fake tensors over a fake process group
        dryrun_phase(card_line, train_ref)
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
