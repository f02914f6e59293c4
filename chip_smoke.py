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
               same function, and the least time the card could take.
  4. main    — ``make_retailer(scale)`` (84M fact rows at 1400),
               ``connect(..., device="cuda")`` and ``compute_covar`` fused,
               then unfused; launch counters of each run; the covar held
               against a float64 oracle computed on the card from the
               gathered join; ridge (closed form and BGD) against ridge on
               the oracle's covar.

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


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def card_rates(name: str):
    """(HBM bytes/s, float32 FLOP/s outside the tensor cores) from NVIDIA's
    data sheets, by the card's reported name."""
    if "PCIe" in name:
        return 2.0e12, 51e12
    if "NVL" in name:
        return 3.9e12, 60e12
    return 3.35e12, 67e12            # H100 SXM


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


def in_range_rows(codes, specs):
    return [int(((codes[:, sp.code_col] >= 0)
                 & (codes[:, sp.code_col] < sp.n_segments)).sum()) for sp in specs]


def kernel_phase(args, plan_specs, rates):
    import torch

    from repro_torch.kernels import ops, ref

    bw, flops = rates
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    n = KERNEL_ROWS
    results = {}

    # -- fused_scan_block at the fact step's and the Items step's specs
    fused_cases = []
    for label in ("fact", "items"):
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
        case = dict(case=label, n=n, specs=[list(map(str, (sp.kind, sp.n_segments, sp.width))) for sp in specs],
                    max_abs_err=max_abs, max_rel_err=max_rel, ms=ms,
                    plain_ms=plain_ms, library_ms=None,
                    **bound(nbytes, ops_n, bw, flops))
        emit("kernel", name="fused_scan_block", **case)
        fused_cases.append(case)
        del codes, fpay, got, want, abs_want
    results["fused_scan_block"] = fused_cases

    # -- seg_aggregate at the unfused fact bucket (the widest spec)
    fact = plan_specs["fact"]
    sp = max(fact, key=lambda s: s.n_segments * s.width)
    codes, fpay = random_inputs((ops.ReduceSpec("seg", 0, sp.n_segments, sp.width, 0),), n, gen)
    seg = codes[:, 0].contiguous()
    got = ops.seg_aggregate(seg, fpay, sp.n_segments)
    want = ref.seg_aggregate_ref(seg, fpay, sp.n_segments)
    abs_want = ref.seg_aggregate_ref(seg, fpay.abs(), sp.n_segments)
    max_abs, max_rel = compare([got], [want], [abs_want], "seg_aggregate")
    ok = (seg >= 0) & (seg < sp.n_segments)
    sid = torch.where(ok, seg, torch.zeros_like(seg)).long()
    pay = fpay * ok[:, None].float()
    lib_out = torch.zeros((sp.n_segments, sp.width), device="cuda")
    case = dict(case="fact", n=n, n_segments=sp.n_segments, width=sp.width,
                max_abs_err=max_abs, max_rel_err=max_rel,
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
    return results


def bound(nbytes: int, n_ops: int, bw: float, flops: float):
    t_bytes, t_ops = nbytes / bw * 1e3, n_ops / flops * 1e3
    return dict(bytes=nbytes, ops=n_ops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------- main path

def oracle_covar(ds, data, layout, chunk: int = 1 << 22):
    """float64 XᵀX of the gathered join, on the card.  Every Retailer
    dimension row is addressed by a dense key of the fact row: Weather by
    date·n_locn + locn, Location by locn, Census by Location.zip[locn],
    Items by sku."""
    import torch

    rel = {name: data.relation(name).columns for name in data.relations}
    inv, wea, loc, cen, itm = (rel[r] for r in ("Inventory", "Weather", "Location", "Census", "Items"))
    n_locn = loc["locn"].shape[0]
    ar = lambda t: torch.arange(t.shape[0], device=t.device, dtype=t.dtype)
    check(bool((wea["date"].long() * n_locn + wea["locn"].long() == ar(wea["date"]).long()).all())
          and bool((loc["locn"] == ar(loc["locn"])).all())
          and bool((cen["zip"] == ar(cen["zip"])).all())
          and bool((itm["sku"] == ar(itm["sku"])).all()),
          "oracle: dimension tables are not densely keyed")
    home = {a: r for r, cols in (("Weather", wea), ("Location", loc), ("Census", cen), ("Items", itm))
            for a in cols}
    n = inv["date"].shape[0]
    p = layout.p
    G = torch.zeros((p, p), dtype=torch.float64, device="cuda")
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        locn = inv["locn"][s:e].long()
        rows = {"Weather": inv["date"][s:e].long() * n_locn + locn,
                "Location": locn, "Census": loc["zip"].long()[locn],
                "Items": inv["sku"][s:e].long()}

        def col(a):
            if a in inv:
                return inv[a][s:e]
            return rel[home[a]][a][rows[home[a]]]

        X = torch.zeros((e - s, p), dtype=torch.float64, device="cuda")
        X[:, 0] = 1.0
        for a in layout.cont:
            X[:, layout.cont_idx(a)] = col(a).double()
        for a in layout.cat:
            X.scatter_(1, (layout.cat_offsets[a] + col(a).long())[:, None], 1.0)
        X[:, layout.label_idx] = col(layout.label).double()
        G += X.T @ X
    return G.cpu().numpy(), float(n)


def device_breakdown(fn, top: int = 8):
    """Run ``fn`` once under ``torch.profiler``: device time by kernel name
    (the ``top`` largest), the device's busy time (sum of kernel times: one
    stream, so they do not overlap) and the host wall of the profiled run."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = e.name[:100]
            by_name[key] = by_name.get(key, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    busy = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return dict(profiled_wall_ms=wall * 1e3, device_busy_ms=busy,
                idle_share=1 - busy / (wall * 1e3) if wall > 0 else None,
                n_kernel_names=len(by_name),
                top=[[k, v] for k, v in ranked])


def scaled_err(C, G):
    import numpy as np

    d = np.sqrt(np.maximum(np.outer(np.diag(G), np.diag(G)), 1e-300))
    return float((np.abs(C - G) / d).max())


def main_phase(args, rates):
    import numpy as np
    import torch

    from repro_torch.api import ExecutionConfig, connect
    from repro_torch.data import datasets as TD
    from repro_torch.kernels import ops
    from repro_torch.ml import ridge
    from repro_torch.ml.covar import compute_covar

    t0 = time.perf_counter()
    ds = TD.make("retailer", scale=args.scale, seed=args.seed)
    gen_s = time.perf_counter() - t0
    cfg = ExecutionConfig(block_size=args.block_size)
    t0 = time.perf_counter()
    db = connect(ds, config=cfg, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    sizes = db.sizes()
    emit("main.data", scale=args.scale, rows=sizes, fact_rows=sizes[ds.fact],
         block_size=args.block_size, generate_s=gen_s, to_device_s=load_s,
         reduced=None if args.scale >= 1400 else
         f"scale {args.scale} instead of 1400 (fact rows {sizes[ds.fact]} of 84,000,000)")

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
        emit(f"main.{label}.profile", **device_breakdown(lambda: batch(sess.data)))
        stats = batch.stats
        n_blocks = sum(-(-sizes[st.rel] // min(args.block_size, sizes[st.rel]))
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
    G, n_o = oracle_covar(ds, db.data, layout)
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
    emit("main.ridge", rmse_oracle=r_o, label_std=label_std,
         closed_form_theta_rel=theta_err, closed_form_rmse_rel=rmse_err,
         bgd_theta_rel=bgd_err, bgd_rmse_rel=bgd_rmse_err,
         bgd_iterations=res.iterations, bgd_s=bgd_s,
         theta_tol=THETA_TOL, rmse_tol=RMSE_TOL)
    check(r_o < 0.8 * label_std, f"ridge does not learn: rmse {r_o} vs std {label_std}")
    check(theta_err <= THETA_TOL, f"closed-form θ vs oracle {theta_err:.3e} > {THETA_TOL}")
    check(bgd_err <= THETA_TOL, f"BGD θ vs oracle {bgd_err:.3e} > {THETA_TOL}")
    check(rmse_err <= RMSE_TOL, f"closed-form RMSE vs oracle {rmse_err:.3e} > {RMSE_TOL}")
    check(bgd_rmse_err <= RMSE_TOL, f"BGD RMSE vs oracle {bgd_rmse_err:.3e} > {RMSE_TOL}")
    # each kernel's launches on the path that runs it
    return {"fused_scan_block": runs["fused"]["launches"]["fused_scan_block"],
            "seg_aggregate": runs["unfused"]["launches"]["seg_aggregate"],
            "tree_hist": runs["unfused"]["launches"]["tree_hist"]}


def plan_specs_for(scale: float, block_size: int):
    """The fused specs of the covar plan's fact step and of its Items step
    with the histogram view, compiled at this run's relation sizes."""
    from repro_torch.core.engine import Engine
    from repro_torch.core.lowering.cuda import fused_layout
    from repro_torch.data import datasets as TD
    from repro_torch.ml.covar import covar_queries

    dims = TD.make("retailer", scale=min(scale, 4.0))   # dimension tables
    sizes = {r: len(next(iter(c.values()))) for r, c in dims.tables.items()}
    sizes[dims.fact] = int(60_000 * scale)
    qs, _ = covar_queries(dims)
    batch = Engine(dims.schema, edges=dims.edges, sizes=sizes)._compile(
        qs, block_size=block_size)
    out = {}
    for step, prog in zip(batch.schedule.steps, batch.plan.step_programs):
        specs, _ = fused_layout(prog)
        if step.rel == dims.fact:
            out["fact"] = specs
        elif any(sp.kind == "hist" for sp in specs):
            out["items"] = specs
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
         hbm_bytes_per_s=rates[0], fp32_flops=rates[1],
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

        # 4. main path
        launches = main_phase(args, rates)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    from repro_torch.kernels import ops

    sources = {"fused_scan_block": ("fused_scan.cu", "src/repro/kernels/fused_scan.py:168"),
               "seg_aggregate": ("seg_aggregate.cu", "src/repro/kernels/seg_aggregate.py:39"),
               "tree_hist": ("tree_hist.cu", "src/repro/kernels/tree_hist.py:51")}
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
            "library_ms": main_case["library_ms"]})
    print(json.dumps({"kernels": summary}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
