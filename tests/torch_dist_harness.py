"""Spawn process-group ranks for the port's multi-rank tests (gloo on the
CPU; the card cases on NCCL or gloo).

    results = run_ranks(case_fn, world_size, tmp_path, *args)

starts ``world_size`` processes (``torch.multiprocessing``, spawn), each of
which sets ``torch.set_num_threads(1)``, joins a process group through
a ``file://`` store in ``tmp_path`` (no TCP port, so concurrent test
workers cannot collide) with a timeout of its own, calls ``case_fn(rank,
world_size, *args)`` and writes what it returns (a picklable host value) to
``tmp_path``; ``destroy_process_group`` runs in a ``finally``.  A rank that
raises, hangs past the timeout or dies fails the call with its traceback.

The case functions live here, not in the ``test_*`` files: a spawned rank
imports the module of its function, and this one imports neither JAX nor
the reference package.  The parent holds what they return against the
reference's single-device results.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: seconds a spawned group may take, end to end, and its collectives' timeout
TIMEOUT_S = 120

SPEC = ([("x1", "categorical", 3), ("x2", "key", 4), ("x3", "key", 5),
         ("x4", "categorical", 3), ("u", "continuous", 0)],
        [("R1", ["x1", "x2"]), ("R2", ["x2", "x3", "u"]), ("R3", ["x3", "x4"])])
#: tests/test_distributed.py's schema
FD_SPEC = ([("k", "key", 16), ("c", "categorical", 5), ("u", "continuous", 0)],
           [("F", ["k", "u"]), ("D", ["k", "c"])])


def _rank_main(rank, world, init_file, out_dir, backend, fn, args):
    torch.set_num_threads(1)
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        with open(path, "wb") as f:
            pickle.dump(("ok", result), f)
    except BaseException:
        with open(path, "wb") as f:
            pickle.dump(("error", traceback.format_exc()), f)
        raise


def run_ranks(fn, world: int, tmp_dir, *args, backend: str = "gloo"):
    """``[fn(rank, world, *args) for each rank]``, each in its own process
    of one process group (gloo unless ``backend`` says otherwise); raises
    with a rank's traceback if any fails."""
    out_dir = tempfile.mkdtemp(dir=str(tmp_dir))
    init_file = os.path.join(out_dir, "pg_store")
    ctx = mp.start_processes(_rank_main, args=(world, init_file, out_dir,
                                               backend, fn, args),
                             nprocs=world, join=False, start_method="spawn")
    try:
        deadline = TIMEOUT_S
        t0 = datetime.datetime.now()
        while not ctx.join(timeout=5):
            if (datetime.datetime.now() - t0).total_seconds() > deadline:
                raise TimeoutError(f"{world} ranks ran past {deadline} s")
    except mp.ProcessRaisedException as e:
        errs = _errors(out_dir, world)
        raise AssertionError(f"a rank failed:\n{errs or e}") from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            status, value = pickle.load(f)
        assert status == "ok", value
        out.append(value)
    return out


def _errors(out_dir, world) -> str:
    msgs = []
    for r in range(world):
        p = os.path.join(out_dir, f"rank{r}.pkl")
        if os.path.exists(p):
            with open(p, "rb") as f:
                status, value = pickle.load(f)
            if status == "error":
                msgs.append(f"rank {r}:\n{value}")
    return "\n".join(msgs)


# ------------------------------------------------------------------ helpers

def host(out):
    """``{name: float64 numpy}`` of a result dict."""
    return {k: v.detach().cpu().double().numpy() for k, v in out.items()}


def mesh_of(shape, names, device_type="cpu"):
    """A mesh over the whole group (the reference's ``jax.make_mesh``), on
    the CPU unless ``device_type`` says otherwise."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))


def chain_tables(seed=7):
    """tests/test_ivm_sharded.py's chain tables."""
    rng = np.random.default_rng(seed)
    return {"R1": {"x1": rng.integers(0, 3, 17), "x2": rng.integers(0, 4, 17)},
            "R2": {"x2": rng.integers(0, 4, 29), "x3": rng.integers(0, 5, 29),
                   "u": rng.normal(size=29).astype(np.float32)},
            "R3": {"x3": rng.integers(0, 5, 13), "x4": rng.integers(0, 3, 13)}}


def chain_queries(m):
    """tests/test_ivm_sharded.py's QUERIES, in module ``m``'s API."""
    return [m.query("q_count", [], [m.COUNT]),
            m.query("q_g1", ["x1"], [m.COUNT, m.sum_of("u")]),
            m.query("q_delta", ["x4"], [m.agg(m.Var("u"),
                                              m.Delta("x1", "==", 1))])]


def update_stream(seed=11, n2=29):
    """A deterministic mixed stream as host dicts: inserts and deletes on
    the largest relation R2 and on R1 and R3 (tests/test_ivm_sharded.py's
    ``update_stream``): ``[{rel: (inserts or None, delete_idx or None)}]``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(6):
        k = int(rng.integers(1, 7))
        nd = int(rng.integers(1, 5))
        upd = {"R2": ({"x2": rng.integers(0, 4, k), "x3": rng.integers(0, 5, k),
                       "u": rng.normal(size=k).astype(np.float32)},
                      rng.choice(n2, nd, replace=False))}
        if i % 2:
            upd["R1"] = ({"x1": rng.integers(0, 3, 2),
                          "x2": rng.integers(0, 4, 2)}, None)
        if i % 3 == 2:
            upd["R3"] = (None, np.array([i]))
        n2 += k - nd
        out.append(upd)
    return out


def as_update(rel_mod, upd):
    """A host-dict update as ``rel_mod.DeltaBatchUpdate`` (either package)."""
    u = rel_mod.DeltaBatchUpdate()
    for rel, (ins, dels) in upd.items():
        if ins is not None:
            u.insert(rel, ins)
        if dels is not None:
            u.delete(rel, dels)
    return u


def _connect(spec, tables, mesh=None, **cfg):
    import repro_torch
    from repro_torch.core.schema import schema

    config = repro_torch.ExecutionConfig(mesh=mesh, **cfg)
    return repro_torch.connect(schema(*spec), tables=tables, device="cpu",
                               config=config)


# ----------------------------------------------------------- engine cases

def engine_case(rank, world, shape, names, axis, n, block_size, backend):
    """tests/test_distributed.py:7-56: ``CompiledBatch.run_sharded`` over a
    mesh of ``shape`` and through ``ExecutionConfig(mesh=)``; both results
    and the shard topology."""
    from repro_torch.core import aggregates as T

    rng = np.random.default_rng(n)
    tables = {"F": {"k": rng.integers(0, 16, n),
                    "u": rng.normal(size=n).astype(np.float32)},
              "D": {"k": np.arange(16), "c": rng.integers(0, 5, 16)}}
    qs = [T.query("byc", ["c"], [T.COUNT, T.sum_of("u"),
                                 T.agg(T.Pow("u", 2))]),
          T.query("tot", [], [T.COUNT, T.sum_of("u")])]
    mesh = mesh_of(shape, names)
    db = _connect(FD_SPEC, tables, block_size=block_size, backend=backend)
    batch = db.views(qs).compiled
    legacy = host(batch.run_sharded(db.data, mesh, axis=axis))
    sess = db.with_config(mesh=mesh, mesh_axis=axis)
    v = sess.views(qs)
    out = host(v.run())
    again = host(v.run())
    rep = v.explain()
    return dict(legacy=legacy, session=out, again=again,
                n_runners=len(v._sharded), shard=rep.shard,
                summary=rep.summary(), tables=tables)


def covar_case(rank, world, scale, fuse):
    """The covar batch of Retailer over a ``(world,)`` mesh through
    ``connect(..., config=ExecutionConfig(mesh=))``."""
    import repro_torch
    from repro_torch.data import datasets as TD
    from repro_torch.kernels import ops
    from repro_torch.ml.covar import compute_covar

    ds = TD.make("retailer", scale=scale)
    mesh = mesh_of((world,), ("data",))
    db = repro_torch.connect(ds, device="cpu", config=repro_torch.
                             ExecutionConfig(mesh=mesh, block_size=256,
                                             fuse_kernels=fuse))
    ops.reset_launches()
    C, N, layout, batch = compute_covar(ds, database=db)
    return dict(C=C, N=N, launches=sum(ops.LAUNCHES.values()),
                dispatches=batch.n_dispatches)


def tree_level_case(rank, world, scale, params, n_nodes_seq):
    """One frontier-batched tree level of Favorita over a ``(world,)`` mesh,
    for each node count of ``n_nodes_seq`` (the first ``n`` rows of
    ``params``): the outputs, and the sharded runners built."""
    import repro_torch
    from repro_torch.data import datasets as TD
    from repro_torch.ml import trees as ttrees

    ds = TD.make("favorita", scale=scale)
    mesh = mesh_of((world,), ("data",))
    db = repro_torch.connect(ds, device="cpu", config=repro_torch.
                             ExecutionConfig(mesh=mesh, block_size=256))
    dt = ttrees.DecisionTree(ds, max_depth=1, min_instances=10, database=db)
    outs, runners = [], []
    for n in n_nodes_seq:
        outs.append(host(dt.view.run_batched({k: v[:n] for k, v in
                                              params.items()})))
        runners.append(len(dt.view._sharded))
    return dict(outs=outs, runners=runners,
                hits=[r.hit for r in db.workload.records()])


def errors_case(rank, world):
    """A missing mesh axis and an unknown ``shard_rel`` raise, on every
    rank, before any collective."""
    import repro_torch
    from repro_torch.core import aggregates as T

    mesh = mesh_of((world,), ("data",))
    raised = []
    try:
        repro_torch.ExecutionConfig(mesh=mesh, mesh_axis="model")
    except ValueError as e:
        raised.append(str(e))
    db = _connect(SPEC, chain_tables())
    qs = chain_queries(T)
    bad = db.with_config(mesh=mesh, shard_rel="nope")
    for maintain in (False, True):
        try:
            bad.views(qs, maintain=maintain).run()
        except ValueError as e:
            raised.append(str(e))
    from repro_torch.launch import mesh as lmesh
    try:
        lmesh.make_host_mesh(n_data=world, device_type="cuda")
    except RuntimeError as e:
        raised.append(str(e))
    return raised


# -------------------------------------------------------------- IVM cases

def ivm_stream_case(rank, world, backend):
    """tests/test_ivm_sharded.py:86: the mixed stream on a sharded and a
    local maintained batch: results after every apply, the gathered
    relations at the end, the runner builds of the sharded batch, its
    topology and verification."""
    import repro_torch
    from repro_torch.core import aggregates as T
    from repro_torch.data import relations as TR

    mesh = mesh_of((world,), ("data",))
    local = _connect(SPEC, chain_tables(), block_size=8, backend=backend)
    sharded = local.with_config(mesh=mesh)
    qs = chain_queries(T)
    vl = local.views(qs, maintain=True)
    vs = sharded.views(qs, maintain=True)
    res = {"init": (host(vs.run()), host(vl.run()))}
    mb = vs.maintained
    res["shard_rel"] = mb.shard_rel
    steps = []
    for upd in update_stream():
        steps.append((host(vs.apply(as_update(TR, upd))),
                      host(vl.apply(as_update(TR, upd)))))
    res["steps"] = steps
    res["relations"] = {name: {a: c.numpy() for a, c in
                               mb.db.relation(name).columns.items()}
                        for name in ("R1", "R2", "R3")}
    res["builds"] = mb.n_fold_traces
    # steady state: same-size R2 batches after warm-up build nothing more
    rng = np.random.default_rng(rank * 0 + 3)
    for i in range(5):
        k = 4
        upd = {"R2": ({"x2": rng.integers(0, 4, k), "x3": rng.integers(0, 5, k),
                       "u": rng.normal(size=k).astype(np.float32)},
                      rng.choice(20, 2, replace=False))}
        vs.apply(as_update(TR, upd))
        vl.apply(as_update(TR, upd))
        if i == 1:
            warm = mb.n_fold_traces
    res["steady_builds"] = mb.n_fold_traces - warm
    res["final"] = (host(vs.results()), host(vl.results()))
    rep = vs.explain()
    res["shard"] = rep.shard
    res["summary"] = rep.summary()
    res["verify"] = {k: (r.n_checks, r.invariants)
                     for k, r in mb.last_verifications.items()}
    res["tick"] = {rel: mb.tick_program(rel).summary()
                   for rel in ("R1", "R2", "R3")}
    # the router: a scan tier under the mesh records "sharded_scan"
    r = sharded.route(T.query("q_x4", ["x4"], [T.COUNT]))
    res["route"] = (r.tier, host({"v": r.value})["v"],
                    [rec.hit for rec in sharded.workload.records()
                     if rec.view == "q_x4"])
    return res


def ivm_snapshot_case(rank, world, tmp_dir):
    """tests/test_ivm_sharded.py:139: a sharded snapshot restores into a
    local batch and a local one into a sharded batch, which keeps
    maintaining."""
    from repro_torch.core import aggregates as T
    from repro_torch.data import relations as TR

    mesh = mesh_of((world,), ("data",))
    local = _connect(SPEC, chain_tables(), block_size=8)
    sharded = local.with_config(mesh=mesh)
    qs = chain_queries(T)
    vl = local.views(qs, maintain=True)
    vs = sharded.views(qs, maintain=True)
    vl.run()
    vs.run()
    updates = update_stream()
    for upd in updates[:3]:
        vl.apply(as_update(TR, upd))
        vs.apply(as_update(TR, upd))
    d_s = os.path.join(tmp_dir, "sharded")
    d_l = os.path.join(tmp_dir, "local")
    vs.snapshot(d_s)                        # every rank; rank 0 writes
    if rank == 0:                           # a local batch writes alone
        vl.snapshot(d_l)
    dist.barrier()
    vl2 = local.views(qs, maintain=True)
    step_l = vl2.restore(d_s)
    vs2 = sharded.views(qs, maintain=True)
    step_s = vs2.restore(d_l)
    out = {"steps": (step_l, step_s),
           "sharded_to_local": (host(vl2.results()), host(vl.results())),
           "local_to_sharded": (host(vs2.results()), host(vl.results())),
           "files": sorted(os.listdir(d_s)), "post": []}
    for upd in updates[3:]:
        out["post"].append((host(vs2.apply(as_update(TR, upd))),
                            host(vl.apply(as_update(TR, upd)))))
    return out


# ------------------------------------------------------------- card cases

def card_covar_case(rank, world, scale, n_ticks):
    """On the card (every rank on device 0): the covar batch of Retailer
    sharded over a ``(world,)`` mesh and unsharded, their
    ``fused_scan_block`` launches, and a sharded maintained covar's 1% fact
    ticks, those after the first under sync-debug "error" (host values
    only leave the rank) where the group is NCCL's."""
    import repro_torch
    from repro_torch.data import datasets as TD
    from repro_torch.data import relations as TR
    from repro_torch.kernels import ops
    from repro_torch.ml.covar import (assemble_covar, compute_covar,
                                      covar_queries)

    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(0)                 # every rank on the one card
    mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("data",))
    ds = TD.make("retailer", scale=scale)
    db = repro_torch.connect(ds, config=repro_torch.ExecutionConfig(
        block_size=4096))
    sdb = db.with_config(mesh=mesh)
    ops.reset_launches()
    C_s, N_s, layout, _ = compute_covar(ds, database=sdb)
    launches_s = ops.LAUNCHES["fused_scan_block"]
    ops.reset_launches()
    C_l, N_l, _, _ = compute_covar(ds, database=db)
    launches_l = ops.LAUNCHES["fused_scan_block"]
    qs, _ = covar_queries(ds)
    h = sdb.views(qs, maintain=True, roots={q.name: ds.fact for q in qs})
    h.run()
    fact = ds.tables[ds.fact]
    n = len(next(iter(fact.values())))
    rng = np.random.default_rng(5)
    ticks, builds = [], []
    for i in range(n_ticks):
        pick = rng.integers(0, n, n // 100)
        upd = (TR.DeltaBatchUpdate()
               .insert(ds.fact, {a: np.asarray(c)[pick] for a, c in fact.items()})
               .delete(ds.fact, rng.choice(n, n // 100, replace=False)))
        built = h.maintained.n_fold_traces
        if i and dist.get_backend() == "nccl":   # gloo syncs on CUDA tensors
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = h.apply(upd)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        builds.append(h.maintained.n_fold_traces - built)
        ticks.append(assemble_covar({k: v.cpu().numpy() for k, v in
                                     out.items()}, layout))
    return dict(C_s=C_s, N_s=N_s, C_l=C_l, N_l=N_l, launches_s=launches_s,
                launches_l=launches_l, ticks=ticks, builds=builds,
                tables={a: np.asarray(c) for a, c in fact.items()})


# --------------------------------------------------------------- LM cases

def _local_shapes(tree):
    """``[(global shape, local shape)]`` of a tree's DTensor leaves, in
    ``tree_leaves`` order."""
    from repro_torch.train.adamw import tree_leaves

    return [(tuple(t.shape), tuple(t.to_local().shape)) for t in tree_leaves(tree)]


@contextlib.contextmanager
def strict_flatten_views():
    """Within, DTensor refuses a view that flattens a dimension sharded
    after the first of the dimensions it flattens, as torch 2.11 does
    ("Attempted to flatten multiple dimensions, with dimension 1 being
    sharded"); later releases give it a strided placement instead.  The
    card's torch is 2.11: this holds the CPU's newer torch to its rule."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor._ops import _view_ops as V

    plain = V.propagate_shape_and_sharding

    def flattens(cmd):
        if isinstance(cmd, V.Flatten):
            yield cmd
            for d in cmd.input_dims:
                yield from flattens(d)
        elif isinstance(cmd, V.Split):
            yield from flattens(cmd.input_dim)

    def strict(placements, shape, rule, mesh_sizes, strict_view=False):
        if strict_view:
            for fl in (f for cmd in rule for f in flattens(cmd)):
                for d in fl.input_dims[1:]:
                    if any(isinstance(p, Shard) and isinstance(d, V.InputDim)
                           and p.dim == d.input_dim and mesh_sizes[m] > 1
                           for m, p in enumerate(placements)):
                        raise RuntimeError(
                            f"Attempted to flatten multiple dimensions, with "
                            f"dimension {d.input_dim} being sharded (torch 2.11)")
        return plain(placements, shape, rule, mesh_sizes, strict_view)

    V.propagate_shape_and_sharding = strict
    try:
        yield
    finally:
        V.propagate_shape_and_sharding = plain


def lm_case(rank, world, runs, tmp_dir=None, strict_views=False):
    """The LM's sharded steps: for each ``(shape, cases)`` of ``runs`` a
    ``("data", "model")`` mesh of ``shape`` over the whole group (several
    meshes share one group), one dict a case (smoke configs, numpy inputs
    made by the parent); a list of results a run:

      * ``train``: ``state`` placed by ``state_pspecs``, a step a batch of
        ``batches`` (token arrays, or dicts of arrays with a VLM's
        ``vision`` or audio's ``frames``; the smoke config with ``cfg``'s
        overrides); the metrics, the gathered params and every leaf's
        (global, local) shape after the steps;
      * ``prefill``: ``params`` placed by ``param_pspecs``, one prefill of
        ``tokens`` (and ``context``'s arrays, if any) with ``impl``; the
        gathered logits;
      * ``decode``: a zero cache placed by the cache specs, the raw
        ``context`` (if any) encoded once on the mesh
        (``make_encode_step``), one step a column of ``tokens``; the
        gathered logits of each, the cache's shapes and the encoded
        context's placements;
      * ``loop``: ``TrainLoop`` runs of ``steps`` steps, straight and
        stopped at ``stop`` then resumed from its checkpoint (under
        ``tmp_dir``); both runs' losses and params.

    With ``strict_views`` every case runs under ``strict_flatten_views``.
    """
    with strict_flatten_views() if strict_views else contextlib.nullcontext():
        return [_lm_cases(shape, cases, os.path.join(tmp_dir, "x".join(map(str, shape))))
                for shape, cases in runs]


def _lm_cases(shape, cases, tmp_dir):
    from repro_torch import configs
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.distributed.sharding import param_pspecs, rules_for
    from repro_torch.models import model as M
    from repro_torch.models.weights import params_from_numpy, state_to_numpy
    from repro_torch.serve.engine import (init_sharded_cache, make_encode_step,
                                          make_serve_step)
    from repro_torch.train.loop import LoopConfig, TrainLoop
    from repro_torch.train.step import (TrainConfig, make_prefill_step,
                                        make_train_step, state_pspecs)

    mesh = mesh_of(shape, ("data", "model"))
    rules = rules_for(mesh)
    out = []
    for case in cases:
        cfg = configs.get_smoke(case["arch"]).with_(**case.get("cfg", {}))
        kind = case["kind"]
        if kind in ("train", "loop"):
            tcfg = TrainConfig(**case["tcfg"])
            specs = state_pspecs(cfg, tcfg, mesh)
        else:
            specs = param_pspecs(M.model_specs(cfg), rules, mesh)
        if kind == "train":
            state = params_from_numpy(case["state"], "cpu", mesh, specs)
            step = make_train_step(cfg, tcfg, mesh)
            metrics = []
            for b in case["batches"]:
                b = b if isinstance(b, dict) else {"tokens": b}
                state, met = step(state, {k: torch.from_numpy(np.asarray(a))
                                          for k, a in b.items()})
                metrics.append({k: float(v) for k, v in met.items()})
            out.append(dict(metrics=metrics, params=state_to_numpy(state["params"]),
                            shapes=_local_shapes(state),
                            plain_metrics=all(type(v) is torch.Tensor
                                              for v in met.values())))
        elif kind == "prefill":
            params = params_from_numpy(case["params"], "cpu", mesh, specs)
            batch = {k: torch.from_numpy(np.asarray(a)) for k, a in
                     dict(case.get("context", {}), tokens=case["tokens"]).items()}
            logits = make_prefill_step(cfg, TrainConfig(attn_impl=case["impl"]),
                                       mesh)(params, batch)
            out.append(dict(logits=logits.full_tensor().numpy(),
                            placements=[repr(p) for p in logits.placements]))
        elif kind == "decode":
            params = params_from_numpy(case["params"], "cpu", mesh, specs)
            toks = torch.from_numpy(case["tokens"])
            cache = init_sharded_cache(cfg, toks.shape[0], case["max_len"], mesh)
            context = make_encode_step(cfg, mesh)(params, case.get("context"))
            step = make_serve_step(cfg, mesh)
            logits = []
            for pos in range(case["steps"]):
                lg, cache = step(params, cache, toks[:, pos:pos + 1], pos, context)
                logits.append(lg.full_tensor().numpy())
            out.append(dict(logits=logits, shapes=_local_shapes(cache),
                            cache=state_to_numpy(cache),
                            context_placements=None if context is None else
                            [repr(p) for p in context.placements]))
        else:                                               # loop
            pipe = TokenPipeline(PipelineConfig(*case["pipe"], cfg.vocab, seed=0),
                                 cfg, device="cpu")
            runs = {}
            for label, stops in (("straight", [case["steps"]]),
                                 ("resumed", [case["stop"], case["steps"]])):
                ckpt = os.path.join(tmp_dir, label)
                losses = []
                for n in stops:
                    state = params_from_numpy(case["state"], "cpu", mesh, specs)
                    loop = TrainLoop(make_train_step(cfg, tcfg, mesh), pipe,
                                     LoopConfig(max_steps=n, ckpt_every=case["stop"],
                                                ckpt_dir=ckpt, log_every=0),
                                     log=lambda m: None)
                    state = loop.run(state)
                    losses += loop.losses()
                runs[label] = dict(losses=losses,
                                   params=state_to_numpy(state["params"]),
                                   files=sorted(os.listdir(ckpt)))
            out.append(runs)
    return out


def card_lm_case(rank, world):
    """internlm2-1.8b's smoke config in bf16 on the card, on a (1, 1) mesh
    (NCCL): the sharded prefill with ``"flash"`` and the unsharded one
    (their logits and the kernel's launches), a kernel wrapper given a
    DTensor (the error), and two warm sharded dense train steps under
    sync-debug "error" (their losses)."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch import configs
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.distributed.sharding import param_pspecs, rules_for, shard_tree
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models.layers import init_params
    from repro_torch.train.step import (TrainConfig, init_state, make_prefill_step,
                                        make_train_step, state_pspecs)

    torch.cuda.set_device(0)
    mesh = mesh_of((1, 1), ("data", "model"), "cuda")
    cfg = configs.get_smoke("internlm2-1.8b").with_(dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = init_params(M.model_specs(cfg), gen, cfg.torch_dtype, "cuda")
    sparams = shard_tree(params, param_pspecs(M.model_specs(cfg), rules_for(mesh), mesh),
                         mesh)
    tokens = torch.randint(0, cfg.vocab, (2, 200), generator=gen, device="cuda")
    tcfg = TrainConfig(attn_impl="flash")
    ops.reset_launches()
    got = make_prefill_step(cfg, tcfg, mesh)(sparams, {"tokens": tokens})
    launches = dict(ops.LAUNCHES)
    want = make_prefill_step(cfg, tcfg)(params, {"tokens": tokens})
    q = DTensor.from_local(torch.zeros(1, 2, 8, 16, device="cuda", dtype=torch.bfloat16),
                           mesh, [Replicate(), Replicate()], run_check=False)
    try:
        ops.flash_attention(q, q.to_local(), q.to_local())
        refused = None
    except TypeError as e:
        refused = str(e)
    tcfg = TrainConfig(attn_impl="dense", ce_chunk=8)
    state = init_state(cfg.with_(dtype="float32"), tcfg, gen, "cuda")
    state = shard_tree(state, state_pspecs(cfg, tcfg, mesh), mesh)
    pipe = TokenPipeline(PipelineConfig(4, 16, cfg.vocab, seed=0), cfg, device="cuda")
    step = make_train_step(cfg.with_(dtype="float32"), tcfg, mesh)
    state, _ = step(state, pipe.batch_at(0))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = []
        for i in (1, 2):
            state, met = step(state, pipe.batch_at(i))
            losses.append(met["loss"])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return dict(got=got.full_tensor().float().cpu().numpy(),
                want=want.float().cpu().numpy(), launches=launches,
                refused=refused, losses=[float(x) for x in losses],
                placements=[repr(p) for p in got.placements])
