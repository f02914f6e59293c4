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


def mesh_of(shape, names):
    """A CPU mesh over the whole group (the reference's ``jax.make_mesh``)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


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
