"""The multi-pod dry run (``repro_torch/launch/dryrun.py``) against the
reference's ``repro/launch/dryrun.py``.

Every case that starts a process group (the port's fake one) runs in a
subprocess: a default process group must not outlive its case in a test
worker.  The subprocesses start together, once for the module, and the
tests read their results:

  * the reference's compiled ``memory_analysis().argument_size_in_bytes``
    on a (2, 4) ``jax.sharding.Mesh`` of 8 forced host devices (Auto axes;
    the reference's own ``make_production_mesh`` makes Explicit axes, on
    which its steps raise in ``with_sharding_constraint`` under this jax),
    for the smoke configs at B 8 × 64, against the port's per-rank bytes
    traced on a fake world of 8 (every rank under torch 2.11's view rule,
    ``strict_flatten_views``);
  * the reference's ``NamedSharding(mesh, spec).shard_shape`` sums on 512
    forced host devices for every full config and applicable shape on both
    production meshes, against the port's bytes from its specs;
  * the port's command line on a smoke cell, and per-rank flops.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch import configs
from repro_torch.configs.shapes import PREFILL, SHAPES, applicable
from repro_torch.launch import dryrun as D

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240

#: the smoke cells of (a): B 8 × 64 (a decode cache of 64) on a (2, 4) mesh
SMOKE_SHAPES = {
    "train": dataclasses.replace(SHAPES["train_4k"], seq_len=64, global_batch=8),
    "prefill": dataclasses.replace(SHAPES["prefill_32k"], seq_len=64, global_batch=8),
    "decode": dataclasses.replace(SHAPES["decode_32k"], seq_len=64, global_batch=8)}
SMOKE_MESH = {"data": 2, "model": 4}
#: prefill and decode: dense, SSM, MLA-MoE, hybrid, audio (whisper's decode
#: reads no encoder weight, and mamba2's no position: XLA drops them)
SERVE_ARCHS = ("internlm2-1.8b", "mamba2-2.7b", "deepseek-v2-lite-16b", "zamba2-1.2b",
               "whisper-small")
SMOKE_CELLS = ([(a, "train") for a in configs.ARCH_IDS]
               + [(a, k) for a in SERVE_ARCHS for k in ("prefill", "decode")])

_SHAPES_CODE = """
    import dataclasses
    SMOKE = {k: dataclasses.replace(SHAPES[n], seq_len=64, global_batch=8)
             for k, n in (("train", "train_4k"), ("prefill", "prefill_32k"),
                          ("decode", "decode_32k"))}
"""

# the reference's lower_cell, on a mesh and config of the caller's (its own
# takes the production mesh and the exact config)
_REF_CODE = """
    import json
    import jax
    import numpy as np
    devs = jax.devices()        # before repro.launch.dryrun sets XLA_FLAGS
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro import configs
    from repro.configs.shapes import SHAPES, applicable
    from repro.distributed.sharding import param_pspecs, rules_for, spec_for
    from repro.launch import dryrun as RD
    from repro.models import model as M
    from repro.models.layers import abstract_params
    from repro.serve.engine import make_serve_step
    from repro.train.step import (abstract_state, batch_pspecs, make_prefill_step,
                                  make_train_step, state_pspecs)
""" + _SHAPES_CODE + """
    def arguments(cfg, shape, mesh):
        rules = rules_for(mesh)
        tcfg = RD.train_cfg_for(cfg, shape)
        ins = RD.input_specs(cfg, shape, mesh)
        if shape.kind == "train" and shape.name != "prefill_32k":
            return (make_train_step(cfg, tcfg, mesh),
                    [(abstract_state(cfg, tcfg), state_pspecs(cfg, tcfg, mesh)),
                     (ins, batch_pspecs(cfg, mesh))])
        pspec = param_pspecs(M.model_specs(cfg), rules, mesh)
        params = abstract_params(M.model_specs(cfg), cfg.jdtype)
        if shape.kind == "train":
            return (make_prefill_step(cfg, tcfg, mesh),
                    [(params, pspec), (ins, batch_pspecs(cfg, mesh))])
        cspec = param_pspecs(M.cache_specs(cfg, shape.global_batch, shape.seq_len),
                             rules, mesh)
        args = [(params, pspec), (ins["cache"], cspec),
                (ins["tokens"], spec_for(("batch", None), rules,
                                         ins["tokens"].shape, mesh)),
                (ins["pos"], P())]
        if "context" in ins:
            args.append((ins["context"], spec_for(("batch", None, None), rules,
                                                  ins["context"].shape, mesh)))
        return make_serve_step(cfg, mesh), args

    def shardings(mesh, spec):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), spec,
                            is_leaf=lambda x: isinstance(x, P))
"""


#: XLA's backend passes off for the reference's compiles: they change no
#: argument buffer, and halve the compile time
FAST_XLA = "--xla_backend_optimization_level=0 --xla_llvm_disable_expensive_passes=true"


def _start(code: str, n_devices: int = 1, *argv: str, xla_flags: str = "") -> subprocess.Popen:
    """``code`` in a subprocess with ``n_devices`` forced host devices (as
    ``conftest.run_with_devices``, without waiting for it)."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices} {xla_flags}"
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO, "src"),
                                         os.path.join(REPO, "tests")])
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code), *argv],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


class Jobs:
    """The module's subprocesses; each one's result (the JSON object it
    printed on its last line) read when a test first asks for it."""

    def __init__(self, procs):
        self.procs, self.results = procs, {}

    def __getitem__(self, name: str):
        if name not in self.results:
            p = self.procs[name]
            try:
                out, err = p.communicate(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                raise AssertionError(f"{name}: timed out after {TIMEOUT_S} s\n"
                                     f"STDERR:\n{err[-4000:]}")
            assert p.returncode == 0, (f"{name}:\nSTDOUT:\n{out[-4000:]}\n"
                                       f"STDERR:\n{err[-6000:]}")
            self.results[name] = json.loads(out.strip().splitlines()[-1])
        return self.results[name]

    def close(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()


def _ref_compiled(cells) -> str:
    return _REF_CODE + f"""
    mesh = Mesh(np.array(devs[:8]).reshape(2, 4), ("data", "model"))
    out = {{}}
    for arch, kind in {list(cells)!r}:
        step, args = arguments(configs.get_smoke(arch), SMOKE[kind], mesh)
        jitted = jax.jit(step, in_shardings=tuple(shardings(mesh, s) for _, s in args))
        mem = jitted.lower(*[a for a, _ in args]).compile().memory_analysis()
        out[arch + "/" + kind] = int(mem.argument_size_in_bytes)
    print(json.dumps(out))
"""


_REF_SPECS = _REF_CODE + """
    meshes = {"single": Mesh(np.array(devs[:256]).reshape(16, 16), ("data", "model")),
              "multi": Mesh(np.array(devs).reshape(2, 16, 16),
                            ("pod", "data", "model"))}
    out = {}
    for arch in configs.ARCH_IDS:
        cfg = configs.get(arch)
        for name, shape in SHAPES.items():
            if not applicable(cfg, shape)[0]:
                continue
            for tag, mesh in meshes.items():
                _, args = arguments(cfg, shape, mesh)
                n = 0
                for tree, spec in args:
                    for sds, sp in zip(jax.tree.leaves(tree),
                                       jax.tree.leaves(spec, is_leaf=lambda x: isinstance(x, P))):
                        local = NamedSharding(mesh, sp).shard_shape(sds.shape)
                        n += int(np.prod(local, dtype=np.int64)) * sds.dtype.itemsize
                out[f"{arch}/{name}/{tag}"] = n
    print(json.dumps(out))
"""


def _port_traced(cells) -> str:
    return f"""
    import json
    from repro_torch import configs
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import dryrun as D
    from torch_dist_harness import strict_flatten_views
""" + _SHAPES_CODE + f"""
    out = {{}}
    with strict_flatten_views():
        for arch, kind in {list(cells)!r}:
            out[arch + "/" + kind] = D.trace_cell(
                configs.get_smoke(arch), SMOKE[kind], {SMOKE_MESH!r}, device="cpu")
    print(json.dumps(out))
"""


# the command line on smoke cells (the exact configs are the card's to
# trace), then what the process loaded
_CLI = """
    import contextlib, io, json, os, sys
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun as D
    configs.get = configs.get_smoke
    out_dir = sys.argv[1]
    before = dict(ops.LAUNCHES)
    runs = {}
    for name, argv in (
            ("traced", ["--arch", "whisper-small", "--shape", "decode_32k",
                        "--mesh", "single"]),
            ("train", ["--arch", "internlm2-1.8b", "--shape", "train_4k",
                       "--mesh", "single"]),
            ("skipped", ["--arch", "internlm2-1.8b", "--shape", "long_500k"]),
            ("specs", ["--arch", "whisper-small", "--shape", "decode_32k",
                       "--mesh", "multi", "--no-compile"]),
            ("failed", ["--arch", "no-such-arch", "--shape", "train_4k",
                        "--mesh", "single"])):
        buf, code = io.StringIO(), 0
        with contextlib.redirect_stdout(buf):
            try:
                D.main(argv + ["--device", "cpu", "--out", os.path.join(out_dir, name)])
            except SystemExit as e:
                code = e.code
        runs[name] = {"code": code, "stdout": buf.getvalue(),
                      "files": {f: json.load(open(os.path.join(out_dir, name, f)))
                                for f in sorted(os.listdir(os.path.join(out_dir, name)))}}
    print(json.dumps({"runs": runs, "launches_before": before,
                      "launches_after": dict(ops.LAUNCHES),
                      "group_left": dist.is_initialized(),
                      "modules": sorted(m for m in sys.modules
                                        if m.split(".")[0] in ("jax", "jaxlib", "repro"))}))
"""

_FLOPS = """
    import json
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import configs
    from repro_torch.launch import dryrun as D
    from repro_torch.train.step import abstract_state, make_train_step
""" + _SHAPES_CODE.replace("SHAPES[n]", "D.SHAPES[n]") + """
    out = {}
    cfg = configs.get_smoke("internlm2-1.8b")
    shape = SMOKE["train"]
    out["step_1x1"] = D.trace_cell(cfg, shape, {"data": 1, "model": 1}, device="cpu")["cost"]
    tcfg = D.train_cfg_for(cfg, shape)
    with FakeTensorMode():
        state = D._fake_tree(abstract_state(cfg, tcfg),
                             lambda t: torch.empty(t.shape, dtype=t.dtype))
        batch = {"tokens": torch.empty((8, 64), dtype=torch.int32)}
        fc = FlopCounterMode(display=False)
        with fc:
            make_train_step(cfg, tcfg)(state, batch)
    out["step_global"] = fc.get_total_flops()
    for sizes in ({"data": 1, "model": 1}, {"data": 1, "model": 4}):
        with D.fake_world(sizes["model"]):
            mesh = D._device_mesh(sizes, torch.device("cpu"))
            with FakeTensorMode():
                x = torch.empty(32, 48)
                w = torch.empty(48, 64)
                xd = distribute_tensor(x, mesh, [Replicate(), Replicate()])
                wd = distribute_tensor(w, mesh, [Replicate(), Shard(1)])
                cost = D.RankCost()
                with cost:
                    y = xd @ wd
                fc = FlopCounterMode(display=False)
                with fc:
                    x @ w
        out[f"product_1x{sizes['model']}"] = [cost.flops, fc.get_total_flops(),
                                              list(y.to_local().shape)]
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Every subprocess of the module, started together."""
    jobs = Jobs({
        "ref_a": _start(_ref_compiled(SMOKE_CELLS[0::2]), 8, xla_flags=FAST_XLA),
        "ref_b": _start(_ref_compiled(SMOKE_CELLS[1::2]), 8, xla_flags=FAST_XLA),
        "ref_specs": _start(_REF_SPECS, 512),
        "port_a": _start(_port_traced(SMOKE_CELLS[0::2])),
        "port_b": _start(_port_traced(SMOKE_CELLS[1::2])),
        "flops": _start(_FLOPS),
        "cli": _start(_CLI, 1, str(tmp_path_factory.mktemp("dryrun"))),
    })
    yield jobs
    jobs.close()


def _cell(jobs, key):
    for name in ("port_a", "port_b"):
        if key in jobs[name]:
            return jobs[name][key]
    raise KeyError(key)


# -- (a) per-rank argument bytes against the reference's compiled sizes ------


@pytest.mark.parametrize("arch,kind", SMOKE_CELLS, ids=[f"{a}-{k}" for a, k in SMOKE_CELLS])
def test_traced_argument_bytes_equal_reference_compiled(jobs, arch, kind):
    """The rank's local shard bytes of every argument the step reads, from
    a trace on a fake world of 8, equal XLA's ``argument_size_in_bytes`` of
    the reference's step on a (2, 4) mesh (8 host devices), exactly."""
    key = f"{arch}/{kind}"
    ref = jobs["ref_a"].get(key, jobs["ref_b"].get(key))
    rec = _cell(jobs, key)
    assert rec["status"] == "traced"
    assert rec["memory"]["argument_bytes"] == ref
    # the spec-only count (every argument) agrees where the step reads all
    spec = D.trace_cell(configs.get_smoke(arch), SMOKE_SHAPES[kind], SMOKE_MESH,
                        device="cpu", trace=False)["memory"]["argument_bytes"]
    if kind != "decode" or arch in ("internlm2-1.8b", "deepseek-v2-lite-16b",
                                    "zamba2-1.2b"):
        assert spec == ref
    else:
        assert spec > ref


# -- (b) every full config on both production meshes, from specs -------------


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_spec_bytes_equal_reference_shard_shapes(jobs, arch):
    """``lower_cell(..., trace=False)``'s argument bytes for every
    applicable shape on the (16, 16) and (2, 16, 16) meshes equal the
    reference's ``NamedSharding.shard_shape`` sums of its own arguments;
    inapplicable shapes are skipped with the reference's reason."""
    ref = jobs["ref_specs"]
    cfg = configs.get(arch)
    n = 0
    for name, shape in SHAPES.items():
        ok, why = applicable(cfg, shape)
        for tag, multi in (("single", False), ("multi", True)):
            rec = D.lower_cell(arch, name, multi, trace=False, device="cpu")
            if not ok:
                assert rec == {"arch": arch, "shape": name, "status": "skipped",
                               "why": why}
                assert f"{arch}/{name}/{tag}" not in ref
                continue
            assert rec["status"] == "specs"
            assert rec["n_devices"] == (512 if multi else 256)
            assert rec["mesh"] == ("pod2x16x16" if multi else "pod16x16")
            assert rec["memory"]["argument_bytes"] == ref[f"{arch}/{name}/{tag}"], (name, tag)
            n += 1
    assert n == 2 * sum(applicable(cfg, s)[0] for s in SHAPES.values()) >= 6


# -- (c) the ring model -------------------------------------------------------


def test_collective_bytes_ring_model():
    """all-reduce moves twice its operand, all-gather its result, the rest
    their operand (falling back to the other size where one is 0, as the
    reference's HLO reading does)."""
    recs = [("all-reduce", 100, 100), ("all-reduce", 0, 8), ("all-gather", 10, 160),
            ("all-gather", 7, 0), ("reduce-scatter", 160, 10),
            ("all-to-all", 64, 64), ("collective-permute", 0, 32)]
    got = D.collective_bytes(recs)
    assert got == {"all-reduce": 216.0, "all-gather": 167.0, "reduce-scatter": 160.0,
                   "all-to-all": 64.0, "collective-permute": 32.0, "total": 639.0}
    assert D.collective_bytes([]) == dict.fromkeys(D.COLLECTIVES + ("total",), 0.0)


def test_collective_ops_are_all_typed():
    """Every op of the table maps to one of the reference's five types, and
    an untyped op in a communication namespace raises rather than go
    uncounted."""
    assert {k for k, _, _ in D._COLLECTIVE_OPS.values()} == set(D.COLLECTIVES)
    assert all(name.split(".")[0] in D._COMM_NAMESPACES for name in D._COLLECTIVE_OPS)
    cost = D.RankCost()
    with pytest.raises(NotImplementedError, match="no ring model"):
        cost._collective("c10d.broadcast_", ([torch.zeros(4)],), [])


def test_traced_collectives_follow_the_ring_model(jobs):
    """A traced cell's collective bytes are the ring model's of its own
    records, and each type it counts moved bytes."""
    rec = _cell(jobs, "internlm2-1.8b/train")
    coll, n = rec["collectives"], rec["n_collectives"]
    assert set(coll) == set(D.COLLECTIVES) | {"total"} and set(n) == set(D.COLLECTIVES)
    assert coll["total"] == sum(coll[k] for k in D.COLLECTIVES) > 0
    for k in D.COLLECTIVES:
        assert (coll[k] > 0) == (n[k] > 0), k
    # FSDP: weights gathered over data, their gradients reduce-scattered
    assert n["all-gather"] > 0 and n["reduce-scatter"] > 0 and n["all-reduce"] > 0


# -- (d) per-rank flops --------------------------------------------------------


def test_flops_at_one_rank_equal_the_global_count(jobs):
    """On a (1, 1) mesh a rank runs the whole step: its product flops equal
    ``FlopCounterMode``'s count of the unsharded step (DTensor's own
    global-shape runs for metadata do not count)."""
    r = jobs["flops"]
    assert r["step_1x1"]["flops"] == r["step_global"] > 0
    flops, global_, shape = r["product_1x1"]
    assert flops == global_ == 2 * 32 * 48 * 64 and shape == [32, 64]


def test_flops_of_a_model_sharded_product_are_a_quarter(jobs):
    """(1, 4): a product whose weight is sharded over ``model`` runs a
    quarter of its columns on each rank."""
    r = jobs["flops"]
    flops, global_, shape = r["product_1x4"]
    assert shape == [32, 16]
    assert flops * 4 == global_ == r["product_1x1"][0]


def test_smoke_train_costs_are_per_rank(jobs):
    """On (2, 4) a rank runs less than the whole step, and its bytes
    accessed exceed its argument bytes (every weight is read)."""
    one = jobs["flops"]["step_1x1"]
    rec = _cell(jobs, "internlm2-1.8b/train")
    assert 0 < rec["cost"]["flops"] < one["flops"]
    assert rec["cost"]["bytes accessed"] > rec["memory"]["argument_bytes"]


# -- (e), (f) the command line --------------------------------------------------

RECORD_KEYS = {"arch", "shape", "mesh", "n_devices", "params", "active_params", "kind",
               "seq_len", "global_batch", "status", "trace_s", "memory", "cost",
               "collectives", "n_collectives"}


def test_cli_writes_traced_records(jobs):
    runs = jobs["cli"]["runs"]
    for name, tag, kind in (("traced", "whisper-small__decode_32k__single", "decode"),
                            ("train", "internlm2-1.8b__train_4k__single", "train")):
        run = runs[name]
        assert run["code"] == 0
        rec = run["files"][tag + ".json"]
        assert set(rec) == RECORD_KEYS
        assert rec["status"] == "traced" and rec["kind"] == kind
        assert rec["mesh"] == "pod16x16" and rec["n_devices"] == 256
        mem = rec["memory"]
        assert set(mem) == {"argument_bytes", "output_bytes", "peak_bytes", "temp_bytes"}
        assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
        assert mem["temp_bytes"] == mem["peak_bytes"] - mem["argument_bytes"]
        assert set(rec["cost"]) == {"flops", "bytes accessed"} and rec["cost"]["flops"] > 0
        assert rec["collectives"]["total"] > 0
        line, = run["stdout"].splitlines()
        assert line.startswith(f"[dryrun] {tag}: traced flops/dev=")
        assert " coll=" in line and line.endswith("s")


def test_cli_skips_full_attention_at_long_500k(jobs):
    run = jobs["cli"]["runs"]["skipped"]
    assert run["code"] == 0
    assert sorted(run["files"]) == ["internlm2-1.8b__long_500k__multi.json",
                                    "internlm2-1.8b__long_500k__single.json"]
    cfg = configs.get_smoke("internlm2-1.8b")
    for rec in run["files"].values():
        assert rec == {"arch": "internlm2-1.8b", "shape": "long_500k",
                       "status": "skipped", "why": applicable(cfg, SHAPES["long_500k"])[1]}


def test_cli_no_compile_gives_spec_bytes(jobs):
    run = jobs["cli"]["runs"]["specs"]
    rec = run["files"]["whisper-small__decode_32k__multi.json"]
    assert run["code"] == 0 and rec["status"] == "specs"
    assert rec["memory"]["argument_bytes"] > 0 and "cost" not in rec


def test_cli_failure_is_recorded_and_exits_1(jobs):
    run = jobs["cli"]["runs"]["failed"]
    assert run["code"] == 1
    rec = run["files"]["no-such-arch__train_4k__single.json"]
    assert rec["status"] == "FAILED" and rec["mesh"] == "single"
    assert "no-such-arch" in rec["error"] and "Traceback" in rec["trace"]
    assert run["stdout"].splitlines() == ["[dryrun] no-such-arch__train_4k__single: FAILED",
                                          "[dryrun] 1 FAILURES"]


def test_cli_launches_no_kernel_and_leaves_no_group(jobs):
    r = jobs["cli"]
    assert r["launches_after"] == r["launches_before"]
    assert set(r["launches_after"]) and not any(r["launches_after"].values())
    assert r["group_left"] is False


def test_dryrun_loads_neither_jax_nor_the_reference(jobs):
    """As ``tests/test_torch_engine.py`` checks for the engine."""
    assert jobs["cli"]["modules"] == []


def test_import_starts_no_group_and_sets_no_environment():
    code = textwrap.dedent("""
        import os, sys
        env = dict(os.environ)
        import torch.distributed as dist
        import repro_torch.launch.dryrun
        assert dict(os.environ) == env
        assert not dist.is_initialized()
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=TIMEOUT_S, env=dict(os.environ,
                                                     PYTHONPATH=os.path.join(REPO, "src")))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-3000:]


def test_input_specs_shapes_and_dtypes():
    """The reference's stand-ins: int32 tokens, float32 vision and frames,
    the decode cache in the model dtype, ``pos`` an int32 scalar; all on
    ``meta``."""
    cfg = configs.get("whisper-small")
    train = D.input_specs(cfg, SHAPES["train_4k"])
    assert train["tokens"].shape == (256, 4096) and train["tokens"].dtype == torch.int32
    assert train["frames"].shape == (256, cfg.encoder_frames, cfg.d_model)
    assert train["frames"].dtype == torch.float32
    dec = D.input_specs(cfg, SHAPES["decode_32k"])
    assert dec["tokens"].shape == (128, 1) and dec["pos"].shape == ()
    assert dec["pos"].dtype == torch.int32
    assert dec["context"].dtype == torch.float32
    leaves = D.tree_leaves(dec["cache"])
    assert leaves and all(t.dtype == cfg.torch_dtype for t in leaves)
    assert all(t.device.type == "meta" for t in D.tree_leaves(dec))
    vlm = configs.get("llama-3.2-vision-90b")
    assert D.input_specs(vlm, SHAPES["train_4k"])["vision"].shape == (
        256, vlm.vision_tokens, vlm.d_model)
    assert D.train_cfg_for(configs.get("mamba2-2.7b"), SHAPES["train_4k"]).grad_accum == 4
    assert D.train_cfg_for(configs.get("mamba2-2.7b"), SHAPES["prefill_32k"]).grad_accum == 1
    assert PREFILL == {"prefill_32k"}
