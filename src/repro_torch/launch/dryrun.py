"""Multi-pod dry run: every (architecture × input shape) cell traced on
fake tensors over a fake process group at the production meshes' world
sizes, with each rank's bytes, products and collectives recorded;
counterpart of ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out reports/dryrun [--device cpu]

A cell runs its step once as rank 0 of a fake process group of 256 ranks
(the (16, 16) ``("data", "model")`` mesh) or 512 (the (2, 16, 16)
``("pod", "data", "model")`` mesh) under ``FakeTensorMode``: the state and
inputs are placed by the port's specs (``shard_tree``), DTensor runs every
op on the rank's local shards and issues the collectives, and nothing is
allocated or sent.  No kernel wrapper is reached: attention is
``"chunked"``, as in the reference, and decode's is plain torch.  A
failure (a placement the port refuses, a data-dependent shape) is a bug in
the system, as the reference's brief says.

What differs from the reference, which lowers and compiles with XLA:

* ``status`` is ``"traced"`` (``"specs"`` under ``--no-compile``, which
  traces nothing), and ``trace_s`` takes the place of ``lower_s`` and
  ``compile_s``; ``n_collectives`` (by type) that of ``hlo_lines``.
* ``memory``: ``argument_bytes`` is the rank's sum of local shard bytes of
  every argument the step reads, which is what XLA's argument size counts
  (``jit`` drops an argument its function does not read: whisper's decode
  reads no encoder weight, an SSM's decode no ``pos``); ``output_bytes``
  the same over what the step returns; ``peak_bytes`` the rank's peak of
  live storage bytes over the trace, every argument included;
  ``temp_bytes`` is ``peak_bytes - argument_bytes``.  It is not XLA's temp
  size: XLA assigns buffers after fusion, eager torch holds what autograd
  and Python keep alive.  Under ``--no-compile`` ``argument_bytes`` counts
  every argument, from the specs.
* ``cost``: per rank, over the ops the rank runs on its local tensors.
  ``flops`` counts the products (the ops torch's flop counter knows:
  matrix products, convolutions, fused attention), as ``FlopCounterMode``
  does, not XLA's elementwise flops; ``bytes accessed`` sums each op's
  input and output bytes (views, allocations and collectives excluded).
* ``collectives``: a rank's bytes by type under the reference's ring model
  (:func:`collective_bytes`), from the functional collectives DTensor
  issues and the port's own ``dist.all_reduce`` calls (DTensor moves a
  shard from one dimension to another by an all-gather in these steps, so
  no all-to-all is counted).
* Decode's ``pos`` is a Python int, ``seq_len - 1`` (the last slot of a
  full cache; the port's decode takes it so, and the MoE's buckets and the
  cache write need it static); its 4 bytes count as the reference's int32
  scalar argument where the step reads it (a cache of attention keys).
* ``--device`` (the card unless ``--device cpu``): the fake tensors' device
  and the mesh's device type.

Each cell runs in a fresh fake process group, destroyed after it, so a
process that runs a dry run must hold no other default process group.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
import traceback
import weakref
from typing import Any, Dict, Iterable, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import configs
from repro_torch.configs.shapes import PREFILL, SHAPES, InputShape, applicable
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (P, param_pspecs, rules_for,
                                              shard_tree, spec_for)
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import map_specs
from repro_torch.serve.engine import make_serve_step
from repro_torch.train.adamw import tree_leaves
from repro_torch.train.step import (TrainConfig, abstract_state, batch_pspecs,
                                    make_prefill_step, make_train_step,
                                    state_pspecs)

# per-(family) grad-accum so microbatch activations fit HBM (DESIGN.md §6)
GRAD_ACCUM = {"ssm": 4, "hybrid": 4, "moe": 2, "vlm": 2, "dense": 2, "audio": 1}

#: the production meshes: (16, 16) single pod, (2, 16, 16) two pods
PRODUCTION_MESHES = {False: {"data": 16, "model": 16},
                     True: {"pod": 2, "data": 16, "model": 16}}


def train_cfg_for(cfg: ModelConfig, shape: InputShape) -> TrainConfig:
    ga = GRAD_ACCUM.get(cfg.family, 1)
    # keep microbatch >= 1 per data shard
    while shape.global_batch // ga < 32 and ga > 1:
        ga //= 2
    return TrainConfig(ce_chunk=256, grad_accum=ga, attn_impl="chunked")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """Stand-ins on the ``meta`` device for every model input (no
    allocation), with the reference's shapes and dtypes: a train or
    prefill batch, or decode's tokens, ``pos`` (an int32 scalar), cache
    (every leaf in the model dtype, as the reference's) and context."""
    b, s = shape.global_batch, shape.seq_len
    f32 = torch.float32
    if shape.kind == "train":
        batch = {"tokens": _meta((b, s), torch.int32)}
        if cfg.family == "vlm":
            batch["vision"] = _meta((b, cfg.vision_tokens, cfg.d_model), f32)
        if cfg.family == "audio":
            batch["frames"] = _meta((b, cfg.encoder_frames, cfg.d_model), f32)
        return batch
    # decode: one new token against a cache of seq_len
    out = {"tokens": _meta((b, 1), torch.int32),
           "pos": _meta((), torch.int32),
           "cache": map_specs(lambda sp: _meta(sp.shape, cfg.torch_dtype),
                              M.cache_specs(cfg, b, s))}
    if cfg.family == "vlm":
        out["context"] = _meta((b, cfg.vision_tokens, cfg.d_model), f32)
    if cfg.family == "audio":
        out["context"] = _meta((b, cfg.encoder_frames, cfg.d_model), f32)
    return out


# -- collectives -------------------------------------------------------------

#: the reference's collective types, in its record's order
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

#: op -> (type, index of its operand argument, index of its output
#: argument or None for what it returns)
_COLLECTIVE_OPS = {
    "_c10d_functional.all_reduce": ("all-reduce", 0, None),
    "_c10d_functional.all_reduce_": ("all-reduce", 0, None),
    "c10d.allreduce_": ("all-reduce", 0, None),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", 0, None),
    "_c10d_functional.all_gather_into_tensor_out": ("all-gather", 0, None),
    "c10d.allgather_": ("all-gather", 1, 0),
    "c10d._allgather_base_": ("all-gather", 1, 0),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", 0, None),
    "c10d.reduce_scatter_": ("reduce-scatter", 1, 0),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 1, 0),
    "_c10d_functional.all_to_all_single": ("all-to-all", 0, None),
    "_dtensor.shard_dim_alltoall": ("all-to-all", 0, None),
    "c10d.alltoall_": ("all-to-all", 1, 0),
    "c10d.alltoall_base_": ("all-to-all", 1, 0),
    "c10d.send": ("collective-permute", 0, None),
}
#: namespaces whose ops move data between ranks; one missing from the
#: table above raises rather than go uncounted
_COMM_NAMESPACES = ("c10d", "_c10d_functional", "_c10d_functional_autograd",
                    "_dtensor")
#: communication ops that move nothing of their own
_COMM_NO_BYTES = {"_c10d_functional.wait_tensor", "c10d.recv_", "c10d.barrier",
                  "c10d.monitored_barrier_"}
#: ops that read and write no tensor data
_NO_ACCESS = {"prim.device", "prim.layout", "aten.detach", "aten.lift_fresh",
              "aten.empty", "aten.empty_like", "aten.empty_strided",
              "aten.new_empty", "aten.new_empty_strided", "aten.alias",
              "aten._local_scalar_dense", "aten.sym_size", "aten.sym_stride",
              "aten.sym_numel", "aten.sym_storage_offset", "aten.is_same_size"}


def collective_bytes(records: Iterable[Tuple[str, float, float]]) -> Dict[str, float]:
    """Per-rank bytes crossing links, by collective type, from
    ``(type, operand bytes, result bytes)`` records: the reference's ring
    model ((n-1)/n ≈ 1): all-reduce 2×operand; all-gather result;
    reduce-scatter, all-to-all and collective-permute operand."""
    out = dict.fromkeys(COLLECTIVES, 0.0)
    for kind, operand, result in records:
        if kind == "all-reduce":
            out[kind] += 2 * (operand or result)
        elif kind == "all-gather":
            out[kind] += result or operand
        else:
            out[kind] += operand or result
    out["total"] = sum(out.values())
    return out


def _tensors(x) -> list:
    """The tensors of a (nested) argument."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    if isinstance(x, dict):
        return [t for e in x.values() for t in _tensors(e)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _local_leaves(tree) -> list:
    """The rank's tensors of a tree: a DTensor's local shard."""
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def local_bytes(tree) -> int:
    """The rank's bytes of a tree of tensors."""
    return _nbytes(_local_leaves(tree))


class RankCost(TorchDispatchMode):
    """One rank's cost of what runs under it: the ops on local tensors
    (a DTensor op is handed back to DTensor, which runs its local ops here
    again), their products' flops, the bytes they read and write, the
    collectives by type, and the live storage bytes with their peak.
    :meth:`hold` counts tensors made before the mode was entered (a step's
    arguments) as live."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.records = []                       # (type, operand, result bytes)
        self.live = self.peak = 0
        self._storages = {}                     # StorageImpl address -> bytes
        self._read = set()                      # storages an op read
        self._shadow = 0

    def __enter__(self):
        # DTensor runs an op once more on global-shape fake tensors for its
        # output's metadata (the first time it meets each op schema): not
        # the rank's work, so nothing in there counts
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        inner = ShardingPropagator._propagate_tensor_meta_non_cached

        def shadow_run(prop, op_schema):
            self._shadow += 1
            try:
                return inner(prop, op_schema)
            finally:
                self._shadow -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = shadow_run
        self._restore = lambda: setattr(
            ShardingPropagator, "_propagate_tensor_meta_non_cached", inner)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._restore()

    def hold(self, tree) -> None:
        self._track(_local_leaves(tree))

    def read_bytes(self, tree) -> int:
        """The rank's bytes of the tensors of ``tree`` that an op read."""
        return _nbytes(t for t in _local_leaves(tree)
                       if t.untyped_storage()._cdata in self._read)

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def _track(self, ts) -> None:
        for t in ts:
            if t.device.type == "meta":
                continue
            s = t.untyped_storage()
            key = s._cdata
            if key in self._storages:
                continue
            n = s.nbytes()
            self._storages[key] = n
            self.live += n
            weakref.finalize(s, self._free, key)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._shadow:
            return out
        name = str(func.overloadpacket)
        outs = _tensors(out)
        if func.namespace in _COMM_NAMESPACES:
            if name not in _COMM_NO_BYTES:
                self._collective(name, args, outs)
                self._read.update(t.untyped_storage()._cdata for t in _tensors(args))
        elif not func.is_view and name not in _NO_ACCESS:
            ins = _tensors(args) + _tensors(kwargs)
            self._read.update(t.untyped_storage()._cdata for t in ins)
            if not any(t.device.type == "meta" for t in ins + outs):
                self.bytes_accessed += _nbytes(ins) + _nbytes(outs)
                count = flop_registry.get(func.overloadpacket)
                if count is not None:
                    self.flops += count(*args, **kwargs, out_val=out)
        self._track(outs)
        return out

    def _collective(self, name: str, args, outs) -> None:
        if name not in _COLLECTIVE_OPS:
            raise NotImplementedError(
                f"{name}: no ring model for this collective in the dry run's "
                "table (launch/dryrun.py _COLLECTIVE_OPS)")
        kind, operand_at, result_at = _COLLECTIVE_OPS[name]
        operand = _nbytes(_tensors(args[operand_at]))
        result = _nbytes(outs if result_at is None else _tensors(args[result_at]))
        self.records.append((kind, operand, result))

    def collectives(self) -> Dict[str, float]:
        return collective_bytes(self.records)

    def n_collectives(self) -> Dict[str, int]:
        out = dict.fromkeys(COLLECTIVES, 0)
        for kind, _, _ in self.records:
            out[kind] += 1
        return out


# -- cells -------------------------------------------------------------------


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake default process group of ``world_size`` ranks with this
    process as rank 0: collectives return at once and send nothing.
    Destroyed on exit."""
    if dist.is_initialized():
        raise RuntimeError("a default process group is already running: a dry "
                           "run starts its own fake one (run it in a process "
                           "of its own)")
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _device_mesh(sizes: Mapping[str, int], device: torch.device):
    """``sizes``' mesh through ``launch/mesh.py``: the production meshes, or a
    ``("data", "model")`` host mesh of any shape."""
    if list(sizes) == ["pod", "data", "model"]:
        if dict(sizes) != PRODUCTION_MESHES[True]:
            raise ValueError(f"a pod mesh is (2, 16, 16), not {tuple(sizes.values())}")
        return make_production_mesh(multi_pod=True, device_type=device)
    if list(sizes) != ["data", "model"]:
        raise ValueError(f"mesh axes {tuple(sizes)}: ('data', 'model') or "
                         "('pod', 'data', 'model')")
    return make_host_mesh(sizes["data"], sizes["model"], device_type=device)


def cell_arguments(cfg: ModelConfig, shape: InputShape, tcfg: TrainConfig,
                   sizes: Mapping[str, int]):
    """The step's kind and its arguments on ``meta`` with their specs:
    train ``(state, batch)``, prefill ``(params, batch)``, decode ``(params,
    cache, tokens, pos[, context])``, placed as the reference's ``lower_cell``
    places them."""
    rules = rules_for(sizes)
    ins = input_specs(cfg, shape)
    if shape.kind == "train" and shape.name not in PREFILL:
        return "train", (abstract_state(cfg, tcfg), ins), (
            state_pspecs(cfg, tcfg, sizes), batch_pspecs(cfg, sizes))
    params = map_specs(lambda sp: _meta(sp.shape, cfg.torch_dtype), M.model_specs(cfg))
    pspec = param_pspecs(M.model_specs(cfg), rules, sizes)
    if shape.kind == "train":
        return "prefill", (params, ins), (pspec, batch_pspecs(cfg, sizes))
    cspec = param_pspecs(M.cache_specs(cfg, shape.global_batch, shape.seq_len),
                         rules, sizes)
    args = [params, ins["cache"], ins["tokens"], ins["pos"]]
    specs = [pspec, cspec, spec_for(("batch", None), rules, ins["tokens"].shape, sizes),
             P()]
    if "context" in ins:
        args.append(ins["context"])
        specs.append(spec_for(("batch", None, None), rules, ins["context"].shape, sizes))
    return "decode", tuple(args), tuple(specs)


def _local_numel(shape: Sequence[int], spec, sizes: Mapping[str, int]) -> int:
    n = 1
    for i, d in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        names = () if entry is None else (entry,) if isinstance(entry, str) else entry
        k = math.prod(sizes[a] for a in names)
        if d % k:
            raise ValueError(f"dimension {i} of {tuple(shape)} does not split "
                             f"evenly over {k} ranks ({spec})")
        n *= d // k
    return n


def spec_bytes(args, specs, sizes: Mapping[str, int]) -> int:
    """A rank's bytes of ``args`` (``meta`` trees) placed by ``specs``, from
    the shapes alone: no process group, no tensor."""
    def walk(a, s):
        if isinstance(a, dict):
            return sum(walk(a[k], s[k]) for k in a)
        return _local_numel(a.shape, s, sizes) * a.element_size()

    return sum(walk(a, s) for a, s in zip(args, specs))


def trace_cell(cfg: ModelConfig, shape: InputShape, sizes: Mapping[str, int],
               tcfg: Optional[TrainConfig] = None, device="cuda",
               trace: bool = True) -> Dict[str, Any]:
    """One cell's record fields (``status``, ``memory``, and when traced
    ``trace_s``, ``cost``, ``collectives``, ``n_collectives``): ``cfg``'s
    step for ``shape`` on a mesh of ``sizes`` (``{axis: size}`` in mesh
    order), run once as rank 0 of a fake process group of that many ranks
    on fake tensors on ``device`` (the card unless the caller asks for the
    CPU).  ``trace=False``: the argument bytes from the specs alone."""
    device = resolve_device(device)
    tcfg = tcfg or train_cfg_for(cfg, shape)
    kind, args, specs = cell_arguments(cfg, shape, tcfg, sizes)
    if not trace:
        return {"status": "specs",
                "memory": {"argument_bytes": spec_bytes(args, specs, sizes)}}
    with fake_world(math.prod(sizes.values())):
        # the mesh holds real rank numbers: made before the fake mode
        mesh = _device_mesh(sizes, device)
        with FakeTensorMode():
            rec = _trace(kind, cfg, shape, tcfg, args, specs, mesh, device)
    return rec


def _trace(kind, cfg, shape, tcfg, args, specs, mesh, device) -> Dict[str, Any]:
    """The step run once under ``RankCost`` on fake arguments placed on
    ``mesh`` (inside a ``FakeTensorMode``)."""
    def fake(t):
        return torch.empty(t.shape, dtype=t.dtype, device=device)

    placed = [shard_tree(_fake_tree(a, fake), s, mesh) for a, s in zip(args, specs)]
    if kind == "decode":
        placed[3] = shape.seq_len - 1           # pos: the last slot of the cache
    cost = RankCost()
    cost.hold(placed)
    if kind == "train":
        step = make_train_step(cfg, tcfg, mesh)
    elif kind == "prefill":
        step = make_prefill_step(cfg, tcfg, mesh)
    else:
        step = make_serve_step(cfg, mesh)
    t0 = time.perf_counter()
    with cost:
        out = step(*placed)
    trace_s = time.perf_counter() - t0
    # what the step reads, as XLA keeps only the arguments a step reads:
    # decode reads ``pos`` where its cache holds attention's keys (rope,
    # the cache write), not in an SSM-only model
    arg_bytes = cost.read_bytes(placed)
    if kind == "decode" and ({"kv", "shared_kv"} & set(placed[1])):
        arg_bytes += 4
    return {"status": "traced", "trace_s": round(trace_s, 2),
            "memory": {"argument_bytes": arg_bytes, "output_bytes": local_bytes(out),
                       "peak_bytes": cost.peak, "temp_bytes": cost.peak - arg_bytes},
            "cost": {"flops": float(cost.flops),
                     "bytes accessed": float(cost.bytes_accessed)},
            "collectives": cost.collectives(), "n_collectives": cost.n_collectives()}


def _fake_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _fake_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def lower_cell(arch: str, shape_name: str, multi_pod: bool, trace: bool = True,
               device="cuda") -> Dict[str, Any]:
    """The reference's cell: ``arch``'s exact config at ``shape_name`` on
    the single-pod (16, 16) or the multi-pod (2, 16, 16) mesh."""
    cfg = configs.get(arch)
    shape = SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped", "why": why}
    sizes = PRODUCTION_MESHES[multi_pod]
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "pod2x16x16" if multi_pod else "pod16x16",
        "n_devices": math.prod(sizes.values()),
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "kind": shape.kind, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
    }
    rec.update(trace_cell(cfg, shape, sizes, device=device, trace=trace))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="reports/dryrun")
    ap.add_argument("--no-compile", action="store_true",
                    help="trace nothing: the argument bytes from the specs")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (cpu to run without a card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    archs = configs.ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
                try:
                    rec = lower_cell(arch, shape, mp, trace=not args.no_compile,
                                     device=device)
                except Exception as e:  # a failure here is a bug in the system
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "multi" if mp else "single",
                           "status": "FAILED", "error": repr(e),
                           "trace": traceback.format_exc()[-2000:]}
                    failures += 1
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=1)
                status = rec["status"]
                extra = ""
                if status == "traced":
                    extra = (f" flops/dev={rec['cost']['flops']:.3e}"
                             f" coll={rec['collectives']['total']:.3e}B"
                             f" trace={rec['trace_s']}s")
                print(f"[dryrun] {tag}: {status}{extra}", flush=True)
    if failures:
        print(f"[dryrun] {failures} FAILURES", flush=True)
        sys.exit(1)


if __name__ == "__main__":
    main()
