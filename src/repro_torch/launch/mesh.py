"""Mesh construction on ``torch.distributed``; counterpart of
``repro/launch/mesh.py``.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with the
reference's axis names.  The caller starts the default process group, as
``torchrun`` or a launcher does (``dist.init_process_group`` with its
address, world size and rank); these functions never start one, and say so
when none is running.  The device type follows the port's rule: the card
unless the caller asks for the CPU.

    dist.init_process_group("gloo", init_method="file:///tmp/pg",
                            world_size=4, rank=r)
    mesh = make_host_mesh(n_data=4, device_type="cpu")
    db = repro_torch.connect(ds, device="cpu",
                             config=ExecutionConfig(mesh=mesh))

The same meshes carry the LM's sharded steps (``distributed/sharding.py``):
``make_train_step(cfg, tcfg, make_host_mesh(n_data=2, n_model=2))``.
"""

from __future__ import annotations

import torch.distributed as dist

from repro_torch.device import resolve_device


def _mesh(device_type: str, shape, axes):
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no default process group: start one first (torchrun, or "
            "torch.distributed.init_process_group with init_method, "
            "world_size and rank); the mesh never starts one itself")
    from torch.distributed.device_mesh import init_device_mesh

    device_type = resolve_device(device_type).type
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """The reference's production mesh: (16, 16) ``("data", "model")``, or
    (2, 16, 16) ``("pod", "data", "model")`` — 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, axes)


def make_host_mesh(n_data: int = 1, n_model: int = 1, device_type="cuda"):
    """A small ``("data", "model")`` mesh over the process group's ranks
    (tests, one host); ``n_data · n_model`` must be the world size."""
    return _mesh(device_type, (n_data, n_model), ("data", "model"))
