"""Distributed substrate of the port; counterpart of ``repro/distributed``:
``sharding.py``, the LM's logical-axis sharding rules as DTensor
placements on a ``DeviceMesh`` (``constrain``, ``fsdp``, ``shard_tree``),
and ``compression.py``, int8 error-feedback gradient compression.  The
engine's domain parallelism is ``core/distributed.py`` on the mesh of
``launch/mesh.py``."""
