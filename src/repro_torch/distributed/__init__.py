"""Distributed substrate of the port; counterpart of ``repro/distributed``
(``compression.py`` only: ``sharding.py``, the LM's sharding rules, is
still to port; the engine's domain parallelism is ``core/distributed.py``
on the mesh of ``launch/mesh.py``)."""
