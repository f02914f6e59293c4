"""Distributed substrate of the port; counterpart of ``repro/distributed``
(``compression.py`` only: sharding waits for the port's mesh)."""
