"""launch substrate; counterpart of ``repro/launch`` (``serve.py``,
``train.py``, ``mesh.py``, whose meshes serve the engine and the LM's
sharded steps alike, and ``dryrun.py``, which traces the LM's steps on fake
tensors over a fake process group at the production meshes' 256 and 512
ranks in place of the reference's XLA compiles)."""
