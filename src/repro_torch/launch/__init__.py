"""launch substrate; counterpart of ``repro/launch`` (``serve.py``,
``train.py`` and ``mesh.py``, whose meshes serve the engine and the LM's
sharded steps alike; no ``dryrun.py`` yet: ``train/step.py``'s
``abstract_state`` and the spec functions are what it would lower)."""
