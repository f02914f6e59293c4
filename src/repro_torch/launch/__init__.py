"""launch substrate; counterpart of ``repro/launch`` (``serve.py``,
``train.py`` and ``mesh.py``; no ``dryrun.py``)."""
