"""launch substrate; counterpart of ``repro/launch`` (``serve.py`` only)."""
