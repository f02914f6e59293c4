"""The layered aggregate engine of the PyTorch port; counterpart of
``repro/core``.  Submodules import independently."""
