"""Training substrate of the port; counterpart of ``repro/train``."""
