"""Lowering backends of the port; counterpart of
``repro/core/lowering/__init__.py``.

A backend lowers one scheduler :class:`~repro_torch.core.ir.StepProgram` —
a fused multi-output scan over one relation — and writes the finished view
tensors.  ``cuda`` (default) runs the reductions through the hand-written
kernels of ``repro_torch.kernels`` (their plain versions on CPU tensors);
``torch`` (the reference's ``xla``) runs them as plain torch ops
(``index_add_``), the whole-path library baseline.  Select via
``PlanConfig.backend`` / ``ExecutionConfig(backend=...)``.
"""

from __future__ import annotations

BACKENDS = ("cuda", "torch")


def get_backend(name: str):
    """Instantiate a lowering backend by name."""
    if name == "cuda":
        from repro_torch.core.lowering.cuda import CudaBackend
        return CudaBackend()
    if name == "torch":
        from repro_torch.core.lowering.torch import TorchBackend
        return TorchBackend()
    raise ValueError(f"unknown lowering backend {name!r}; "
                     f"available: {', '.join(BACKENDS)}")
