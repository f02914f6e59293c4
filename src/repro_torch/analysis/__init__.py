"""Static analysis over the port's compiled artifacts; counterpart of
``repro/analysis``.

:mod:`repro_torch.analysis.verify` — the execution-free plan verifier: it
walks a compiled batch plan (group-program IR, shared-scan schedule, fused
step programs), IVM's delta and tick programs and resident relations, and
the router's secondary programs, and raises structured
:class:`~repro_torch.analysis.verify.PlanInvariantError`\\ s before
anything runs.

:mod:`repro_torch.analysis.lint` — the engine-contract linter over
``src/repro_torch`` (host syncs, torch in ``obs/``, ``Engine`` outside
``core/``, literal seeds) with its own committed allowlist; the CLI wrapper
is ``tools/torch_lint_contracts.py``.
"""

from repro_torch.analysis.verify import (PlanInvariantError,
                                         VerificationReport,
                                         verification_enabled,
                                         verify_delta_program, verify_plan,
                                         verify_resident,
                                         verify_secondary_program,
                                         verify_tick_program)

__all__ = [
    "PlanInvariantError", "VerificationReport", "verification_enabled",
    "verify_delta_program", "verify_plan", "verify_resident",
    "verify_secondary_program", "verify_tick_program",
]
