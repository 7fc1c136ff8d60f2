"""Back-compat shim: the solver front-end lives in ``repro_torch.apsp.api``.

As ``repro.apsp.solver``: old ``solver`` imports keep working.  Import from
``repro_torch.apsp`` (preferred) or ``repro_torch.apsp.api``.
"""
from repro_torch.apsp.api import (  # noqa: F401
    APSPResult,
    METHODS,
    SUCCESSOR_METHODS,
    NegativeCycleError,
    negative_cycle_mask,
    solve,
)

__all__ = [
    "APSPResult",
    "METHODS",
    "SUCCESSOR_METHODS",
    "NegativeCycleError",
    "negative_cycle_mask",
    "solve",
]
