"""repro_torch.apsp — the APSP solver front-end.

    from repro_torch.apsp import solve
    res = solve(w)                        # any n, auto-padded, on the card
    res = solve(w_batch, method="fused")  # (B, n, n): one launch set per round

The engine, autotuner and mesh / recursive planners of ``repro.apsp`` are
not ported yet (ROADMAP A.5, A.10, A.11).
"""
from repro_torch.apsp import plan
from repro_torch.apsp.api import (
    METHODS,
    SUCCESSOR_METHODS,
    APSPResult,
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
    "plan",
    "solve",
]
