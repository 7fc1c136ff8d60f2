"""Core: semirings, the baseline FW loops and the fused round loop."""
from repro_torch.core.floyd_warshall import fw_blocked, fw_naive, fw_numpy
from repro_torch.core.semiring import (
    MAX_MIN,
    MAX_PLUS,
    MIN_PLUS,
    OR_AND,
    PLUS_MUL,
    SEMIRINGS,
    Semiring,
)
from repro_torch.core.staged import fw_staged

__all__ = [
    "fw_blocked",
    "fw_naive",
    "fw_numpy",
    "fw_staged",
    "Semiring",
    "MIN_PLUS",
    "MAX_PLUS",
    "MAX_MIN",
    "OR_AND",
    "PLUS_MUL",
    "SEMIRINGS",
]
