"""Core: semirings, the baseline FW loops and the staged round loops."""
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


def __getattr__(name: str):
    # The round loop imports the kernel modules, which import core.semiring:
    # loaded on first use, so that any module of the package imports first.
    if name == "fw_staged":
        from repro_torch.core.staged import fw_staged

        return fw_staged
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
