"""The staged relaxation chain shared by every phase-3 relaxation.

Torch counterparts of ``repro.kernels.minplus_matmul._fit_block`` and the
k-ascending variants of ``_stage_compute``.  The blocked semiring matmul
kernel itself (``semiring_matmul``) is not ported yet (ROADMAP B.2).
"""
from __future__ import annotations

import torch

from repro_torch.core.semiring import Semiring

VARIANTS = ("fori", "unroll")


def _fit_block(dim: int, want: int) -> int:
    """Largest divisor of dim that is ≤ want (keeps grids exact for any n)."""
    want = min(want, dim)
    for b in range(want, 0, -1):
        if dim % b == 0:
            return b
    return dim


def check_variant(variant: str) -> None:
    """Only the k-ascending chain is ported: "fori" and "unroll" run the same
    rank-1 steps in the same order; "broadcast" reduces in XLA's order."""
    if variant not in VARIANTS:
        raise ValueError(
            f"variant={variant!r} is not supported: the port runs the "
            f"k-ascending chain of {VARIANTS} only (\"broadcast\" reduces in "
            f"XLA's own order, which no kernel here reproduces)"
        )


def _stage_compute(
    acc: torch.Tensor, a_blk: torch.Tensor, b_blk: torch.Tensor,
    semiring: Semiring, variant: str = "fori",
) -> torch.Tensor:
    """⊕-accumulate one (…, bm×bk)·(…, bk×bn) panel-slice stage into acc."""
    check_variant(variant)
    for kk in range(a_blk.shape[-1]):
        acc = semiring.relax(acc, a_blk[..., :, kk, None], b_blk[..., kk, None, :])
    return acc
