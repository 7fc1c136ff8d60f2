"""The paper's algorithm: n/s fused pivot rounds.

Counterpart of the fused round loop of ``repro.core.staged.fw_staged``
(lines 118-146) and of ``fw_staged_with_successors``: a Python loop over
the rounds, each one ``kernels.fw_round`` call — three launches on the
card, the plain version on the CPU.  The band buffers are allocated once
per solve and reused by every round.  The 4-dispatch lowering
(``fused=False``) is ROADMAP A.6.
"""
from __future__ import annotations

import torch

from repro_torch.core.paths import _init_successors
from repro_torch.core.semiring import MIN_PLUS, Semiring
# Module import, not names: kernels.fw_round imports core.semiring, whose
# package imports this module.
from repro_torch.kernels import fw_round as _fr


def _check(w: torch.Tensor, s: int) -> int:
    n = w.shape[-1]
    if w.ndim not in (2, 3) or w.shape[-2] != n:
        raise ValueError(f"w must be (n,n) or (B,n,n), got {tuple(w.shape)}")
    if n % s:
        raise ValueError(f"n={n} not a multiple of block_size={s}")
    return n


def fw_staged(
    w: torch.Tensor, *, block_size: int = 128, bk: int = 32,
    variant: str = "fori", semiring: Semiring = MIN_PLUS,
) -> torch.Tensor:
    """Closure of w (n,n) or (B,n,n), n % block_size == 0, through the fused
    round; returns a new tensor (w is left as it was)."""
    n = _check(w, block_size)
    w = w.contiguous().clone()  # the rounds update it in place
    bands = _fr.round_buffers(w, block_size) if w.is_cuda else None
    for b in range(n // block_size):
        _fr.fw_round(w, b, block_size=block_size, bk=bk, variant=variant,
                     semiring=semiring, bands=bands)
    return w


def fw_staged_with_successors(
    w: torch.Tensor, *, block_size: int = 128
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dist, succ) of a min-plus w (n,n) or (B,n,n) through the fused
    successor round; succ[..., i, j] is the next hop, -1 where no path."""
    n = _check(w, block_size)
    succ = _init_successors(w).contiguous()
    w = w.contiguous().clone()  # the rounds update w and succ in place
    bands = _fr.succ_round_buffers(w, block_size) if w.is_cuda else None
    for b in range(n // block_size):
        _fr.fw_round_with_successors(w, succ, b, block_size=block_size, bands=bands)
    return w, succ
