"""The paper's algorithm: n/s pivot rounds, in two lowerings.

Counterpart of ``repro.core.staged.fw_staged`` and
``fw_staged_with_successors``: a Python loop over the rounds.

  * fused (``fused=None`` / ``True``, the default): each round is one
    ``kernels.fw_round`` call — three launches on the card, the plain
    version on the CPU (``repro/core/staged.py:118-146``).
  * 4-dispatch (``fused=False``): the reference's round body
    (``repro/core/staged.py:148-170``) — ``fw_phase1`` on the diagonal
    tile, ``fw_phase2_row`` / ``fw_phase2_col`` on the bands, the closed
    diagonal spliced over each band's pivot tile, both bands copied into w,
    then ``semiring_matmul`` relaxing all of w against them.  Four kernel
    launches a round plus the splice copies, which are plain tensor copies
    as the reference's ``dynamic_update_slice`` are.  Bitwise equal to the
    fused lowering.

Both lowerings run every storage (f32, bf16, f16, the int16 lowerings,
packed or_and words, the int32 carrier of an integer or_and / plus_mul
storage) in w's own dtype; the successor round f32, bf16 and f16
distances.

The band buffers are allocated once per solve and reused by every round;
a (B, n, n) input runs each launch over the whole batch.
"""
from __future__ import annotations

import torch

from repro_torch.core.paths import _init_successors
from repro_torch.core.semiring import MIN_PLUS, Semiring
from repro_torch.kernels import fw_round as _fr
from repro_torch.kernels.fw_phase1 import fw_phase1
from repro_torch.kernels.fw_phase2 import fw_phase2_col, fw_phase2_row
from repro_torch.kernels.minplus_matmul import semiring_matmul


def _check(w: torch.Tensor, s: int) -> int:
    n = w.shape[-1]
    if w.ndim not in (2, 3) or w.shape[-2] != n:
        raise ValueError(f"w must be (n,n) or (B,n,n), got {tuple(w.shape)}")
    if n % s:
        raise ValueError(f"n={n} not a multiple of block_size={s}")
    return n


def fw_staged(
    w: torch.Tensor, *, block_size: int = 128, bm: int = 256, bn: int = 256,
    bk: int = 32, variant: str = "fori", semiring: Semiring = MIN_PLUS,
    fused: bool | None = None,
) -> torch.Tensor:
    """Closure of w (n,n) or (B,n,n), n % block_size == 0; returns a new
    tensor (w is left as it was).

    fused: None or True runs the fused round, False the 4-dispatch round.
    bm / bn: the reference's phase-3 output tile, used only by the
    4-dispatch round and choosing no element's chain.  bk: the phase-3
    staging depth (clamped to block_size; the result does not depend on
    it).
    """
    n = _check(w, block_size)
    if fused not in (None, True, False):
        raise ValueError(f"fused={fused!r}: the port has the fused (None/True) and "
                         f"the 4-dispatch (False) rounds")
    w = w.contiguous().clone()  # the rounds update it in place
    if fused is not None and not fused:
        return _four_dispatch(w, block_size, min(bm, n), min(bn, n), min(bk, block_size),
                              variant, semiring)
    bands = _fr.round_buffers(w, block_size) if w.is_cuda else None
    for b in range(n // block_size):
        _fr.fw_round(w, b, block_size=block_size, bk=bk, variant=variant,
                     semiring=semiring, bands=bands)
    return w


def _four_dispatch(w, s: int, bm: int, bn: int, bk: int, variant: str,
                   semiring: Semiring) -> torch.Tensor:
    """The 4-dispatch rounds on w, in place."""
    n = w.shape[-1]
    lead = w.shape[:-2]
    diag = w.new_empty((*lead, s, s))
    row = w.new_empty((*lead, s, n))
    col = w.new_empty((*lead, n, s))
    for b in range(n // s):
        o = slice(b * s, (b + 1) * s)
        fw_phase1(w[..., o, o], semiring=semiring, out=diag)
        fw_phase2_row(diag, w[..., o, :], semiring=semiring, out=row)
        # The row kernel recomputed the pivot tile against itself (not a
        # no-op for plus_mul): the closed diagonal goes over it.
        row[..., :, o] = diag
        fw_phase2_col(diag, w[..., :, o], semiring=semiring, out=col)
        col[..., o, :] = diag
        w[..., o, :] = row
        w[..., :, o] = col
        semiring_matmul(col, row, w, semiring=semiring, bm=bm, bn=bn, bk=bk,
                        variant=variant, out=w)
    return w


def fw_staged_with_successors(
    w: torch.Tensor, *, block_size: int = 128
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dist, succ) of a min-plus w (n,n) or (B,n,n), f32, bf16 or f16,
    through the fused successor round; succ[..., i, j] is the next hop, -1
    where no path."""
    n = _check(w, block_size)
    succ = _init_successors(w).contiguous()
    w = w.contiguous().clone()  # the rounds update w and succ in place
    bands = _fr.succ_round_buffers(w, block_size) if w.is_cuda else None
    for b in range(n // block_size):
        _fr.fw_round_with_successors(w, succ, b, block_size=block_size, bands=bands)
    return w, succ
