"""Plain torch versions of the fused round kernels.

Counterparts of ``repro.kernels.ref.fw_round_ref`` and
``fw_round_with_successors_ref``: the same per-element ⊕/⊗ chains as the
reference, so outputs are bitwise equal to it.  Each round is split into
the three phases the CUDA kernels launch (``kernels/csrc/fw_round.cu``):

  1. ``close_diag*``  — close the (s, s) pivot tile;
  2. ``close_bands*`` — close the (s, n) row band and the (n, s) col band
     against it, the closed tile spliced in at block b;
  3. ``relax*``       — re-relax every tile against the closed bands, k
     ascending, pivot-band tiles starting from their closed values.

They run on any device and are what ``kernels.fw_round`` computes for a
tensor on the CPU.  On the card they are the yardstick the kernels are
held against; the main path never calls them there.  All are
batch-rank-agnostic and functional (they return new tensors).
"""
from __future__ import annotations

import torch

from repro_torch.core.paths import relax_succ
from repro_torch.core.semiring import MIN_PLUS, Semiring
from repro_torch.kernels.minplus_matmul import _fit_block, _stage_compute


def _pivot(b: int, s: int) -> slice:
    return slice(b * s, (b + 1) * s)


# ----------------------------------------------------------- plain round
def close_diag(diag: torch.Tensor, semiring: Semiring) -> torch.Tensor:
    """Phase 1: s sequential FW steps inside one (…, s, s) tile."""
    for k in range(diag.shape[-1]):
        diag = semiring.relax(diag, diag[..., :, k, None], diag[..., k, None, :])
    return diag


def close_bands(
    w: torch.Tensor, diag: torch.Tensor, b: int, semiring: Semiring
) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase 2: (row, col) bands of round b closed against the closed diag."""
    s = diag.shape[-1]
    o = _pivot(b, s)
    row = w[..., o, :]
    for k in range(s):
        row = semiring.relax(row, diag[..., :, k, None], row[..., k, None, :])
    col = w[..., :, o]
    for k in range(s):
        col = semiring.relax(col, col[..., :, k, None], diag[..., k, None, :])
    row[..., :, o] = diag  # row and col are new tensors, not views of w
    col[..., o, :] = diag
    return row, col


def relax(
    w: torch.Tensor, row: torch.Tensor, col: torch.Tensor, b: int, *,
    bk: int = 32, variant: str = "fori", semiring: Semiring = MIN_PLUS,
) -> torch.Tensor:
    """Phase 3: every tile ⊕= col ⊗ row in bk chunks, k ascending; the
    pivot bands start from their closed values."""
    s = row.shape[-2]
    o = _pivot(b, s)
    bk = _fit_block(s, bk)
    w = w.clone()
    w[..., o, :] = row
    w[..., :, o] = col
    for k0 in range(0, s, bk):
        w = _stage_compute(
            w, col[..., :, k0:k0 + bk], row[..., k0:k0 + bk, :], semiring, variant
        )
    return w


def fw_round_ref(
    w: torch.Tensor, b: int, *, block_size: int, bk: int = 32,
    variant: str = "fori", semiring: Semiring = MIN_PLUS,
) -> torch.Tensor:
    """One fused pivot round b of (…, n, n) w — bitwise the reference's."""
    o = _pivot(b, block_size)
    diag = close_diag(w[..., o, o], semiring)
    row, col = close_bands(w, diag, b, semiring)
    return relax(w, row, col, b, bk=bk, variant=variant, semiring=semiring)


# ------------------------------------------------------ successor round
def close_diag_succ(diag, dsucc):
    """Phase 1 with next hops: both operands are the evolving tile."""
    for k in range(diag.shape[-1]):
        diag, dsucc = relax_succ(k, diag, dsucc, diag, dsucc, diag)
    return diag, dsucc


def close_bands_succ(w, succ, diag, dsucc, b: int):
    """Phase 2 with next hops → (row, rsucc, col, csucc).

    Row band: the a-side is the closed diag and its successor tile.  Col
    band: the a-side is the band's own evolving columns."""
    s = diag.shape[-1]
    o = _pivot(b, s)
    row, rsucc = w[..., o, :], succ[..., o, :]
    for k in range(s):
        row, rsucc = relax_succ(k, row, rsucc, diag, dsucc, row)
    col, csucc = w[..., :, o], succ[..., :, o]
    for k in range(s):
        col, csucc = relax_succ(k, col, csucc, col, csucc, diag)
    row[..., :, o] = diag  # new tensors, not views of w
    rsucc[..., :, o] = dsucc
    col[..., o, :] = diag
    csucc[..., o, :] = dsucc
    return row, rsucc, col, csucc


def relax_succ_tiles(w, succ, row, rsucc, col, csucc, b: int):
    """Phase 3 with next hops: every tile against the closed bands, k
    ascending and unchunked, strict ``cand < t``."""
    s = row.shape[-2]
    o = _pivot(b, s)
    w, succ = w.clone(), succ.clone()
    w[..., o, :] = row
    succ[..., o, :] = rsucc
    w[..., :, o] = col
    succ[..., :, o] = csucc
    for k in range(s):
        w, succ = relax_succ(k, w, succ, col, csucc, row)
    return w, succ


def fw_round_with_successors_ref(
    w: torch.Tensor, succ: torch.Tensor, b: int, *, block_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One successor-tracking round (min-plus) — bitwise the reference's."""
    o = _pivot(b, block_size)
    diag, dsucc = close_diag_succ(w[..., o, o], succ[..., o, o])
    bands = close_bands_succ(w, succ, diag, dsucc, b)
    return relax_succ_tiles(w, succ, *bands, b)
