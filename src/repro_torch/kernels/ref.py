"""Plain torch versions of the fused round and rank-1 repair kernels.

Counterparts of ``repro.kernels.ref.fw_round_ref``,
``fw_round_with_successors_ref``, ``fw_repair_ref`` and
``fw_repair_with_successors_ref``: the same per-element ⊕/⊗ chains as the
reference, so outputs are bitwise equal to it.  Each round is split into
the three phases the CUDA kernels launch (``kernels/csrc/fw_round.cu``):

  1. ``close_diag*``  — close the (s, s) pivot tile;
  2. ``close_bands*`` — close the (s, n) row band and the (n, s) col band
     against it, the closed tile spliced in at block b;
  3. ``relax*``       — re-relax every tile against the closed bands, k
     ascending, pivot-band tiles starting from their closed values.

The repair is the direct per-edge loop, and beside it the two phases of
``kernels/csrc/fw_repair.cu``: ``repair_stage*`` (the evolved pivot rows)
and ``repair_apply*`` (every row folds all E updates against them).

They run on any device and are what ``kernels.fw_round`` and
``kernels.fw_repair`` compute for a tensor on the CPU.  On the card they
are the yardstick the kernels are held against; the main path never calls
them there.  All are functional (they return new tensors); the round
functions and ``fw_repair_ref`` are batch-rank-agnostic, the other repair
functions take (n, n).
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


# ---------------------------------------------------------- rank-1 repair
def _edge_lists(u, v, w, device):
    """Host index lists and an f32 weight vector on ``device``."""
    as_list = lambda x: (x.tolist() if isinstance(x, torch.Tensor)  # noqa: E731
                         else [int(i) for i in x])
    w = torch.as_tensor(w, dtype=torch.float32).to(device)
    return as_list(u), as_list(v), w


def fw_repair_ref(d, u, v, w, *, semiring: Semiring = MIN_PLUS) -> torch.Tensor:
    """E sequential rank-1 updates ``d ⊕= (d[:, u_e] ⊗ w_e) ⊗ d[v_e, :]``,
    each on the whole matrix as it stands after the previous one; batch-
    rank-agnostic.  plus_mul's step is ``addcmul(d, d[:, u] * w, d[v, :])``,
    one FMA, as XLA contracts the reference."""
    u, v, w = _edge_lists(u, v, w, d.device)
    for e in range(len(u)):
        d = semiring.relax(d, semiring.mul(d[..., :, u[e], None], w[e]),
                           d[..., v[e], None, :])
    return d


def _succ_step(d, succ, ue: int, ve: int, a, b):
    """Strict-improvement step: cand = a + b; where cand < d the next hop
    becomes v_e on row u_e and succ[:, u_e] (before the step) elsewhere."""
    cand = a + b
    better = cand < d
    rows = torch.arange(d.shape[0], device=d.device)[:, None]
    hop = torch.where(rows == ue, torch.tensor(ve, dtype=torch.int32, device=d.device),
                      succ[:, ue, None])
    return torch.where(better, cand, d), torch.where(better, hop, succ)


def fw_repair_with_successors_ref(d, succ, u, v, w):
    """The min-plus repair carrying the int32 next-hop table (2-D):
    candidates ``(d[:, u] + w) + d[v, :]``, taken only where strictly
    smaller."""
    u, v, w = _edge_lists(u, v, w, d.device)
    for e in range(len(u)):
        d, succ = _succ_step(d, succ, u[e], v[e], d[:, u[e], None] + w[e], d[None, v[e], :])
    return d, succ


def repair_stage_ref(d, u, v, w, *, semiring: Semiring = MIN_PLUS,
                     strict: bool = False) -> torch.Tensor:
    """The stage launch: (E, n) rows, row g = row v_g of d after updates
    e < g.  Step t folds edge t into rows g > t, whose row t is final then.
    ``strict``: the successor repair's distance step (min-plus, take the
    candidate only where it is strictly smaller)."""
    u, v, w = _edge_lists(u, v, w, d.device)
    P = d[v, :]  # advanced indexing: a copy
    for t in range(len(u) - 1):
        rest = P[t + 1:]
        a = semiring.mul(rest[:, u[t], None], w[t])
        if strict:
            cand = a + P[t, None, :]
            P[t + 1:] = torch.where(cand < rest, cand, rest)
        else:
            P[t + 1:] = semiring.relax(rest, a, P[t, None, :])
    return P


def repair_apply_ref(d, staged, u, w, *, semiring: Semiring = MIN_PLUS) -> torch.Tensor:
    """The apply launch: every row folds the E updates in order, with the
    staged row e in place of row v_e."""
    u, _, w = _edge_lists(u, u, w, d.device)
    for e in range(len(u)):
        d = semiring.relax(d, semiring.mul(d[:, u[e], None], w[e]), staged[e, None, :])
    return d


def repair_apply_succ_ref(d, succ, staged, u, v, w):
    """The successor apply launch (min-plus, strict ``<``)."""
    u, v, w = _edge_lists(u, v, w, d.device)
    for e in range(len(u)):
        d, succ = _succ_step(d, succ, u[e], v[e], d[:, u[e], None] + w[e], staged[e, None, :])
    return d, succ
