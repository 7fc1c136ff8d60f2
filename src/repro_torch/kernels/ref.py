"""Plain torch versions of the fused round, the 4-dispatch round's phase
kernels and semiring matmul, the rank-1 repair and the decremental repair
kernels.

Counterparts of ``repro.kernels.ref.fw_round_ref``,
``fw_round_bordered_ref`` (the distributed solve's per-rank round),
``fw_round_with_successors_ref``, ``fw_repair_ref``,
``fw_repair_with_successors_ref`` and of ``repro.kernels.fw_repair_del``'s
marking and XLA sweep twins: the same per-element ⊕/⊗ chains as the
reference, so outputs are bitwise equal to it.  Each round is split into
the three phases the CUDA kernels launch (``kernels/csrc/fw_round.cu``):

  1. ``close_diag*``  — close the (s, s) pivot tile;
  2. ``close_bands*`` — close the (s, n) row band and the (n, s) col band
     against it, the closed tile spliced in at block b;
  3. ``relax*``       — re-relax every tile against the closed bands, k
     ascending, pivot-band tiles starting from their closed values.

The 4-dispatch round (``fw_round4_ref``) is built from the plain versions
of its four kernels: ``fw_phase1_ref``, ``fw_phase2_row_ref`` /
``fw_phase2_col_ref`` (names over the chains above) and
``semiring_matmul_ref``, the k-ascending chain of ``_stage_compute``.  The
reference's ``repro.kernels.ref.semiring_matmul_ref`` reduces in XLA's
order instead, exact for min/max but not for plus_mul, so it is not
copied.

The repair is the direct per-edge loop, and beside it the two phases of
``kernels/csrc/fw_repair.cu``: ``repair_stage*`` (the evolved pivot rows)
and ``repair_apply*`` (every row folds all E updates against them).  Its
weights are carried in the matrix's dtype, as the reference's
``encode_weights`` carries their bits.

The round, repair and sweep twins are generic over the storage dtype:
f32, bf16 and f16 (each ⊗ and ⊕ rounded to the storage type by torch's
16-bit ops, f16 plus_mul's step one FMA rounded once), the saturating
int16 lowerings, the bit-packed or_and words
and the int32 carrier of an integer or_and / plus_mul storage, through
the lowering's own ``Semiring`` ops; the successor twins take f32, bf16
and f16 distances.

``flash_decode_ref`` is the masked-softmax oracle of single-token decode
attention and ``flash_decode_online_ref`` the block-by-block online
softmax of the reference's ``_decode_kernel``.

The decremental repair is ``mark_affected*`` (stage 1, torch ops on any
device) and the restricted row sweep, whose rounds are the three launches
of ``kernels/csrc/fw_repair_del.cu``, built from the round's own chains:
``sweep_diag*`` (close the overlaid pivot tile), ``sweep_panels*`` (close
the overlaid (s, m) band and the strip's pivot block column) and
``sweep_relax*`` (relax the (a_pad, m) strip of affected rows, then splice
the band rows into the strip rows inside the pivot block).

They run on any device and are what ``kernels.fw_round``,
``kernels.fw_phase1``, ``kernels.fw_phase2``, ``kernels.minplus_matmul``,
``kernels.fw_repair`` and ``kernels.fw_repair_del`` compute for a tensor
on the CPU.  On the card they
are the yardstick the kernels are held against; the main path never calls
them there.  All are functional (they return new tensors); the round
functions and ``fw_repair_ref`` are batch-rank-agnostic, the other repair
functions take (n, n).  ``mark_affected*`` are what the card runs too.
"""
from __future__ import annotations

import torch

from repro_torch.core.paths import _init_successors, relax_succ
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


def close_row_panel(p: torch.Tensor, diag: torch.Tensor, semiring: Semiring) -> torch.Tensor:
    """Phase 2, row band: p[r, c] ⊕= diag[r, k] ⊗ p[k, c], k ascending.
    Returns a new tensor."""
    for k in range(diag.shape[-1]):
        p = semiring.relax(p, diag[..., :, k, None], p[..., k, None, :])
    return p


def close_col_panel(p: torch.Tensor, diag: torch.Tensor, semiring: Semiring) -> torch.Tensor:
    """Phase 2, col band: p[r, c] ⊕= p[r, k] ⊗ diag[k, c], k ascending.
    Returns a new tensor."""
    for k in range(diag.shape[-1]):
        p = semiring.relax(p, p[..., :, k, None], diag[..., k, None, :])
    return p


def close_bands(
    w: torch.Tensor, diag: torch.Tensor, b: int, semiring: Semiring
) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase 2: (row, col) bands of round b closed against the closed diag."""
    o = _pivot(b, diag.shape[-1])
    row = close_row_panel(w[..., o, :], diag, semiring)
    col = close_col_panel(w[..., :, o], diag, semiring)
    row[..., :, o] = diag  # row and col are new tensors, not views of w
    col[..., o, :] = diag
    return row, col


def _relax_tile(c, a, bb, bk: int, semiring: Semiring, variant: str) -> torch.Tensor:
    """c ⊕= a ⊗ bb through bk-deep ``_stage_compute`` stages, k ascending."""
    for k0 in range(0, a.shape[-1], bk):
        c = _stage_compute(c, a[..., :, k0:k0 + bk], bb[..., k0:k0 + bk, :], semiring, variant)
    return c


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
    return _relax_tile(w, col, row, bk, semiring, variant)


def fw_round_ref(
    w: torch.Tensor, b: int, *, block_size: int, bk: int = 32,
    variant: str = "fori", semiring: Semiring = MIN_PLUS,
) -> torch.Tensor:
    """One fused pivot round b of (…, n, n) w — bitwise the reference's."""
    o = _pivot(b, block_size)
    diag = close_diag(w[..., o, o], semiring)
    row, col = close_bands(w, diag, b, semiring)
    return relax(w, row, col, b, bk=bk, variant=variant, semiring=semiring)


def _echo(w: torch.Tensor, dim: int, at: int, s: int, value: torch.Tensor) -> None:
    """Write value over block ``at`` of w along ``dim`` (-2 rows, -1 cols),
    in place; ``at < 0`` (no owner echo) writes nothing."""
    if at >= 0:
        w.narrow(dim, at * s, s).copy_(value)


def close_bordered_bands(
    w: torch.Tensor, diag: torch.Tensor, owner_row: int, owner_col: int,
    semiring: Semiring,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase 2 of a bordered round: the border row (…, s, cols) and column
    (…, rows, s) closed against the closed corner, which is spliced in at
    block 0 and at the owner-echo blocks (``owner_col`` of the row band,
    ``owner_row`` of the col band; -1 = none)."""
    s = diag.shape[-1]
    row = close_row_panel(w[..., :s, :], diag, semiring)
    row[..., :, :s] = diag
    _echo(row, -1, owner_col, s, diag)
    col = close_col_panel(w[..., :, :s], diag, semiring)
    col[..., :s, :] = diag
    _echo(col, -2, owner_row, s, diag)
    return row, col


def relax_bordered(
    w: torch.Tensor, row: torch.Tensor, col: torch.Tensor, owner_row: int,
    owner_col: int, *, bk: int = 32, variant: str = "fori",
    semiring: Semiring = MIN_PLUS,
) -> torch.Tensor:
    """Phase 3 of a bordered round: every tile ⊕= col ⊗ row in bk chunks, k
    ascending; the border and the owner-echo rows / columns start from the
    closed band values."""
    s = row.shape[-2]
    w = w.clone()
    w[..., :s, :] = row
    w[..., :, :s] = col
    _echo(w, -2, owner_row, s, row)
    _echo(w, -1, owner_col, s, col)
    return _relax_tile(w, col, row, _fit_block(s, bk), semiring, variant)


def fw_round_bordered_ref(
    w: torch.Tensor, owner_row: int = -1, owner_col: int = -1, *,
    block_size: int, bk: int = 32, variant: str = "fori",
    semiring: Semiring = MIN_PLUS,
) -> torch.Tensor:
    """One bordered round of (…, rows, cols) w — bitwise the reference's
    ``fw_round_bordered_ref``.

    The pivot is pinned at tile (0, 0): phase 1 closes the (s, s) corner,
    phase 2 the border row and column (``close_bordered_bands``), phase 3
    relaxes every tile (``relax_bordered``).  ``owner_row`` / ``owner_col``
    are the bordered tile coordinates at which the rank's local block holds
    its copy of the global pivot row / column band, -1 where it holds none:
    the closed corner and bands are spliced over those copies."""
    s = block_size
    diag = close_diag(w[..., :s, :s], semiring)
    row, col = close_bordered_bands(w, diag, owner_row, owner_col, semiring)
    return relax_bordered(w, row, col, owner_row, owner_col, bk=bk, variant=variant,
                          semiring=semiring)


# ------------------------------------------- phase kernels and the matmul
def semiring_matmul_ref(a, b, c=None, *, semiring: Semiring = MIN_PLUS,
                        bk: int = 32) -> torch.Tensor:
    """C [⊕=] A ⊗⊕ B, (m,k)·(k,n) or batched, as the k-ascending chain of
    ``_stage_compute`` in bk chunks, from C or from the ⊕-identity."""
    if c is None:
        c = torch.full((*a.shape[:-1], b.shape[-1]), semiring.zero,
                       dtype=a.dtype, device=a.device)
    return _relax_tile(c, a, b, _fit_block(a.shape[-1], bk), semiring, "fori")


def fw_phase1_ref(tile, *, semiring: Semiring = MIN_PLUS) -> torch.Tensor:
    """Closure of a (…, s, s) diagonal tile."""
    return close_diag(tile, semiring)


def fw_phase2_row_ref(diag, panel, *, semiring: Semiring = MIN_PLUS) -> torch.Tensor:
    """Row band (…, s, t) closed against the closed diag, every tile."""
    return close_row_panel(panel, diag, semiring)


def fw_phase2_col_ref(diag, panel, *, semiring: Semiring = MIN_PLUS) -> torch.Tensor:
    """Col band (…, t, s) closed against the closed diag, every tile."""
    return close_col_panel(panel, diag, semiring)


def fw_phase3_ref(w, col_band, row_band, *, semiring: Semiring = MIN_PLUS,
                  bk: int = 32) -> torch.Tensor:
    """W ⊕= col_band ⊗ row_band, k ascending."""
    return semiring_matmul_ref(col_band, row_band, w, semiring=semiring, bk=bk)


def fw_round4_ref(w, b: int, *, block_size: int, bk: int = 32,
                  semiring: Semiring = MIN_PLUS) -> torch.Tensor:
    """One round of the 4-dispatch lowering (``repro.core.staged.fw_staged
    (fused=False)``): phase 1, both phase-2 bands over all their tiles, the
    closed diag spliced over each band's pivot tile, both bands written
    into w, then phase 3 over the whole matrix."""
    o = _pivot(b, block_size)
    diag = fw_phase1_ref(w[..., o, o], semiring=semiring)
    row = fw_phase2_row_ref(diag, w[..., o, :], semiring=semiring)
    row[..., :, o] = diag
    col = fw_phase2_col_ref(diag, w[..., :, o], semiring=semiring)
    col[..., o, :] = diag
    w = w.clone()
    w[..., o, :] = row
    w[..., :, o] = col
    return fw_phase3_ref(w, col, row, semiring=semiring, bk=min(bk, block_size))


# ------------------------------------------------------ successor round
def close_diag_succ(diag, dsucc):
    """Phase 1 with next hops: both operands are the evolving tile."""
    for k in range(diag.shape[-1]):
        diag, dsucc = relax_succ(k, diag, dsucc, diag, dsucc, diag)
    return diag, dsucc


def close_row_panel_succ(p, ps, diag, dsucc):
    """Phase 2 row band with next hops: the a-side is the closed diag and
    its successor tile."""
    for k in range(diag.shape[-1]):
        p, ps = relax_succ(k, p, ps, diag, dsucc, p)
    return p, ps


def close_col_panel_succ(p, ps, diag):
    """Phase 2 col band with next hops: the a-side is the band's own
    evolving columns."""
    for k in range(diag.shape[-1]):
        p, ps = relax_succ(k, p, ps, p, ps, diag)
    return p, ps


def _relax_succ_tile(t, ts, a, asucc, bb):
    """t ⊕= a ⊗ bb with next hops, k ascending and unchunked, strict <."""
    for k in range(a.shape[-1]):
        t, ts = relax_succ(k, t, ts, a, asucc, bb)
    return t, ts


def close_bands_succ(w, succ, diag, dsucc, b: int):
    """Phase 2 with next hops → (row, rsucc, col, csucc).

    Row band: the a-side is the closed diag and its successor tile.  Col
    band: the a-side is the band's own evolving columns."""
    o = _pivot(b, diag.shape[-1])
    row, rsucc = close_row_panel_succ(w[..., o, :], succ[..., o, :], diag, dsucc)
    col, csucc = close_col_panel_succ(w[..., :, o], succ[..., :, o], diag)
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
    return _relax_succ_tile(w, succ, col, csucc, row)


def fw_round_with_successors_ref(
    w: torch.Tensor, succ: torch.Tensor, b: int, *, block_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One successor-tracking round (min-plus) — bitwise the reference's."""
    o = _pivot(b, block_size)
    diag, dsucc = close_diag_succ(w[..., o, o], succ[..., o, o])
    bands = close_bands_succ(w, succ, diag, dsucc, b)
    return relax_succ_tiles(w, succ, *bands, b)


# ---------------------------------------------------------- rank-1 repair
def _edge_lists(u, v, w, d):
    """Host index lists and the weight vector in d's dtype on d's device:
    a bf16 step then rounds in bf16, and an int16 or lane-mask weight
    stays an integer (the reference's ``encode_weights`` carries the bits
    of the matrix dtype)."""
    as_list = lambda x: (x.tolist() if isinstance(x, torch.Tensor)  # noqa: E731
                         else [int(i) for i in x])
    w = (w if isinstance(w, torch.Tensor) else torch.as_tensor(w)).to(d.device, d.dtype)
    return as_list(u), as_list(v), w


def fw_repair_ref(d, u, v, w, *, semiring: Semiring = MIN_PLUS) -> torch.Tensor:
    """E sequential rank-1 updates ``d ⊕= (d[:, u_e] ⊗ w_e) ⊗ d[v_e, :]``,
    each on the whole matrix as it stands after the previous one; batch-
    rank-agnostic.  plus_mul's step is ``addcmul(d, d[:, u] * w, d[v, :])``,
    one FMA, as XLA contracts the reference."""
    u, v, w = _edge_lists(u, v, w, d)
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
    u, v, w = _edge_lists(u, v, w, d)
    for e in range(len(u)):
        d, succ = _succ_step(d, succ, u[e], v[e], d[:, u[e], None] + w[e], d[None, v[e], :])
    return d, succ


def repair_stage_ref(d, u, v, w, *, semiring: Semiring = MIN_PLUS,
                     strict: bool = False) -> torch.Tensor:
    """The stage launch: (E, n) rows, row g = row v_g of d after updates
    e < g.  Step t folds edge t into rows g > t, whose row t is final then.
    ``strict``: the successor repair's distance step (min-plus, take the
    candidate only where it is strictly smaller)."""
    u, v, w = _edge_lists(u, v, w, d)
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
    u, _, w = _edge_lists(u, u, w, d)
    for e in range(len(u)):
        d = semiring.relax(d, semiring.mul(d[:, u[e], None], w[e]), staged[e, None, :])
    return d


def repair_apply_succ_ref(d, succ, staged, u, v, w):
    """The successor apply launch (min-plus, strict ``<``)."""
    u, v, w = _edge_lists(u, v, w, d)
    for e in range(len(u)):
        d, succ = _succ_step(d, succ, u[e], v[e], d[:, u[e], None] + w[e], staged[e, None, :])
    return d, succ


def repair_scalars_ref(d, staged, u, v, w, *, semiring: Semiring = MIN_PLUS, succ=None):
    """The row scalars the stage launch writes beside the staged rows:
    ``(scal, hops)``, scal (n, E) with scal[i, e] = (row i at column u_e
    before step e) ⊗ w_e, each row evolving against staged[e, u_b] (b > e).
    With ``succ`` (the successor repair: min-plus, strict ``<``) also hops
    (n, E) int32, the hop an improvement of row i at step e takes: v_e on
    row u_e, else row i's hop at column u_e before step e; else None."""
    u, v, w = _edge_lists(u, v, w, d)
    E = len(u)
    y = d[:, u]  # advanced indexing: a copy
    scal = torch.empty_like(y)
    ys = hops = None
    if succ is not None:
        ys, hops = succ[:, u], torch.empty_like(succ[:, u])
        rows = torch.arange(d.shape[0], device=d.device)
    for e in range(E):
        a = semiring.mul(y[:, e], w[e])
        scal[:, e] = a
        rest, pu = y[:, e + 1:], staged[e, u[e + 1:]][None, :]
        if succ is None:
            y[:, e + 1:] = semiring.relax(rest, a[:, None], pu)
            continue
        h = torch.where(rows == u[e], torch.tensor(v[e], dtype=ys.dtype, device=d.device),
                        ys[:, e])
        hops[:, e] = h
        cand = a[:, None] + pu
        better = cand < rest
        y[:, e + 1:] = torch.where(better, cand, rest)
        ys[:, e + 1:] = torch.where(better, h[:, None], ys[:, e + 1:])
    return scal, hops


def repair_stream_ref(d, scal, staged, *, semiring: Semiring = MIN_PLUS) -> torch.Tensor:
    """The apply launch on the stage's buffers: ``d ⊕ scal ⊗ staged``, a
    rank-E update with e ascending (== ``repair_apply_ref``)."""
    for e in range(staged.shape[0]):
        d = semiring.relax(d, scal[:, e, None], staged[e, None, :])
    return d


def repair_stream_succ_ref(d, succ, scal, hops, staged):
    """The successor apply launch on the stage's buffers: a candidate
    scal[i, e] + staged[e, j] taken only where strictly smaller, with its
    hop hops[i, e] (== ``repair_apply_succ_ref``)."""
    for e in range(staged.shape[0]):
        cand = scal[:, e, None] + staged[e, None, :]
        better = cand < d
        d = torch.where(better, cand, d)
        succ = torch.where(better, hops[:, e, None], succ)
    return d, succ


# ----------------------------------------------------- decremental repair
def _affected_mask(dist, u, v, wold, ecount, semiring: Semiring) -> torch.Tensor:
    """Bool (m, m): pairs whose closure value is witnessed through a live
    deleted edge, ``dist[i, u] ⊗ w_old ⊗ dist[v, j] == dist[i, j] ≠ 0̄``;
    for the packed lowering an int32 lane mask (m, m), the OR of the
    witnesses ``dist[i, u] & w_old & dist[v, j]``: the lanes whose
    reachability went through the deleted bits.  Edges at index >= ecount
    are padding and skipped."""
    u, v, wold = _edge_lists(u, v, wold, dist)
    dt = torch.int32 if semiring.packed else torch.bool
    aff = torch.zeros(dist.shape, dtype=dt, device=dist.device)
    for e in range(min(int(ecount), len(u))):
        wit = semiring.mul(semiring.mul(dist[:, u[e], None], wold[e]), dist[None, v[e], :])
        aff |= wit if semiring.packed else wit == dist
    return aff if semiring.packed else aff & (dist != semiring.zero)


def mark_affected(dist, w1, u, v, wold, ecount, *, semiring: Semiring = MIN_PLUS):
    """Stage 1: (d_init, affected-row mask (m,), affected-entry count).

    d_init resets every affected entry to its direct edge in the updated
    weights ``w1`` and keeps the (final) closure value elsewhere; for the
    packed lowering, only in the affected lanes of each word."""
    aff = _affected_mask(dist, u, v, wold, ecount, semiring)
    if semiring.packed:
        d_init, aff = (dist & ~aff) | (w1 & aff), aff != 0
    else:
        d_init = torch.where(aff, w1, dist)
    return d_init, aff.any(dim=-1), aff.sum(dtype=torch.int32)


def mark_affected_with_successors(dist, succ, w1, u, v, wold, ecount, *,
                                  semiring: Semiring = MIN_PLUS):
    """Stage 1 with next hops: affected entries also reset their successor
    to the direct-edge start state of a re-solve of ``w1``."""
    aff = _affected_mask(dist, u, v, wold, ecount, semiring)
    return (torch.where(aff, w1, dist), torch.where(aff, _init_successors(w1), succ),
            aff.any(dim=-1), aff.sum(dtype=torch.int32))


def _band_overlay(static, strip, rows, o: int, s: int):
    """The (s, m) pivot band at row offset o: rows of ``static``, with the
    strip rows that lie in [o, o+s) spliced in.  Returns (band, in_blk,
    local): which strip rows lie in the block and their offsets in it."""
    local = rows - o
    in_blk = (local >= 0) & (local < s)
    band = static[o:o + s].clone()
    band[local[in_blk]] = strip[in_blk]
    return band, in_blk, local


def _splice_in_block(strip, band, in_blk, local):
    """Strip rows inside the pivot block take their band-closed rows."""
    closed = band[torch.where(in_blk, local, 0)]
    return torch.where(in_blk[:, None], closed, strip)


def _rows(rows, device) -> torch.Tensor:
    return torch.as_tensor(rows, dtype=torch.int64).to(device)


def sweep_diag_ref(d_init, strip, rows, b: int, *, block_size: int,
                   semiring: Semiring = MIN_PLUS) -> torch.Tensor:
    """Launch 1 of round b: the overlaid (s, s) pivot tile, closed."""
    s = block_size
    band, _, _ = _band_overlay(d_init, strip, _rows(rows, strip.device), b * s, s)
    return close_diag(band[:, _pivot(b, s)], semiring)


def sweep_panels_ref(d_init, strip, rows, diag, b: int, *,
                     semiring: Semiring = MIN_PLUS):
    """Launch 2 of round b → (band, acol): the overlaid (s, m) band closed
    against ``diag`` with it spliced in at block b, and the strip's block
    column b (a_pad, s) closed against it."""
    s = diag.shape[-1]
    o = _pivot(b, s)
    band, _, _ = _band_overlay(d_init, strip, _rows(rows, strip.device), b * s, s)
    band = close_row_panel(band, diag, semiring)
    band[:, o] = diag
    return band, close_col_panel(strip[:, o], diag, semiring)


def sweep_relax_ref(strip, rows, band, acol, b: int, *, bk: int = 32,
                    variant: str = "fori", semiring: Semiring = MIN_PLUS) -> torch.Tensor:
    """Launch 3 of round b: the whole strip, its block column b starting
    from ``acol``, relaxed against acol ⊗ band in bk chunks; strip rows
    inside the pivot block then take their band rows."""
    s = acol.shape[-1]
    strip = strip.clone()
    strip[:, _pivot(b, s)] = acol
    strip = _relax_tile(strip, acol, band, _fit_block(s, bk), semiring, variant)
    local = _rows(rows, strip.device) - b * s
    return _splice_in_block(strip, band, (local >= 0) & (local < s), local)


def _gather_strip(t, rows):
    """Rows of t, padding index m clipped to row m-1 (an inert copy)."""
    return t[rows.clamp(max=t.shape[-1] - 1)]


def _scatter_strip(t, rows, strip):
    """t with the strip's real rows written back; padding rows drop."""
    out = t.clone()
    keep = rows < t.shape[-1]
    out[rows[keep]] = strip[keep]
    return out


def fw_repair_del_sweep_ref(d_init, rows, *, block_size: int, bk: int = 32,
                            variant: str = "fori", semiring: Semiring = MIN_PLUS):
    """The restricted row sweep: T rounds of the three phases above over
    the (a_pad, m) strip of affected rows ``rows`` (padded with m), then
    the strip written back into a copy of d_init (m, m)."""
    s, m = block_size, d_init.shape[-1]
    rows = _rows(rows, d_init.device)
    strip = _gather_strip(d_init, rows)
    for b in range(m // s):
        diag = sweep_diag_ref(d_init, strip, rows, b, block_size=s, semiring=semiring)
        band, acol = sweep_panels_ref(d_init, strip, rows, diag, b, semiring=semiring)
        strip = sweep_relax_ref(strip, rows, band, acol, b, bk=bk, variant=variant,
                                semiring=semiring)
    return _scatter_strip(d_init, rows, strip)


def sweep_diag_succ_ref(d_init, s_init, strip, strip_s, rows, b: int, *, block_size: int):
    """Successor launch 1: (diag, dsucc) of the overlaid pivot tile."""
    s = block_size
    o = _pivot(b, s)
    rows = _rows(rows, strip.device)
    band, _, _ = _band_overlay(d_init, strip, rows, b * s, s)
    band_s, _, _ = _band_overlay(s_init, strip_s, rows, b * s, s)
    return close_diag_succ(band[:, o], band_s[:, o])


def sweep_panels_succ_ref(d_init, s_init, strip, strip_s, rows, diag, dsucc, b: int):
    """Successor launch 2 → (band, band_s, acol, acol_s)."""
    s = diag.shape[-1]
    o = _pivot(b, s)
    rows = _rows(rows, strip.device)
    band, _, _ = _band_overlay(d_init, strip, rows, b * s, s)
    band_s, _, _ = _band_overlay(s_init, strip_s, rows, b * s, s)
    band, band_s = close_row_panel_succ(band, band_s, diag, dsucc)
    band[:, o] = diag
    band_s[:, o] = dsucc
    acol, acol_s = close_col_panel_succ(strip[:, o], strip_s[:, o], diag)
    return band, band_s, acol, acol_s


def sweep_relax_succ_ref(strip, strip_s, rows, band, band_s, acol, acol_s, b: int):
    """Successor launch 3 → (strip, strip_s)."""
    s = acol.shape[-1]
    o = _pivot(b, s)
    strip, strip_s = strip.clone(), strip_s.clone()
    strip[:, o] = acol
    strip_s[:, o] = acol_s
    strip, strip_s = _relax_succ_tile(strip, strip_s, acol, acol_s, band)
    local = _rows(rows, strip.device) - b * s
    in_blk = (local >= 0) & (local < s)
    return (_splice_in_block(strip, band, in_blk, local),
            _splice_in_block(strip_s, band_s, in_blk, local))


def fw_repair_del_sweep_with_successors_ref(d_init, s_init, rows, *, block_size: int):
    """The min-plus sweep carrying next hops: every phase takes a candidate
    only where it is strictly smaller.  Returns (dist, succ)."""
    s, m = block_size, d_init.shape[-1]
    rows = _rows(rows, d_init.device)
    strip, strip_s = _gather_strip(d_init, rows), _gather_strip(s_init, rows)
    for b in range(m // s):
        diag, dsucc = sweep_diag_succ_ref(d_init, s_init, strip, strip_s, rows, b,
                                          block_size=s)
        band, band_s, acol, acol_s = sweep_panels_succ_ref(
            d_init, s_init, strip, strip_s, rows, diag, dsucc, b)
        strip, strip_s = sweep_relax_succ_ref(strip, strip_s, rows, band, band_s,
                                              acol, acol_s, b)
    return _scatter_strip(d_init, rows, strip), _scatter_strip(s_init, rows, strip_s)


# ------------------------------------------------------------ flash decode
NEG_INF = -1e30  # the reference's mask value: kv_len = 0 averages v, no NaN


def _logits(q, k, kv_len, start: int = 0):
    """(B, Hkv, g, rows) f32 logits of q against k rows [start, start+rows),
    positions at or past kv_len set to NEG_INF."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhgd,bshd->bhgs", q.float(), k.float()) * scale
    pos = torch.arange(start, start + k.shape[1], device=k.device)
    return torch.where(pos < kv_len, logits, NEG_INF)


def flash_decode_ref(q, k, v, kv_len) -> torch.Tensor:
    """Masked softmax attention of one decode token: q (B,Hkv,g,hd), k/v
    (B,S,Hkv,hd), kv_len an int or a 0-d tensor → (B,Hkv,g,hd) in q's
    dtype; f32 math."""
    p = torch.softmax(_logits(q, k, kv_len), dim=-1)
    return torch.einsum("bhgs,bshd->bhgd", p, v.float()).to(q.dtype)


def flash_decode_online_ref(q, k, v, kv_len, bs: int = 256) -> torch.Tensor:
    """The reference kernel's walk: bs-row K/V blocks in order, a running
    max m, sum l and accumulator in f32 (bs becomes S when it does not
    divide S)."""
    S = k.shape[1]
    if S % bs:
        bs = S
    lead = q.shape[:-1]
    m = torch.full((*lead, 1), NEG_INF, device=q.device)
    l = torch.zeros((*lead, 1), device=q.device)
    acc = torch.zeros(q.shape, device=q.device)
    for k0 in range(0, S, bs):
        logits = _logits(q, k[:, k0:k0 + bs], kv_len, k0)
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        m = m_new
        acc = acc * alpha + torch.einsum("bhgs,bshd->bhgd", p, v[:, k0:k0 + bs].float())
    return (acc / l).to(q.dtype)
