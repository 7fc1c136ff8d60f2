"""Distributed blocked Floyd-Warshall on an R×C process grid.

Counterpart of ``repro.core.distributed``.  W (n, n) — or (B, n, n) — is
block-distributed over a ``launch.mesh.GridMesh``: rank (r, c) holds the
(n/R, n/C) block of rows r·n/R… and columns c·n/C….  Per pivot round b of
width s:

  1. the raw (s, s) pivot tile is broadcast from its owner to the whole
     grid, the raw (s, n/C) row-panel slice along each grid column and the
     raw (n/R, s) column-panel slice along each grid row;
  2. every rank closes them and relaxes its block against them.

Per rank and round that is s² + s·n/C + s·n/R words, over n/s rounds the
SUMMA bound n²(1/R + 1/C) plus the diagonal term
(``apsp.plan.dist_round_comm_bytes``); ``GridMesh.comm_bytes`` counts what
the ranks hand to collectives, which equals that model.

The reference broadcasts by a masked ⊕-reduce (the owner contributes its
slice, every other device the ⊕-identity).  Here the owner's rank
broadcasts (``dist.broadcast`` within the grid row, the grid column, or
the world for the pivot tile): the same bytes, and exact for every value,
where a sum turns -0.0 into +0.0 and gloo's MIN / MAX need not propagate
NaN as ``min.NaN`` does.

Storage.  The solve runs in w's own storage: f32, or any lowering the
fused round takes (bf16 / f16 with the five semirings, int16 with the
``*_i16`` lowerings, packed or_and words, the int32 carrier of an integer
or_and / plus_mul storage).  The bordered buffer, the transfer buffers
and the band buffers are allocated in that dtype, and the broadcasts move
its bytes (``GridMesh.broadcast``), so a rank hands 2-byte words to the
collectives in bf16 / f16 / int16 and 4-byte ones for packed and int32.

Step 2 has three lowerings, picked by ``backend``:

  * ``"fused"`` (default) — each rank keeps ONE bordered buffer (B, s+n_r,
    s+n_c) for the whole solve, whose ``[..., s:, s:]`` view is its local
    block; a round writes the broadcast pivot tile and panel slices into
    the border and runs the paper's round on the whole buffer as one
    bordered round (``kernels.fw_round.fw_round_bordered``: three launches
    on the card, its plain twin on the CPU).  The owner-echo coordinates
    splice the closed border over the rank's own copies of the global
    pivot bands, which makes the distributed solve bitwise equal to the
    single-device fused solve on every semiring.  The reference instead
    concatenates a new bordered matrix every round; here the local block
    is copied in once and out once.
  * ``"jnp"`` — the reference's per-phase lowering in plain torch: close
    the tile and the panels, write the panels back on their owners, relax
    the block in k-chunks of 8, each chunk ⊕-folded from the ⊕-identity.
  * ``"pallas"`` — the same with phase 3 on the ``semiring_matmul`` kernel.
  Both run every storage and are bitwise the reference's per-phase
  lowerings.  They re-close the
  pivot tile inside the panels (for plus_mul that counts its paths again)
  and fold phase 3 in another order than the fused round, so only where
  ⊕ and ⊗ round nothing (max_min, or_and) are they bitwise the fused
  solve.

``phase2_shard`` (the reference's all-gathered panel closure) needs
``all_gather``, which gloo does not offer for CUDA tensors: it raises
``NotImplementedError`` (ROADMAP A.11).

Fault tolerance: any round boundary is a consistent checkpoint and
re-running a round is harmless; ``fw_distributed`` runs ``rounds_per_call``
rounds between calls of ``checkpoint_cb`` and restarts at ``start_round``.

``build_repair_shard_fn`` is the distributed rank-1 repair: per edge, the
current column u_e and row v_e are broadcast from their owners along the
grid rows / columns and every rank applies the per-edge chain of
``kernels.ref.fw_repair_ref`` to its block, in the block's storage, so the
result is bitwise the single-device repair.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.semiring import MIN_PLUS, Semiring
from repro_torch.kernels import fw_round as _fr
from repro_torch.kernels import ref
from repro_torch.kernels.minplus_matmul import check_variant, semiring_matmul, storage_tag

BACKENDS = ("fused", "jnp", "pallas")


def local_shape(n: int, mesh) -> tuple[int, int]:
    """(n_r, n_c) of a rank's block; raises when n does not divide."""
    if n % mesh.R or n % mesh.C:
        raise ValueError(f"n={n} must divide over the {mesh.R}x{mesh.C} grid")
    return n // mesh.R, n // mesh.C


def local_block(w: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's (…, n/R, n/C) block of the full (…, n, n) w (a view)."""
    n_r, n_c = local_shape(w.shape[-1], mesh)
    return w[..., mesh.my_r * n_r:(mesh.my_r + 1) * n_r,
             mesh.my_c * n_c:(mesh.my_c + 1) * n_c]


def gather(wl: torch.Tensor, mesh) -> torch.Tensor:
    """The full (…, n, n) matrix on every rank from each rank's (…, n_r, n_c)
    block: R·C broadcasts over the grid (gloo has no all_gather for CUDA
    tensors)."""
    n_r, n_c = wl.shape[-2:]
    if mesh.R * mesh.C == 1:
        return wl.contiguous()
    out = wl.new_empty((*wl.shape[:-2], n_r * mesh.R, n_c * mesh.C))
    buf = torch.empty_like(wl, memory_format=torch.contiguous_format)
    for r in range(mesh.R):
        for c in range(mesh.C):
            src = mesh.rank_of(r, c)
            if src == mesh.rank:
                buf.copy_(wl)
            mesh.broadcast(buf, src)
            out[..., r * n_r:(r + 1) * n_r, c * n_c:(c + 1) * n_c] = buf
    return out


def _bcast(mesh, dst: torch.Tensor, src: torch.Tensor, owner: int, group, buf) -> None:
    """dst ← src as it stands on rank ``owner``, over ``group``; src is read
    on the owner only, ``buf`` is the contiguous transfer buffer."""
    if mesh.group_size(group) == 1:
        dst.copy_(src)
        return
    if mesh.rank == owner:
        buf.copy_(src)
    mesh.broadcast(buf, owner, group)
    if dst is not buf:
        dst.copy_(buf)


def _phase3_chunked(w, col_panel, row_panel, semiring: Semiring, chunk: int = 8):
    """w ⊕= col_panel ⊗ row_panel in k-chunks of ``chunk`` (one chunk when
    it does not divide s): each chunk's product is ⊕-folded from the
    ⊕-identity, k ascending, then ⊕-ed into w — the reference's
    ``_phase3_jnp``, whose mul-then-⊕-reduce XLA contracts into that FMA
    chain for plus_mul in f32.  In bf16 / f16 ``jnp.sum`` adds in f32 and
    rounds once (``_sum16``)."""
    s = col_panel.shape[-1]
    chunk = chunk if s % chunk == 0 else s
    half_sum = semiring.name == "plus_mul" and w.dtype in (torch.bfloat16, torch.float16)
    for k0 in range(0, s, chunk):
        a, b = col_panel[..., :, k0:k0 + chunk], row_panel[..., k0:k0 + chunk, :]
        part = (_sum16(a, b) if half_sum else
                ref.semiring_matmul_ref(a, b, semiring=semiring, bk=chunk))
        w = semiring.add(w, part)
    return w


def _sum16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ_k a[:, k] · b[k, :] of 16-bit floats as XLA's CPU backend computes
    the reference's mul-then-``jnp.sum``: the sum in f32, k ascending,
    rounded to the storage once; each product exact in f32 for bf16 (a
    bf16 × bf16 product fits f32's mantissa) and rounded to f16 first for
    f16."""
    acc = torch.zeros((*a.shape[:-1], b.shape[-1]), dtype=torch.float32, device=a.device)
    for k in range(a.shape[-1]):
        x, y = a[..., :, k, None], b[..., k, None, :]
        acc = acc + ((x * y).float() if a.dtype == torch.float16 else x.float() * y.float())
    return acc.to(a.dtype)


def build_fw_shard_fn(
    mesh,
    n: int,
    *,
    block_size: int = 128,
    semiring: Semiring = MIN_PLUS,
    backend: str = "fused",
    bk: int = 32,
    variant: str = "fori",
    phase2_shard: bool = False,
    batched: bool = False,
) -> tuple[Callable, Callable]:
    """(step, place) of a distributed solve of padded size n on ``mesh``.

    ``place(w)`` copies this rank's block of the full (n, n) — or (B, n,
    n) with ``batched`` — w into a new bordered working buffer (B, s+n_r,
    s+n_c) in w's dtype on the mesh's device; its ``[..., s:, s:]`` view is
    the local block.  ``step(buf, first_round, num_rounds)`` runs rounds
    [first_round, first_round + num_rounds) on it in place.  Every rank
    calls both with the same arguments (the rounds are collective).
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if phase2_shard:
        raise NotImplementedError(
            "phase2_shard all-gathers the panel closures, and gloo has no "
            "all_gather for CUDA tensors: not ported yet (ROADMAP A.11)"
        )
    check_variant(variant)
    s, sr = block_size, semiring
    R, C = mesh.R, mesh.C
    n_r, n_c = local_shape(n, mesh)
    if n % (R * s) or n % (C * s):
        raise ValueError(
            f"n={n} must give per-rank blocks divisible by block_size={s} on "
            f"the {R}x{C} grid — plan through apsp.plan.distributed_plan (or "
            f"apsp.solve(method='distributed')), which pads"
        )
    state: dict = {}

    def place(w: torch.Tensor) -> torch.Tensor:
        if w.ndim != (3 if batched else 2) or tuple(w.shape[-2:]) != (n, n):
            raise ValueError(f"w must be {'(B,n,n)' if batched else '(n,n)'} with "
                             f"n={n}, got {tuple(w.shape)}")
        storage_tag(w, sr)  # the semiring's storage, never converted
        buf = torch.empty((*w.shape[:-2], s + n_r, s + n_c), dtype=w.dtype,
                          device=mesh.device)
        buf[..., s:, s:] = local_block(w, mesh)
        return buf

    def buffers(buf: torch.Tensor) -> dict:
        """Transfer buffers (and the bordered round's band buffers), made
        once per working-buffer shape."""
        key = tuple(buf.shape)
        if state.get("key") != key:
            lead = buf.shape[:-2]
            new = lambda *shape: buf.new_empty((*lead, *shape))  # noqa: E731
            state.clear()
            state.update(key=key, diag=new(s, s), row=new(s, n_c), col=new(n_r, s),
                         bands=_fr.bordered_round_buffers(buf, s) if buf.is_cuda else None)
        return state

    def one_round(buf: torch.Tensor, b: int) -> None:
        bufs = buffers(buf)
        o = b * s
        owner_r, row_in = divmod(o, n_r)
        owner_c, col_in = divmod(o, n_c)
        loc = buf[..., s:, s:]
        # The raw pivot tile and panel slices, from their owners into the border.
        _bcast(mesh, buf[..., :s, :s], loc[..., row_in:row_in + s, col_in:col_in + s],
               mesh.rank_of(owner_r, owner_c), None, bufs["diag"])
        _bcast(mesh, buf[..., :s, s:], loc[..., row_in:row_in + s, :],
               mesh.rank_of(owner_r, mesh.my_c), mesh.col_group, bufs["row"])
        _bcast(mesh, buf[..., s:, :s], loc[..., :, col_in:col_in + s],
               mesh.rank_of(mesh.my_r, owner_c), mesh.row_group, bufs["col"])
        own_r, own_c = mesh.my_r == owner_r, mesh.my_c == owner_c
        if backend == "fused":
            _fr.fw_round_bordered(
                buf, 1 + row_in // s if own_r else -1, 1 + col_in // s if own_c else -1,
                block_size=s, bk=bk, variant=variant, semiring=sr, bands=bufs["bands"],
            )
            return
        diag = ref.close_diag(buf[..., :s, :s], sr)
        rp = ref.close_row_panel(buf[..., :s, s:], diag, sr)
        cp = ref.close_col_panel(buf[..., s:, :s], diag, sr)
        if own_r:
            loc[..., row_in:row_in + s, :] = rp
        if own_c:
            loc[..., :, col_in:col_in + s] = cp
        if backend == "pallas":
            semiring_matmul(cp, rp, loc, semiring=sr, bk=min(32, s), variant=variant,
                            out=loc)
        else:
            loc.copy_(_phase3_chunked(loc, cp, rp, sr))

    def step(buf: torch.Tensor, first_round: int, num_rounds: int) -> torch.Tensor:
        for b in range(first_round, first_round + num_rounds):
            one_round(buf, b)
        return buf

    return step, place


def build_repair_shard_fn(mesh, n: int, *, semiring: Semiring = MIN_PLUS, edges: int):
    """The distributed rank-1 repair: ``fn(dl, u, v, w)`` → this rank's
    repaired (n/R, n/C) block.

    Per edge e the current column u_e (its (n/R, 1) slice, from the rank of
    that column in each grid row) and row v_e (its (1, n/C) slice, along
    each grid column) are broadcast, then every rank applies
    ``d ⊕= (d[:, u_e] ⊗ w_e) ⊗ d[v_e, :]`` to its block — the chain of
    ``kernels.ref.fw_repair_ref``, so the result is bitwise the
    single-device repair.  n is the padded size; u / v index it; w holds
    ``edges`` weights.  Distance-only, like the distributed solve.
    """
    nr, nc = local_shape(n, mesh)
    sr = semiring

    def fn(dl: torch.Tensor, u, v, w) -> torch.Tensor:
        if tuple(dl.shape) != (nr, nc):
            raise ValueError(f"local block must be ({nr}, {nc}), got {tuple(dl.shape)}")
        us, vs, ws = ref._edge_lists(u, v, w, dl)
        if not len(us) == len(vs) == edges:
            raise ValueError(f"expected {edges} edges, got {len(us)}")
        col, row = dl.new_empty((nr, 1)), dl.new_empty((1, nc))
        for e in range(edges):
            own_c, cu = divmod(us[e], nc)
            own_r, rv = divmod(vs[e], nr)
            _bcast(mesh, col, dl[:, cu:cu + 1], mesh.rank_of(mesh.my_r, own_c),
                   mesh.row_group, col)
            _bcast(mesh, row, dl[rv:rv + 1, :], mesh.rank_of(own_r, mesh.my_c),
                   mesh.col_group, row)
            dl = sr.relax(dl, sr.mul(col, ws[e]), row)
        return dl

    return fn


def fw_distributed(
    w: torch.Tensor,
    mesh,
    *,
    block_size: int = 128,
    semiring: Semiring = MIN_PLUS,
    backend: str = "fused",
    bk: int = 32,
    variant: str = "fori",
    rounds_per_call: int | None = None,
    checkpoint_cb: Callable[[int, torch.Tensor], None] | None = None,
    start_round: int = 0,
    phase2_shard: bool = False,
) -> torch.Tensor:
    """Distributed FW of the full (n, n) or (B, n, n) w, the same on every
    rank; returns this rank's closed (…, n/R, n/C) block (``gather`` makes
    the full matrix).

    n must give per-rank blocks of whole (s, s) tiles;
    ``apsp.solve(method="distributed")`` pads any n through
    ``plan.distributed_plan`` before calling in here.
    ``checkpoint_cb(next_round, block)`` runs after every
    ``rounds_per_call`` rounds with this rank's block as it stands (a view:
    copy what is kept); restart from such a checkpoint by passing the full
    matrix it makes and ``start_round`` = its round.
    """
    if w.ndim not in (2, 3) or w.shape[-1] != w.shape[-2]:
        raise ValueError(f"w must be (n,n) or (B,n,n), got {tuple(w.shape)}")
    n, s = w.shape[-1], block_size
    rounds = n // s
    if rounds_per_call is None:
        rounds_per_call = rounds
    if rounds_per_call < 1 or not 0 <= start_round <= rounds:
        raise ValueError(f"rounds_per_call={rounds_per_call}, start_round={start_round} "
                         f"for {rounds} rounds")
    step, place = build_fw_shard_fn(
        mesh, n, block_size=s, semiring=semiring, backend=backend, bk=bk,
        variant=variant, phase2_shard=phase2_shard, batched=w.ndim == 3,
    )
    buf = place(w)
    b = start_round
    while b < rounds:
        todo = min(rounds_per_call, rounds - b)
        step(buf, b, todo)
        b += todo
        if checkpoint_cb is not None:
            checkpoint_cb(b, buf[..., s:, s:])
    return buf[..., s:, s:].contiguous()
