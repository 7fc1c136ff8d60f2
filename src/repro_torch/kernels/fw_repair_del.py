"""Decremental repair: affected-set marking and the restricted row sweep.

Counterpart of ``repro.kernels.fw_repair_del``.  A batch of edge deletions
(or worsenings) is absorbed in two stages:

  * **mark** (``mark_affected``, ``mark_affected_with_successors``): the
    pairs whose closure value is witnessed through a deleted edge,
    ``d[i, u] ⊗ w_old ⊗ d[v, j] == d[i, j] ≠ 0̄``, are reset to their
    direct edge in the updated weights; the rows holding any of them are
    the affected rows.  In the reference these are XLA outside any Pallas
    call; here they are torch ops on the tensors' device, the card
    included.
  * **sweep** (``fw_repair_del_sweep``, replacing the Pallas
    ``_sweep_round`` driven by ``fw_repair_del_sweep``, and
    ``fw_repair_del_sweep_with_successors``, the kernel twin of the
    reference's XLA-only successor sweep): blocked FW restricted to the
    (a_pad, m) strip of affected rows, three launches per pivot round on
    the current stream — diag, panels, relax (``csrc/fw_repair_del.cu``
    says why) — through the buffers of ``sweep_buffers``.  The relax runs
    on one of two tiles by the strip's shape (``relax_height``): the
    matmul mainloop's 128-row tile, or a short tile of 8 or 16 rows.

Storage.  f32 (``csrc/fw_repair_del.cu``) or a storage lowering
(``csrc/fw_repair_del_lowered.cu``, the same three launches on
storage-typed buffers): bf16 or f16 with the four idempotent semirings,
int16 with the ``*_i16`` lowerings, one ``OR_AND_PACKED`` word plane, the
int32 carrier of an integer or_and storage; the successor sweep takes f32,
bf16 or f16 distances.  For the packed lowering the marking is per lane:
the witness is an int32 lane mask, and the reset splices ``w1``'s bits
into those lanes only.

Both sweeps return new tensors and leave their inputs as they were.  A
tensor on the CPU goes to the plain version in ``kernels.ref``; a CUDA
tensor goes to the kernels (a strided or unaligned one through a
contiguous, aligned copy: ``fw_round.contiguous_aligned``), and a launch
that fails raises.  There is no
fallback between the two.  ``LAUNCHES`` counts kernel launches by kind; a
lowered launch counts under its own kind, e.g.
``fw_repair_del_sweep/relax[bf16]``.  The sweep is sound for the
⊕-idempotent semirings only, and the kernels take those four; plus_mul is
re-solved by ``ApspEngine.repair_del`` in every storage.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.semiring import MIN_PLUS, Semiring
from repro_torch.kernels import ref
from repro_torch.kernels.fw_repair import SUCC_LOWERINGS, _check, edge_vectors, succ_tag
from repro_torch.kernels.fw_round import LOWERINGS, contiguous_aligned, storage_tag
from repro_torch.kernels.minplus_matmul import BLOCK_SIZES, _raise_on, check_variant, semiring_id

PHASES = ("diag", "panels", "relax")
# Storages of the sweep kernels: the round's, but plus_mul has no sweep.
SWEEP_LOWERINGS = tuple(tag for tag in LOWERINGS if tag != "plus_mul_i32")
KINDS = (
    tuple(f"{fn}/{p}" for fn in ("fw_repair_del_sweep", "fw_repair_del_sweep_with_successors")
          for p in PHASES)
    + tuple(f"fw_repair_del_sweep/{p}[{tag}]" for tag in SWEEP_LOWERINGS for p in PHASES)
    + tuple(f"fw_repair_del_sweep_with_successors/{p}[{tag}]" for tag in SUCC_LOWERINGS
            for p in PHASES)
)
LAUNCHES = dict.fromkeys(KINDS, 0)
STRIP_ROWS = 8  # strips pad to a multiple of it (the panels' strip lanes hold 4 rows)
SHORT_HEIGHTS = (8, 16)  # the relax's short tile heights
LONG_HEIGHT = 128  # the mainloop tile's: strips of at least this many rows take it


def relax_height(a: int, n: int) -> int:
    """The relax launch's tile height for a strip of a rows of n columns:
    the mainloop's 128 once its 128 x 128 tiles number at least 128 (a CTA
    an SM, about: a >= 512 at n = 4096, a >= 256 at n = 8192), else the
    short tile, 8 rows for a strip of 8 and 16 rows (in a / 16 tiles) past
    that.  Picked by A/B on the H100 (``launch/round_bench.py
    --sweep-relax``, PERF.md): a shorter tile in more CTAs beat one that
    holds the strip (at a = 64, 16 rows a tile ran in 0.30-0.77x the time
    of 64), and a mainloop of 32 CTAs lost to it."""
    if a >= LONG_HEIGHT and -(-a // LONG_HEIGHT) * -(-n // LONG_HEIGHT) >= LONG_HEIGHT:
        return LONG_HEIGHT
    return 8 if a <= 8 else 16


def reset_launch_counts() -> None:
    for kind in LAUNCHES:
        LAUNCHES[kind] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("fw_repair_del")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fw_repair_del_launch.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.fw_repair_del_launch.restype = i
    lib.fw_repair_del_succ_launch.argtypes = [i, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.fw_repair_del_succ_launch.restype = i
    return lib


@functools.cache
def _lowered_lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("fw_repair_del_lowered")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fw_repair_del_lowered_launch.argtypes = [i, i, i, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.fw_repair_del_lowered_launch.restype = i
    lib.fw_repair_del_lowered_succ_launch.argtypes = [i, i, p, p, p, p, p, p, p, p, p, p, i, i,
                                                      i, i, i, p]
    lib.fw_repair_del_lowered_succ_launch.restype = i
    return lib


def _check_pair(d, other, what: str) -> None:
    if other.shape != d.shape or other.device != d.device:
        raise ValueError(
            f"{what} {tuple(other.shape)} on {other.device} does not match "
            f"d {tuple(d.shape)} on {d.device}"
        )


def _check_rows(rows, m: int) -> np.ndarray:
    """Host int64 copy of the strip's row indices: each in [0, m], where m
    marks a padding row; the real rows are distinct."""
    r = np.asarray(rows.cpu() if isinstance(rows, torch.Tensor) else rows).astype(np.int64).reshape(-1)
    if r.size < 1:
        raise ValueError("rows must name at least one strip row")
    if ((r < 0) | (r > m)).any():
        raise ValueError(f"rows must lie in [0, {m}] ({m} marks a padding row)")
    real = r[r < m]
    if np.unique(real).size != real.size:
        raise ValueError("the real rows of a strip must be distinct")
    return r


def _sweep_tag(d: torch.Tensor, semiring: Semiring) -> str | None:
    """The storage tag of a sweep on d; plus_mul has none in any storage."""
    if semiring.name.startswith("plus_mul"):
        raise ValueError(
            f"no sweep kernel for semiring {semiring.name!r}: the restricted "
            f"sweep is sound for the ⊕-idempotent semirings only"
        )
    return storage_tag(d, semiring)


# ------------------------------------------------------------------- mark
def mark_affected(dist, w1, u, v, wold, ecount, *, semiring: Semiring = MIN_PLUS):
    """Stage 1: (d_init, affected-row mask (m,), affected-entry count).

    dist: the (m, m) closure before the deletions, in any storage the
    sweep takes; w1: the updated weights (deleted edges at the
    ⊕-identity); u / v / wold: the deleted edges and the weight each
    carried before (for the packed lowering, the lanes that held the
    edge), of which the first ``ecount`` are live and the rest padding.
    Torch ops on dist's device.
    """
    m = _check(dist, 1, "dist")
    storage_tag(dist, semiring)
    _check_pair(dist, w1, "w1")
    u, v, wold = edge_vectors(u, v, wold, m, "cpu", dist.dtype)
    return ref.mark_affected(dist, w1, u, v, wold, ecount, semiring=semiring)


def mark_affected_with_successors(dist, succ, w1, u, v, wold, ecount, *,
                                  semiring: Semiring = MIN_PLUS):
    """Stage 1 with next hops: (d_init, s_init, row mask, count)."""
    m = _check(dist, 1, "dist")
    succ_tag(dist)
    _check(succ, 1, "succ", torch.int32)
    _check_pair(dist, succ, "succ")
    _check_pair(dist, w1, "w1")
    u, v, wold = edge_vectors(u, v, wold, m, "cpu", dist.dtype)
    return ref.mark_affected_with_successors(dist, succ, w1, u, v, wold, ecount,
                                             semiring=semiring)


# ------------------------------------------------------------------ sweep
@dataclasses.dataclass
class Sweep:
    """The device state of one restricted sweep: what the launches read and
    write.  The strip holds a_k rows, the input's a_pad padded with inert
    rows to a multiple of ``STRIP_ROWS``.

    rows (a_k,) int32: the matrix row of each strip row, m for padding;
    pos (m,) int32: the strip row holding each matrix row, -1 for none;
    strip (a_k, m), band (s, m), acol (a_k, s): working buffers in
    d_init's dtype;
    real / keep: int64 indices of the real rows and their strip rows, for
    the final write-back.  With successors, s_init and the ``*_s`` int32
    next-hop twins of strip, band and acol.
    """

    d_init: torch.Tensor
    rows: torch.Tensor
    pos: torch.Tensor
    strip: torch.Tensor
    band: torch.Tensor
    acol: torch.Tensor
    real: torch.Tensor
    keep: torch.Tensor
    s_init: torch.Tensor | None = None
    strip_s: torch.Tensor | None = None
    band_s: torch.Tensor | None = None
    acol_s: torch.Tensor | None = None

    @property
    def block_size(self) -> int:
        return self.band.shape[0]


def sweep_buffers(d_init: torch.Tensor, rows, *, block_size: int,
                  s_init: torch.Tensor | None = None) -> Sweep:
    """Gather the strip of ``rows`` (padding index m clipped to row m-1)
    and allocate the round buffers on d_init's device.  The diag and panels
    kernels load d_init and s_init four elements at a time, so the sweep
    keeps each as it lies where it is contiguous and 16-byte aligned, else
    a contiguous, aligned copy (``fw_round.contiguous_aligned``)."""
    m = _check(d_init, block_size, "d_init")
    if s_init is not None:
        _check(s_init, block_size, "s_init", torch.int32)
        _check_pair(d_init, s_init, "s_init")
    r = _check_rows(rows, m)
    r = np.concatenate([r, np.full(-r.size % STRIP_ROWS, m, np.int64)])
    keep = np.flatnonzero(r < m)
    pos = np.full(m, -1, np.int32)
    pos[r[keep]] = keep
    d_init = contiguous_aligned(d_init)
    dev = d_init.device
    idx = torch.from_numpy(np.minimum(r, m - 1)).to(dev)
    new = functools.partial(torch.empty, device=dev)
    sw = Sweep(
        d_init=d_init, rows=torch.from_numpy(r.astype(np.int32)).to(dev),
        pos=torch.from_numpy(pos).to(dev), strip=d_init.index_select(0, idx),
        band=new((block_size, m), dtype=d_init.dtype),
        acol=new((r.size, block_size), dtype=d_init.dtype),
        real=torch.from_numpy(r[keep]).to(dev), keep=torch.from_numpy(keep).to(dev),
    )
    if s_init is not None:
        sw.s_init = contiguous_aligned(s_init)
        sw.strip_s = sw.s_init.index_select(0, idx)
        sw.band_s = new((block_size, m), dtype=torch.int32)
        sw.acol_s = new((r.size, block_size), dtype=torch.int32)
    return sw


def _write_back(t: torch.Tensor, strip: torch.Tensor, sw: Sweep) -> torch.Tensor:
    return t.clone().index_copy_(0, sw.real, strip.index_select(0, sw.keep))


def _require_buffers(fn: str, sw: Sweep) -> None:
    """Raise unless the kernels take sw's buffers: on one CUDA device,
    contiguous, s one of BLOCK_SIZES, and d_init, the strip, the band and
    acol, and with successors their next-hop twins, 16-byte aligned (the
    diag and panels move them four elements at a time; ``sweep_buffers``
    allocates them so)."""
    if sw.d_init.device.type != "cuda":
        raise ValueError(f"{fn} phases launch a CUDA kernel; the sweep is on the CPU")
    s = sw.block_size
    if s not in BLOCK_SIZES:
        raise ValueError(f"block_size must be one of {BLOCK_SIZES}, got {s}")
    bufs = [t for t in (getattr(sw, f.name) for f in dataclasses.fields(sw)) if t is not None]
    if any(t.device != sw.d_init.device or not t.is_contiguous() for t in bufs):
        raise ValueError(f"{fn}: every buffer must be contiguous on {sw.d_init.device}")
    if any(t.data_ptr() % 16 for t in (sw.d_init, sw.strip, sw.band, sw.acol)):
        raise ValueError(f"{fn}: d_init, the strip, the band and acol must be 16-byte aligned")
    hops = (sw.s_init, sw.strip_s, sw.band_s, sw.acol_s)
    if any(t is not None and t.data_ptr() % 16 for t in hops):
        raise ValueError(f"{fn}: s_init, strip_s, band_s and acol_s must be 16-byte aligned")


def _height(sw: Sweep, height: int | None) -> int:
    """The relax's tile height on sw: ``relax_height`` of its strip, or the
    one asked for (any of them computes the same)."""
    if height is None:
        return relax_height(*sw.strip.shape)
    if height not in (*SHORT_HEIGHTS, LONG_HEIGHT):
        raise ValueError(f"height must be one of {(*SHORT_HEIGHTS, LONG_HEIGHT)}, got {height}")
    return height


def _launcher(sw: Sweep, tag, semiring: Semiring | None, height: int):
    """launch(ph, b, stream) → cudaError_t: round b's launch of phase index
    ph on sw's buffers, their pointers taken once (semiring None: the
    successor sweep); the relax on the tile of that height."""
    n, a, s, h = sw.d_init.shape[0], sw.strip.shape[0], sw.block_size, height
    if semiring is None:
        ptrs = tuple(t.data_ptr() for t in (sw.d_init, sw.s_init, sw.pos, sw.rows, sw.strip,
                                            sw.strip_s, sw.band, sw.band_s, sw.acol, sw.acol_s))
        if tag is None:
            fn = _lib().fw_repair_del_succ_launch
            return lambda ph, b, stream: fn(ph, *ptrs, n, a, s, b, h, stream)
        fn, code = _lowered_lib().fw_repair_del_lowered_succ_launch, LOWERINGS[tag]
        return lambda ph, b, stream: fn(ph, code, *ptrs, n, a, s, b, h, stream)
    ptrs = tuple(t.data_ptr() for t in (sw.d_init, sw.pos, sw.rows, sw.strip, sw.band, sw.acol))
    sid = semiring_id(semiring)
    if tag is None:
        fn = _lib().fw_repair_del_launch
        return lambda ph, b, stream: fn(ph, *ptrs, n, a, s, b, h, sid, stream)
    fn, code = _lowered_lib().fw_repair_del_lowered_launch, LOWERINGS[tag]
    return lambda ph, b, stream: fn(ph, code, sid, *ptrs, n, a, s, b, h, stream)


def _run(fn: str, tag, sw: Sweep, launch, rounds, phases=PHASES) -> None:
    """Launch ``phases`` of each round of ``rounds`` in order on the current
    stream of sw's device, raising on the first launch that fails; counts
    each launch."""
    steps = [(PHASES.index(p), f"{fn}/{p}" + (f"[{tag}]" if tag else "")) for p in phases]
    with torch.cuda.device(sw.d_init.device):
        stream = torch.cuda.current_stream(sw.d_init.device).cuda_stream
        for b in rounds:
            for ph, kind in steps:
                _raise_on(launch(ph, b, stream), kind)
                LAUNCHES[kind] += 1


def _one_phase(fn: str, phase: str, tag, sw: Sweep, b: int, launcher) -> None:
    """One launch of the public per-phase entry points, every check first
    (``launcher()`` makes the launch, after them)."""
    if phase not in PHASES:
        raise ValueError(f"phase must be one of {PHASES}, got {phase!r}")
    _require_buffers(fn, sw)
    m, s = sw.d_init.shape[0], sw.block_size
    if not 0 <= b < m // s:
        raise ValueError(f"pivot round {b} outside [0, {m // s})")
    _run(fn, tag, sw, launcher(), [b], [phase])


def sweep_phase(phase: str, sw: Sweep, b: int, *, bk: int = 32,
                semiring: Semiring = MIN_PLUS, height: int | None = None) -> None:
    """Launch one phase ("diag" | "panels" | "relax") of round b on the card.
    bk: the reference's staging depth, which no launch takes any more (the
    result never depended on it); height: the relax's tile height (None:
    ``relax_height`` of the strip)."""
    tag = _sweep_tag(sw.d_init, semiring)
    h = _height(sw, height)
    _one_phase("fw_repair_del_sweep", phase, tag, sw, b,
               lambda: _launcher(sw, tag, semiring, h))


def sweep_succ_phase(phase: str, sw: Sweep, b: int, *, height: int | None = None) -> None:
    """Launch one phase of the successor sweep's round b on the card
    (height as in ``sweep_phase``)."""
    if sw.s_init is None:
        raise ValueError("the sweep carries no next hops (sweep_buffers(s_init=))")
    tag = succ_tag(sw.d_init)
    h = _height(sw, height)
    _one_phase("fw_repair_del_sweep_with_successors", phase, tag, sw, b,
               lambda: _launcher(sw, tag, None, h))


def fw_repair_del_sweep(
    d_init: torch.Tensor, rows, *, block_size: int, bk: int = 32,
    variant: str = "fori", semiring: Semiring = MIN_PLUS,
) -> torch.Tensor:
    """The restricted row sweep of ``d_init`` (m, m) from ``mark_affected``
    (f32, or a storage the lowered kernels take): rows (a_pad,) are the
    affected rows, padded with m.  Returns the repaired closure, a new
    tensor.  bk: the reference's staging depth of the relax (clamped to a
    divisor of block_size); it no longer shapes any launch, and the result
    never depended on it."""
    m = _check(d_init, block_size, "d_init")
    tag = _sweep_tag(d_init, semiring)
    check_variant(variant)
    r = _check_rows(rows, m)
    if d_init.device.type == "cpu":
        return ref.fw_repair_del_sweep_ref(d_init, r, block_size=block_size, bk=bk,
                                           variant=variant, semiring=semiring)
    sw = sweep_buffers(d_init, r, block_size=block_size)
    _require_buffers("fw_repair_del_sweep", sw)
    _run("fw_repair_del_sweep", tag, sw, _launcher(sw, tag, semiring, _height(sw, None)),
         range(m // block_size))
    return _write_back(sw.d_init, sw.strip, sw)


def fw_repair_del_sweep_with_successors(
    d_init: torch.Tensor, s_init: torch.Tensor, rows, *, block_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The min-plus sweep carrying the int32 next-hop table ``s_init`` from
    ``mark_affected_with_successors`` (d_init f32, bf16 or f16): (dist,
    succ), new tensors."""
    m = _check(d_init, block_size, "d_init")
    tag = succ_tag(d_init)
    _check(s_init, block_size, "s_init", torch.int32)
    _check_pair(d_init, s_init, "s_init")
    r = _check_rows(rows, m)
    if d_init.device.type == "cpu":
        return ref.fw_repair_del_sweep_with_successors_ref(d_init, s_init, r,
                                                           block_size=block_size)
    sw = sweep_buffers(d_init, r, block_size=block_size, s_init=s_init)
    fn = "fw_repair_del_sweep_with_successors"
    _require_buffers(fn, sw)
    _run(fn, tag, sw, _launcher(sw, tag, None, _height(sw, None)), range(m // block_size))
    return _write_back(sw.d_init, sw.strip, sw), _write_back(sw.s_init, sw.strip_s, sw)
