"""The fused pivot round: wrappers around the Hopper kernels.

``fw_round`` replaces ``repro.kernels.fw_round.fw_round``,
``fw_round_bordered`` its bordered form ``fw_round_bordered`` (the per-rank
round of the distributed solve) and ``fw_round_with_successors`` its
successor-tracking twin (and the Pallas-Triton lowerings of all three).  A
round on the card is three launches on the current stream — diag, bands,
relax (``csrc/fw_round.cu`` says why) — through the closed-band buffers of
``round_buffers`` / ``bordered_round_buffers`` / ``succ_round_buffers``,
which a solve allocates once and passes to every round.

Storage.  ``w`` is f32 (``csrc/fw_round.cu``) or one of the storage
lowerings of ``core.semiring`` (``csrc/fw_round_lowered.cu``, the same
three launches on storage-typed tiles): bf16 or f16 with any of the five
semirings, int16 with the saturating ``*_i16`` lowerings, int32 words with
``OR_AND_PACKED``, and the int32 carrier of an integer or_and / plus_mul
storage (``core.semiring.to_carrier``).  The bordered round takes the same
storages (``fw_round_bordered_lowered_launch`` of the same source), the
successor round f32, bf16 or f16 distances.

The wrappers update ``w`` (and ``succ``) in place and return them.  A
tensor on the CPU goes to the plain version in ``kernels.ref``; a CUDA
tensor goes to the kernel, and a launch that fails raises.  A card tensor
the kernels cannot take as it lies (a strided view, or an address not
16-byte aligned) goes through a contiguous, aligned copy
(``contiguous_aligned``), and the result is written back into it.  There is no
fallback between the two.  ``LAUNCHES`` counts kernel launches by kind;
a lowered launch counts under its own kind, e.g. ``fw_round/relax[int16]``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.semiring import MIN_PLUS, Semiring
from repro_torch.kernels import ref
from repro_torch.kernels.minplus_matmul import (
    _FLOAT_TAGS,
    BLOCK_SIZES,
    LOWERINGS,
    _raise_on,
    check_variant,
    semiring_id,
    storage_tag,
)

PHASES = ("diag", "bands", "relax")
SUCC_LOWERINGS = ("bf16", "f16")
KINDS = (
    tuple(f"{fn}/{p}" for fn in ("fw_round", "fw_round_with_successors",
                                 "fw_round_bordered") for p in PHASES)
    + tuple(f"{fn}/{p}[{tag}]" for fn in ("fw_round", "fw_round_bordered")
            for tag in LOWERINGS for p in PHASES)
    + tuple(f"fw_round_with_successors/{p}[{tag}]" for tag in SUCC_LOWERINGS
            for p in PHASES)
)
LAUNCHES = dict.fromkeys(KINDS, 0)


def reset_launch_counts() -> None:
    for kind in LAUNCHES:
        LAUNCHES[kind] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("fw_round")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fw_round_launch.argtypes = [i, p, p, p, i, i, i, i, i, p]
    lib.fw_round_launch.restype = i
    lib.fw_round_bordered_launch.argtypes = [i, p, p, p, i, i, i, i, i, i, i, p]
    lib.fw_round_bordered_launch.restype = i
    lib.fw_round_succ_launch.argtypes = [i, p, p, p, p, p, p, i, i, i, i, p]
    lib.fw_round_succ_launch.restype = i
    return lib


@functools.cache
def _lowered_lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("fw_round_lowered")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fw_round_lowered_launch.argtypes = [i, i, i, p, p, p, i, i, i, i, p]
    lib.fw_round_lowered_launch.restype = i
    lib.fw_round_lowered_succ_launch.argtypes = [i, i, p, p, p, p, p, p, i, i, i, i, p]
    lib.fw_round_lowered_succ_launch.restype = i
    lib.fw_round_bordered_lowered_launch.argtypes = [i, i, i, p, p, p, i, i, i, i, i, i, p]
    lib.fw_round_bordered_lowered_launch.restype = i
    return lib


def _check(w: torch.Tensor, block_size: int, b: int, dtype=None, what: str = "w"):
    """(B, n) of a (n,n) or (B,n,n) round input; raises on what the kernels
    do not take (dtype None: any storage, checked by ``storage_tag``)."""
    if w.ndim not in (2, 3) or w.shape[-1] != w.shape[-2]:
        raise ValueError(f"{what} must be (n,n) or (B,n,n), got {tuple(w.shape)}")
    if dtype is not None and w.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {w.dtype}")
    if block_size not in BLOCK_SIZES:
        raise ValueError(f"block_size must be one of {BLOCK_SIZES}, got {block_size}")
    n = w.shape[-1]
    if n % block_size:
        raise ValueError(f"n={n} is not a multiple of block_size={block_size}")
    if not 0 <= b < n // block_size:
        raise ValueError(f"pivot round {b} outside [0, {n // block_size})")
    if w.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} must lie on the CPU or a CUDA device, not {w.device}")
    return (w.shape[0] if w.ndim == 3 else 1), n


def _buffers(w, block_size, dtypes):
    B = w.shape[0] if w.ndim == 3 else 1
    n, s = w.shape[-1], block_size
    out = []
    for dt in dtypes:
        out += [torch.empty((B, s, n), dtype=dt, device=w.device),
                torch.empty((B, n, s), dtype=dt, device=w.device)]
    return tuple(out)


def round_buffers(w: torch.Tensor, block_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(rowband (B,s,n), colband (B,n,s)) buffers in w's dtype for
    ``fw_round``."""
    return _buffers(w, block_size, (w.dtype,))


def succ_round_buffers(w: torch.Tensor, block_size: int):
    """(rw, cw, rs, cs): distance band buffers in w's dtype and int32
    successor band buffers."""
    return _buffers(w, block_size, (w.dtype, torch.int32))


def _check_buffers(w, block_size, bufs, count):
    B = w.shape[0] if w.ndim == 3 else 1
    n, s = w.shape[-1], block_size
    shapes = [(B, s, n), (B, n, s)] * (count // 2)
    dtypes = [w.dtype] * 2 + [torch.int32] * (count - 2)
    if len(bufs) != count:
        raise ValueError(f"expected {count} band buffers, got {len(bufs)}")
    for buf, shape, dt in zip(bufs, shapes, dtypes):
        if (tuple(buf.shape) != shape or buf.dtype != dt or buf.device != w.device
                or not buf.is_contiguous()):
            raise ValueError(
                f"band buffer {tuple(buf.shape)} {buf.dtype} on {buf.device} does not fit "
                f"a round of {tuple(w.shape)} on {w.device} at block_size={s}"
            )


def contiguous_aligned(t: torch.Tensor) -> torch.Tensor:
    """t itself where the kernels take it as it lies (contiguous, 16-byte
    aligned), else a contiguous, aligned copy of it (a new allocation),
    whose result the caller writes back into t."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t)


def _require_staged(kind: str, tensors) -> None:
    """The round's kernels move w and the band buffers 4 elements at a time
    and the relax stages its slices by 16-byte copies only: raise where one
    of them is not contiguous and 16-byte aligned (the public wrappers pass
    ``contiguous_aligned`` copies).  Their shapes make every row stride
    whole 16 bytes (rows and cols are multiples of s >= 16)."""
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{kind}: {tuple(t.shape)} {t.dtype} at {t.data_ptr():#x} is not "
                             f"contiguous and 16-byte aligned, which the kernels need")


def fw_round_phase(
    phase: str, w: torch.Tensor, b: int, bands, *, block_size: int = 128,
    bk: int = 32, semiring: Semiring = MIN_PLUS,
) -> None:
    """Launch one phase ("diag" | "bands" | "relax") of round b on the card
    (bk: accepted as ``fw_round``'s; the kernel folds its own slices)."""
    if phase not in PHASES:
        raise ValueError(f"phase must be one of {PHASES}, got {phase!r}")
    B, n = _check(w, block_size, b)
    tag = storage_tag(w, semiring)
    if w.device.type != "cuda":
        raise ValueError("fw_round_phase launches a CUDA kernel; w is on the CPU")
    _check_buffers(w, block_size, bands, 2)
    if phase == "bands" and n == block_size:
        return  # a single tile has no bands to close
    kind = f"fw_round/{phase}" + (f"[{tag}]" if tag else "")
    _require_staged(kind, (w, *bands))
    ptrs = (w.data_ptr(), bands[0].data_ptr(), bands[1].data_ptr(), B, n, block_size, b)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        if tag is None:
            err = _lib().fw_round_launch(PHASES.index(phase), *ptrs, semiring_id(semiring),
                                         stream)
        else:
            err = _lowered_lib().fw_round_lowered_launch(
                PHASES.index(phase), LOWERINGS[tag], semiring_id(semiring),
                *ptrs, stream)
    _raise_on(err, kind)
    LAUNCHES[kind] += 1


def fw_round(
    w: torch.Tensor, b: int, *, block_size: int = 128, bk: int = 32,
    variant: str = "fori", semiring: Semiring = MIN_PLUS, bands=None,
) -> torch.Tensor:
    """One fused pivot round b of w (n,n) or (B,n,n), in place: f32, bf16 or
    f16 with a float semiring, int16 or int32 words with their lowering,
    or the int32 carrier of an integer or_and / plus_mul storage.

    bk: the reference's phase-3 staging depth, which chooses no element's
    chain: the plain version stages by it, the kernel folds its own fixed
    slices, and the result does not depend on it.  bands: ``round_buffers(w, block_size)``
    to reuse across rounds (allocated here when None).
    """
    _check(w, block_size, b)
    storage_tag(w, semiring)
    check_variant(variant)
    if w.device.type == "cpu":
        return w.copy_(ref.fw_round_ref(
            w, b, block_size=block_size, bk=bk, variant=variant, semiring=semiring
        ))
    x = contiguous_aligned(w)
    if bands is None:
        bands = round_buffers(x, block_size)
    for phase in PHASES:
        fw_round_phase(phase, x, b, bands, block_size=block_size, bk=bk,
                       semiring=semiring)
    return w if x is w else w.copy_(x)


def _succ_lowering(w: torch.Tensor) -> str | None:
    if w.dtype not in _FLOAT_TAGS:
        raise TypeError(f"successor rounds take float32, bfloat16 or float16 "
                        f"distances, got {w.dtype}")
    return _FLOAT_TAGS[w.dtype]


def fw_round_with_successors_phase(
    phase: str, w: torch.Tensor, succ: torch.Tensor, b: int, bands, *,
    block_size: int = 128,
) -> None:
    """Launch one phase of the successor round b on the card."""
    if phase not in PHASES:
        raise ValueError(f"phase must be one of {PHASES}, got {phase!r}")
    B, n = _check(w, block_size, b)
    tag = _succ_lowering(w)
    _check(succ, block_size, b, torch.int32, "succ")
    if w.device.type != "cuda" or succ.shape != w.shape or succ.device != w.device:
        raise ValueError("w and succ must be CUDA tensors of one shape and device")
    _check_buffers(w, block_size, bands, 4)
    if phase == "bands" and n == block_size:
        return
    kind = f"fw_round_with_successors/{phase}" + (f"[{tag}]" if tag else "")
    _require_staged(kind, (w, succ, *bands))
    ptrs = (w.data_ptr(), succ.data_ptr(), *(t.data_ptr() for t in bands), B, n,
            block_size, b)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        if tag is None:
            err = _lib().fw_round_succ_launch(PHASES.index(phase), *ptrs, stream)
        else:
            err = _lowered_lib().fw_round_lowered_succ_launch(
                PHASES.index(phase), LOWERINGS[tag], *ptrs, stream)
    _raise_on(err, kind)
    LAUNCHES[kind] += 1


def fw_round_with_successors(
    w: torch.Tensor, succ: torch.Tensor, b: int, *, block_size: int = 128,
    bands=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused min-plus round carrying next hops; w f32, bf16 or f16 and
    succ int32, (n,n) or (B,n,n), both updated in place."""
    _check(w, block_size, b)
    _succ_lowering(w)
    _check(succ, block_size, b, torch.int32, "succ")
    if succ.shape != w.shape or succ.device != w.device:
        raise ValueError(
            f"succ {tuple(succ.shape)} on {succ.device} does not match "
            f"w {tuple(w.shape)} on {w.device}"
        )
    if w.device.type == "cpu":
        d, s = ref.fw_round_with_successors_ref(w, succ, b, block_size=block_size)
        w.copy_(d)
        succ.copy_(s)
        return w, succ
    x, xs = contiguous_aligned(w), contiguous_aligned(succ)
    if bands is None:
        bands = succ_round_buffers(x, block_size)
    for phase in PHASES:
        fw_round_with_successors_phase(phase, x, xs, b, bands,
                                       block_size=block_size)
    return (w if x is w else w.copy_(x)), (succ if xs is succ else succ.copy_(xs))


# ---------------------------------------------------------- bordered round
def _check_bordered(w: torch.Tensor, block_size: int, owner_row: int, owner_col: int,
                    semiring: Semiring):
    """(B, rows, cols, storage tag) of a bordered round input; raises on what
    the kernels do not take."""
    if w.ndim not in (2, 3):
        raise ValueError(f"w must be (rows,cols) or (B,rows,cols), got {tuple(w.shape)}")
    tag = storage_tag(w, semiring)
    if block_size not in BLOCK_SIZES:
        raise ValueError(f"block_size must be one of {BLOCK_SIZES}, got {block_size}")
    rows, cols = w.shape[-2:]
    if rows % block_size or cols % block_size:
        raise ValueError(f"w {tuple(w.shape)}: both dims must be multiples of "
                         f"block_size={block_size}")
    tr, tc = rows // block_size, cols // block_size
    if not (-1 <= owner_row < tr and -1 <= owner_col < tc):
        raise ValueError(f"owner echo ({owner_row}, {owner_col}) outside the "
                         f"{tr}x{tc} tile grid (-1 = none)")
    if w.device.type not in ("cpu", "cuda"):
        raise ValueError(f"w must lie on the CPU or a CUDA device, not {w.device}")
    return (w.shape[0] if w.ndim == 3 else 1), rows, cols, tag


def bordered_round_buffers(w: torch.Tensor, block_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(rowband (B,s,cols), colband (B,rows,s)) buffers in w's dtype for
    ``fw_round_bordered`` on w (rows, cols) or (B, rows, cols)."""
    B = w.shape[0] if w.ndim == 3 else 1
    rows, cols = w.shape[-2:]
    s = block_size
    return (torch.empty((B, s, cols), dtype=w.dtype, device=w.device),
            torch.empty((B, rows, s), dtype=w.dtype, device=w.device))


def fw_round_bordered_phase(
    phase: str, w: torch.Tensor, owner_row: int, owner_col: int, bands, *,
    block_size: int = 128, bk: int = 32, semiring: Semiring = MIN_PLUS,
) -> None:
    """Launch one phase ("diag" | "bands" | "relax") of a bordered round on
    the card (bk: accepted as ``fw_round``'s; the kernel folds its own
    slices)."""
    if phase not in PHASES:
        raise ValueError(f"phase must be one of {PHASES}, got {phase!r}")
    B, rows, cols, tag = _check_bordered(w, block_size, owner_row, owner_col, semiring)
    if w.device.type != "cuda":
        raise ValueError("fw_round_bordered_phase launches a CUDA kernel; w is on the CPU")
    s = block_size
    want = [(B, s, cols), (B, rows, s)]
    if len(bands) != 2 or any(tuple(t.shape) != sh or t.dtype != w.dtype or t.device != w.device
                              or not t.is_contiguous() for t, sh in zip(bands, want)):
        raise ValueError(f"band buffers must be {want} {w.dtype} on {w.device}, contiguous")
    sid = semiring_id(semiring)
    if phase == "bands" and rows == cols == s:
        return  # a single tile has no bands to close
    kind = f"fw_round_bordered/{phase}" + (f"[{tag}]" if tag else "")
    _require_staged(kind, (w, *bands))
    geom = (w.data_ptr(), bands[0].data_ptr(), bands[1].data_ptr(), B, rows, cols, s,
            owner_row, owner_col)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        if tag is None:
            err = _lib().fw_round_bordered_launch(PHASES.index(phase), *geom, sid, stream)
        else:
            err = _lowered_lib().fw_round_bordered_lowered_launch(
                PHASES.index(phase), LOWERINGS[tag], sid, *geom, stream)
    _raise_on(err, kind)
    LAUNCHES[kind] += 1


def fw_round_bordered(
    w: torch.Tensor, owner_row: int = -1, owner_col: int = -1, *,
    block_size: int = 128, bk: int = 32, variant: str = "fori",
    semiring: Semiring = MIN_PLUS, bands=None,
) -> torch.Tensor:
    """One bordered round of w (rows, cols) or (B, rows, cols), in place: f32,
    or any storage ``fw_round`` takes with its semiring.

    w is a rank's pivot-bordered block: the raw (s, s) pivot tile in the
    top-left corner, the raw pivot row / column panel slices as the first
    block row / column, the rank's local block as the rest.  owner_row /
    owner_col: the bordered tile coordinates at which the local block holds
    the rank's own copy of the global pivot row / column band, -1 where it
    holds none (shared by a batch).  bands: ``bordered_round_buffers(w,
    block_size)`` to reuse across rounds (allocated here when None).
    """
    _check_bordered(w, block_size, owner_row, owner_col, semiring)
    check_variant(variant)
    if w.device.type == "cpu":
        return w.copy_(ref.fw_round_bordered_ref(
            w, owner_row, owner_col, block_size=block_size, bk=bk, variant=variant,
            semiring=semiring,
        ))
    x = contiguous_aligned(w)
    if bands is None:
        bands = bordered_round_buffers(x, block_size)
    for phase in PHASES:
        fw_round_bordered_phase(phase, x, owner_row, owner_col, bands,
                                block_size=block_size, bk=bk, semiring=semiring)
    return w if x is w else w.copy_(x)
