"""Phase 1 of the 4-dispatch round: the closure of a diagonal tile.

``fw_phase1`` replaces ``repro.kernels.fw_phase1.fw_phase1``, in f32 or a
storage lowering (``minplus_matmul.storage_tag``: bf16 / f16, the int16
``*_i16`` lowerings, packed or_and words, the int32 carrier of an integer
or_and / plus_mul storage), kept in its dtype.  A tensor on the CPU goes to
the plain version (``kernels.ref.fw_phase1_ref``); a CUDA tensor goes to
the kernel of ``csrc/fw_phase.cu`` (f32) or ``csrc/fw_phase_lowered.cu``,
and a launch that fails raises.  There is no fallback between the two.  It
returns a new tensor; the input is left as it was.

This module also holds what ``kernels.fw_phase2`` shares with it: the
libraries of both sources, the launcher, and ``LAUNCHES``, the launch
counts of the three kernels by kind (a lowered launch under its own kind,
``fw_phase1[bf16]``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.semiring import MIN_PLUS, Semiring
from repro_torch.kernels import ref
from repro_torch.kernels.minplus_matmul import (
    BLOCK_SIZES,
    LOWERINGS,
    _raise_on,
    check_operand,
    output,
    semiring_id,
    storage_tag,
    view_args,
)

PHASE_KINDS = ("fw_phase1", "fw_phase2_row", "fw_phase2_col")
KINDS = PHASE_KINDS + tuple(f"{k}[{tag}]" for k in PHASE_KINDS for tag in LOWERINGS)
LAUNCHES = dict.fromkeys(KINDS, 0)


def reset_launch_counts() -> None:
    for kind in LAUNCHES:
        LAUNCHES[kind] = 0


@functools.cache
def _lib(lowered: bool = False) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    operands = [p, q, q, p, q, q, p, q, q, i, i, i]
    if lowered:
        lib = _build.load("fw_phase_lowered")
        lib.fw_phase_lowered_launch.argtypes = [i, i, i] + operands + [p]
        lib.fw_phase_lowered_launch.restype = i
    else:
        lib = _build.load("fw_phase")
        lib.fw_phase_launch.argtypes = [i] + operands + [i, p]
        lib.fw_phase_launch.restype = i
    return lib


def launch_phase(kind: str, diag: torch.Tensor, band, out: torch.Tensor, n: int,
                 semiring: Semiring) -> None:
    """One launch of ``csrc/fw_phase.cu`` (f32) or ``fw_phase_lowered.cu``:
    ``kind`` of ``PHASE_KINDS``; diag (B,s,s), band (B,s,n) / (B,n,s) or
    None, out their result, all in one storage."""
    s = diag.shape[-1]
    if s not in BLOCK_SIZES:
        raise ValueError(f"the phase kernels take s in {BLOCK_SIZES}, got {s}")
    tensors = [diag, out] + ([] if band is None else [band])
    if any(t.device != diag.device for t in tensors):
        raise ValueError("diag, band and out must lie on one device")
    if any(t.dtype != diag.dtype for t in tensors):
        raise TypeError("diag, band and out must share one storage dtype")
    tag = storage_tag(diag, semiring)
    B = diag.shape[0] if diag.ndim == 3 else 1
    if B > 65535:
        raise ValueError(f"at most 65535 graphs a launch, got {B}")
    d = view_args(diag, "diag")
    bv = (None, 0, 0) if band is None else view_args(band, "band")
    o = view_args(out, "out")
    code = PHASE_KINDS.index(kind)
    with torch.cuda.device(diag.device):
        stream = torch.cuda.current_stream(diag.device).cuda_stream
        if tag is None:
            err = _lib().fw_phase_launch(code, *d, *bv, *o, B, n, s, semiring_id(semiring),
                                         stream)
        else:
            err = _lib(True).fw_phase_lowered_launch(code, LOWERINGS[tag], semiring_id(semiring),
                                                     *d, *bv, *o, B, n, s, stream)
    kind += f"[{tag}]" if tag else ""
    _raise_on(err, kind)
    LAUNCHES[kind] += 1


def fw_phase1(
    tile: torch.Tensor, *, semiring: Semiring = MIN_PLUS, out=None,
) -> torch.Tensor:
    """FW closure of one (s,s) diagonal tile, or (B,s,s) of them in one
    launch; f32 or the semiring's storage lowering, kept.  ``out``
    (internal): the buffer to write, which must not overlap ``tile``."""
    check_operand(tile, "tile")
    storage_tag(tile, semiring)
    if tile.shape[-1] != tile.shape[-2]:
        raise ValueError(f"diagonal tile must be (s,s) or (B,s,s), got {tuple(tile.shape)}")
    if tile.device.type == "cpu":
        res = ref.fw_phase1_ref(tile, semiring=semiring)
        return res if out is None else output(out, tile.shape, tile).copy_(res)
    out = output(out, tile.shape, tile)
    launch_phase("fw_phase1", tile, None, out, tile.shape[-1], semiring)
    return out
