"""Phase 1 of the 4-dispatch round: the closure of a diagonal tile.

``fw_phase1`` replaces ``repro.kernels.fw_phase1.fw_phase1``.  A tensor on
the CPU goes to the plain version (``kernels.ref.fw_phase1_ref``); a CUDA
tensor goes to the kernel of ``csrc/fw_phase.cu``, and a launch that fails
raises.  There is no fallback between the two.  It returns a new tensor;
the input is left as it was.

This module also holds what ``kernels.fw_phase2`` shares with it: the
library of ``csrc/fw_phase.cu``, its launcher, and ``LAUNCHES``, the launch
counts of its three kernels by kind.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.semiring import MIN_PLUS, Semiring, require_f32_a4b
from repro_torch.kernels import ref
from repro_torch.kernels.minplus_matmul import (
    BLOCK_SIZES,
    _raise_on,
    check_operand,
    output,
    semiring_id,
    view_args,
)

KINDS = ("fw_phase1", "fw_phase2_row", "fw_phase2_col")
LAUNCHES = dict.fromkeys(KINDS, 0)


def reset_launch_counts() -> None:
    for kind in LAUNCHES:
        LAUNCHES[kind] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("fw_phase")
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fw_phase_launch.argtypes = [i, p, q, q, p, q, q, p, q, q, i, i, i, i, p]
    lib.fw_phase_launch.restype = i
    return lib


def launch_phase(kind: str, diag: torch.Tensor, band, out: torch.Tensor, n: int,
                 semiring: Semiring) -> None:
    """One launch of ``csrc/fw_phase.cu``: ``kind`` of ``KINDS``; diag
    (B,s,s), band (B,s,n) / (B,n,s) or None, out their result."""
    s = diag.shape[-1]
    if s not in BLOCK_SIZES:
        raise ValueError(f"the phase kernels take s in {BLOCK_SIZES}, got {s}")
    tensors = [diag, out] + ([] if band is None else [band])
    if any(t.device != diag.device for t in tensors):
        raise ValueError("diag, band and out must lie on one device")
    B = diag.shape[0] if diag.ndim == 3 else 1
    if B > 65535:
        raise ValueError(f"at most 65535 graphs a launch, got {B}")
    d = view_args(diag, "diag")
    bv = (None, 0, 0) if band is None else view_args(band, "band")
    o = view_args(out, "out")
    with torch.cuda.device(diag.device):
        stream = torch.cuda.current_stream(diag.device).cuda_stream
        err = _lib().fw_phase_launch(KINDS.index(kind), *d, *bv, *o, B, n, s,
                                     semiring_id(semiring), stream)
    _raise_on(err, kind)
    LAUNCHES[kind] += 1


def fw_phase1(
    tile: torch.Tensor, *, semiring: Semiring = MIN_PLUS, out=None,
) -> torch.Tensor:
    """FW closure of one (s,s) diagonal tile, or (B,s,s) of them in one
    launch; f32.  ``out`` (internal): the buffer to write, which must not
    overlap ``tile``."""
    check_operand(tile, "tile")
    require_f32_a4b(semiring, where="fw_phase1")
    if tile.shape[-1] != tile.shape[-2]:
        raise ValueError(f"diagonal tile must be (s,s) or (B,s,s), got {tuple(tile.shape)}")
    if tile.device.type == "cpu":
        res = ref.fw_phase1_ref(tile, semiring=semiring)
        return res if out is None else output(out, tile.shape, tile).copy_(res)
    out = output(out, tile.shape, tile)
    launch_phase("fw_phase1", tile, None, out, tile.shape[-1], semiring)
    return out
