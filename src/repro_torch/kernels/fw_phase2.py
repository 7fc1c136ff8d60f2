"""Phase 2 of the 4-dispatch round: the row and column bands.

``fw_phase2_row`` / ``fw_phase2_col`` replace
``repro.kernels.fw_phase2.fw_phase2_row`` / ``fw_phase2_col``.  Both close
every tile of the band against the closed diagonal, the pivot's own tile
included, as the reference does (its caller splices the diagonal over
it).  ``bt``, the reference's band tile, chooses no element's chain: it is
accepted and the kernel tiles the band its own way.  Both take f32 or the
semiring's storage lowering and keep it (``fw_phase1`` says which).  A CPU
tensor goes to the plain version in ``kernels.ref``, a CUDA tensor to the
kernels of ``csrc/fw_phase.cu`` / ``fw_phase_lowered.cu`` (counted in
``kernels.fw_phase1.LAUNCHES``), and a launch that fails raises.  Both
return new tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core.semiring import MIN_PLUS, Semiring
from repro_torch.kernels import ref
from repro_torch.kernels.fw_phase1 import launch_phase
from repro_torch.kernels.minplus_matmul import check_operand, output, storage_tag


def _check(diag: torch.Tensor, band: torch.Tensor, band_axis: int, semiring: Semiring) -> int:
    """The band length n; raises on shapes that do not pair and on a dtype
    that is not the semiring's storage."""
    check_operand(diag, "diag")
    check_operand(band, "band", diag)
    storage_tag(diag, semiring)
    s = diag.shape[-1]
    if diag.shape[-2] != s or band.ndim != diag.ndim or band.shape[:-2] != diag.shape[:-2]:
        raise ValueError(f"diag {tuple(diag.shape)} and band {tuple(band.shape)} do not pair")
    if band.shape[band_axis] != s:
        raise ValueError(f"band {tuple(band.shape)} is not {s} wide")
    if band.device != diag.device:
        raise ValueError("diag and band must lie on one device")
    n = band.shape[-1 if band_axis == -2 else -2]
    if n < 1:
        raise ValueError(f"band {tuple(band.shape)} is empty")
    return n


def fw_phase2_row(
    diag: torch.Tensor, band: torch.Tensor, *, bt: int = 512,
    semiring: Semiring = MIN_PLUS, out=None,
) -> torch.Tensor:
    """Row band (s,n) ⊕= diag ⊗ band, k sequential; batched: diag (B,s,s)
    with band (B,s,n), one launch.  ``out`` (internal): the buffer to
    write, which must not overlap the inputs."""
    n = _check(diag, band, -2, semiring)
    if diag.device.type == "cpu":
        res = ref.fw_phase2_row_ref(diag, band, semiring=semiring)
        return res if out is None else output(out, band.shape, band).copy_(res)
    out = output(out, band.shape, band)
    launch_phase("fw_phase2_row", diag, band, out, n, semiring)
    return out


def fw_phase2_col(
    diag: torch.Tensor, band: torch.Tensor, *, bt: int = 512,
    semiring: Semiring = MIN_PLUS, out=None,
) -> torch.Tensor:
    """Column band (n,s) ⊕= band ⊗ diag, k sequential; batched: diag
    (B,s,s) with band (B,n,s), one launch."""
    n = _check(diag, band, -1, semiring)
    if diag.device.type == "cpu":
        res = ref.fw_phase2_col_ref(diag, band, semiring=semiring)
        return res if out is None else output(out, band.shape, band).copy_(res)
    out = output(out, band.shape, band)
    launch_phase("fw_phase2_col", diag, band, out, n, semiring)
    return out
