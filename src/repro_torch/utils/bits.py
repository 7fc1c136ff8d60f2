"""Equality by bit view: what the port means by "bitwise equal".

``bits_equal`` holds two tables to the same dtype, shape and bits, with
every NaN counted equal to every other (kernels and libraries write NaN
with different payloads).  Unlike ``==``, it tells -0.0 from +0.0, so a
kernel whose min or max picks the wrong zero fails it.  Takes torch
tensors (on any device) or numpy arrays (ml_dtypes' bfloat16 included);
a tensor compared with an array goes to the host first.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.interop import to_numpy

_TORCH_INT = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _torch_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    ia, ib = (t.view(_TORCH_INT[t.element_size()]) for t in (a, b))
    return torch.equal(na, nb) and bool(((ia == ib) | na).all())


def _numpy_equal(a: np.ndarray, b: np.ndarray) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.kind in "biu":
        return bool(np.array_equal(a, b))
    na = np.isnan(a.astype(np.float32) if a.dtype.itemsize < 4 else a)
    nb = np.isnan(b.astype(np.float32) if b.dtype.itemsize < 4 else b)
    ia, ib = (x.view(f"i{x.dtype.itemsize}") for x in (a, b))
    return bool(np.array_equal(na, nb) and ((ia == ib) | na).all())


def bits_equal(a, b) -> bool:
    """Same dtype, shape and bits; NaN equal to NaN of any payload."""
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        if a.device != b.device:
            a, b = a.cpu(), b.cpu()
        return _torch_equal(a, b)
    as_np = lambda x: to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)  # noqa: E731
    return _numpy_equal(as_np(a), as_np(b))
