"""Carry state across between the JAX package and the port.

The system has no learned weights: its state is graph matrices (f32
weights) and solved tables (f32 distances, int32 successors).  Both
packages read and write them as numpy arrays, so these two functions are
the whole bridge.
"""
from __future__ import annotations

import numpy as np
import torch

_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.int32): torch.int32,
}


def from_numpy(arr, *, device="cuda") -> torch.Tensor:
    """A weight matrix (f32) or successor table (int32) → a tensor on ``device``.

    Other float inputs are cast to f32 and other integer inputs to int32 —
    the two storage types of the ported slice.
    """
    a = np.asarray(arr)
    if a.dtype not in _DTYPES:
        a = a.astype(np.int32 if a.dtype.kind in "iu" else np.float32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on any device → a host numpy array of the same dtype."""
    return t.detach().cpu().numpy()
