"""Carry state across between the JAX package and the port.

The system has no learned weights: its state is graph matrices and solved
tables — f32, f16 or bf16 weights and distances, int16 saturating
distances, int32 bit-packed reachability words, int32 successors, and the
integer or_and / plus_mul storages (bool, int8, uint8, int16, int32,
uint32).
Both packages read and write them as numpy arrays, so these two functions
are the whole bridge.  bfloat16 is not a numpy dtype: the reference's
arrays carry it as ``ml_dtypes.bfloat16``, and it crosses by bit view
(uint16), never by a value cast.

The LM substrate has weights: ``lm_params_from_numpy`` loads the
reference's parameter pytree, as numpy arrays, into a port ``Model``.
"""
from __future__ import annotations

import numpy as np
import torch

_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.uint32): torch.uint32,
}
# What JAX makes of the 64-bit types (no x64): the reference's view of them.
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32}


def _is_bfloat16(dtype: np.dtype) -> bool:
    return dtype.name == "bfloat16" and dtype.itemsize == 2


def host_tensor(arr) -> torch.Tensor:
    """A numpy array (or nested list) → a CPU tensor of the same dtype and
    bits; ml_dtypes bfloat16 → torch.bfloat16 through its uint16 view."""
    a = np.ascontiguousarray(np.asarray(arr))
    if not a.flags.writeable:  # e.g. a view of a JAX array
        a = a.copy()
    if _is_bfloat16(a.dtype):
        return torch.from_numpy(a.view(np.uint16).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def from_numpy(arr, *, device="cuda") -> torch.Tensor:
    """A weight matrix or solved table → a tensor on ``device``, as the
    reference sees it.

    f32, f16, bf16, bool, int8, uint8, int16, int32 and uint32 keep their
    dtype; float64, int64 and uint64 narrow to their 32-bit types, as
    ``jnp.asarray`` makes them without x64; anything else raises.
    """
    a = np.asarray(arr)
    if a.dtype in _NARROW:
        a = a.astype(_NARROW[a.dtype])
    if not _is_bfloat16(a.dtype) and a.dtype not in _DTYPES:
        raise TypeError(f"no port dtype for {a.dtype}")
    return host_tensor(a).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on any device → a host numpy array of the same dtype;
    bfloat16 comes back as ``ml_dtypes.bfloat16`` (needs that package)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, (*prefix, k))
    else:
        yield prefix


def lm_params_from_numpy(cfg, tree: dict, *, device="cuda"):
    """The reference's ``init_params`` pytree (nested dicts of numpy arrays;
    bf16 as ``ml_dtypes.bfloat16``; f32 leaves where the reference keeps
    f32: MoE routers, the SSD block's ``A_log`` / ``D`` / ``dt_bias``) → a
    ``repro_torch.models.model.Model`` on ``device`` with the same bits.

    The reference stacks each pattern slot's leaves over the repetitions:
    ``periods/l{i}/...`` has shape (n_periods, ...), and its entry p is the
    port's layer ``p·len(pattern) + i``; ``encoder/periods/l0/...`` entry p
    is encoder layer p.  Every leaf must land in exactly one parameter of
    the same shape and dtype, else ``ValueError``."""
    from repro_torch.models.model import Model

    model = Model(cfg, device=device)
    period = len(cfg.layer_pattern)
    used = set()
    for name, param in model.named_parameters():
        path = name.split(".")
        if path[0] == "layers":
            j = int(path[1])
            src, row = ("periods", f"l{j % period}", *path[2:]), j // period
        elif path[:2] == ["encoder", "layers"]:
            src, row = ("encoder", "periods", "l0", *path[3:]), int(path[2])
        else:
            src, row = tuple(path), None
        leaf = tree
        for key in src:
            leaf = leaf[key]
        arr = np.asarray(leaf)
        arr = np.asarray(arr if row is None else arr[row])
        t = host_tensor(arr).reshape(arr.shape)  # host_tensor makes a 0-d array 1-d
        if t.shape != param.shape or t.dtype != param.dtype:
            raise ValueError(f"{'/'.join(src)}: {tuple(t.shape)} {t.dtype} does not fit "
                             f"{name} {tuple(param.shape)} {param.dtype}")
        with torch.no_grad():
            param.copy_(t)
        used.add(src)
    unused = set(_leaf_paths(tree)) - used
    if unused:
        raise ValueError(f"leaves with no parameter of {cfg.name}: {sorted(unused)}")
    return model
