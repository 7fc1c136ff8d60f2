"""Single-token GQA decode attention: the wrapper around the Hopper kernel.

``flash_decode`` replaces ``repro.kernels.flash_decode.flash_decode``: q
(B, Hkv, g, hd) attends over k / v (B, S, Hkv, hd) rows [0, kv_len) with
an online softmax and returns (B, Hkv, g, hd) in q's dtype (f32 or bf16).
A tensor on the CPU goes to the plain online-softmax walk
(``kernels.ref.flash_decode_online_ref``, bs-row blocks as the reference
kernel walks them); a CUDA tensor goes to ``csrc/flash_decode.cu`` (a KV
split launch, bf16 on tensor cores with P rounded to bf16 before it meets
V, and a combine launch), and a launch that fails raises.  There
is no fallback between the two.  ``LAUNCHES`` counts the kernel's calls,
each a split launch and a combine launch.  Nothing in the solver calls it: it is its own entry point, as in
the reference.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.minplus_matmul import _raise_on

LAUNCHES = {"flash_decode": 0}  # one a call: its split and combine launches
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
MAX_GROUP = 8  # q rows a KV head
# The kernel's split: a CTA of 4 warps takes `chunk` rows in 16-row tiles,
# so chunk is a multiple of 64.  About 256 CTAs: one wave of two CTAs an SM
# on the H100's 132 SMs (bf16 takes 96 KB of shared memory a CTA), long
# enough that each CTA's ring start-up is a small share of it, and few
# partials for the combine (its time grows with nsplit: measured 5 µs at
# 8 splits, 20 µs at 32, at the Qwen2-7B shape).
_SPLIT_ROWS = 64
_TARGET_CTAS = 256


def reset_launch_counts() -> None:
    LAUNCHES["flash_decode"] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("flash_decode")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_decode_launch.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                                        ctypes.c_float, p]
    lib.flash_decode_launch.restype = i
    return lib


def _check(q, k, v) -> tuple[int, int, int, int, int]:
    """(B, Hkv, g, hd, S); raises on what the kernel does not take."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B,Hkv,g,hd) and k, v (B,S,Hkv,hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hkv, g, hd = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, Hkv, hd):
        raise ValueError(f"k / v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v must share a dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device) or q.device.type not in ("cpu", "cuda"):
        raise ValueError("q, k and v must lie on one device, the CPU or a CUDA card")
    return B, Hkv, g, hd, k.shape[1]


@functools.cache
def split_plan(B: int, Hkv: int, S: int) -> tuple[int, int]:
    """(chunk, nsplit) of the kernel's KV split: chunk rows a split (one CTA
    each), a multiple of 64; nsplit * chunk >= S, with about
    ``_TARGET_CTAS`` CTAs over all (b, h)."""
    want = max(1, _TARGET_CTAS // (B * Hkv))
    rows = -(-S // want)
    chunk = -(-rows // _SPLIT_ROWS) * _SPLIT_ROWS
    return chunk, -(-S // chunk)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len, *,
                 bs: int = 256) -> torch.Tensor:
    """Decode attention of q (B, Hkv, g, hd) over k / v (B, S, Hkv, hd)[:,
    :kv_len] → (B, Hkv, g, hd) in q's dtype.

    kv_len: an int or a 0-d integer tensor (on the card it is read there,
    no host sync); positions at or past it are masked with -1e30 (kv_len =
    0 averages v).  bs: the reference's KV block, which the CPU walk takes
    (S when it does not divide S); the kernel splits the cache its own way,
    which changes only the rounding of the f32 sums.
    """
    B, Hkv, g, hd, S = _check(q, k, v)
    if S % bs:
        bs = S
    if q.device.type == "cpu":
        return ref.flash_decode_online_ref(q, k, v, kv_len, bs)
    if q.dtype not in _DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {q.dtype}")
    if hd not in HEAD_DIMS or g > MAX_GROUP:
        raise ValueError(f"the kernel takes hd in {HEAD_DIMS} and g <= {MAX_GROUP}, "
                         f"got hd={hd}, g={g}")
    if q.device.index != torch.cuda.current_device():
        with torch.cuda.device(q.device):
            return flash_decode(q, k, v, kv_len, bs=bs)
    q, k, v = (t.contiguous() for t in (q, k, v))
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    if not (isinstance(kv_len, torch.Tensor) and kv_len.dtype == torch.int32
            and kv_len.device == q.device and kv_len.numel() == 1):
        kv_len = torch.as_tensor(kv_len, dtype=torch.int32, device=q.device).reshape(1)
    chunk, nsplit = split_plan(B, Hkv, S)
    # One scratch buffer (fewer host calls before the launch): the split
    # partials m and l (B*Hkv, nsplit, g) and acc (B*Hkv, nsplit, g, hd), f32.
    parts = B * Hkv * nsplit * g
    scratch = torch.empty(parts * (hd + 2), dtype=torch.float32, device=q.device)
    pm = scratch.data_ptr()
    out = torch.empty_like(q)
    err = _lib().flash_decode_launch(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        pm, pm + 4 * parts, pm + 8 * parts, out.data_ptr(), B, Hkv, g, hd, S, chunk, nsplit,
        hd ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash_decode")
    LAUNCHES["flash_decode"] += 1
    return out
