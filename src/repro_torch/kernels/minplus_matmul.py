"""The staged semiring matmul and the relaxation chain it folds.

``semiring_matmul`` replaces ``repro.kernels.minplus_matmul.semiring_matmul``:
C [⊕=] A ⊗⊕ B for (m,k)·(k,n) or batched (B,m,k)·(B,k,n) operands, any
m, k, n >= 1, in f32 or a storage lowering (``storage_tag``: bf16 / f16
with a float semiring, int16 with an ``*_i16`` lowering, int32 words with
``OR_AND_PACKED``, the int32 carrier of an integer or_and / plus_mul
storage).  A tensor on the CPU goes to the plain version
(``kernels.ref.semiring_matmul_ref``), a CUDA tensor to the kernel of
``csrc/minplus_matmul.cu`` (f32) or ``csrc/minplus_matmul_lowered.cu``,
and a launch that fails raises; there is no fallback between the two and
no lowered input is widened.  ``LAUNCHES`` counts the kernel's launches,
a lowered one under its own kind (``semiring_matmul[int16]``), and
``LAUNCH_SHAPES`` the same launches by (kind, m, k, n).

Beside it, what every kernel wrapper of the port shares: the storage tags
and the semiring codes of the CUDA sources, operand checks, and the torch
counterparts of the reference's ``_fit_block`` and of the k-ascending
variants of ``_stage_compute``, the chain every phase-3 relaxation of the
port folds.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.core.semiring import MIN_PLUS, Semiring

VARIANTS = ("fori", "unroll")


def _fit_block(dim: int, want: int) -> int:
    """Largest divisor of dim that is ≤ want (keeps grids exact for any n)."""
    want = min(want, dim)
    for b in range(want, 0, -1):
        if dim % b == 0:
            return b
    return dim


def check_variant(variant: str) -> None:
    """Only the k-ascending chain is ported: "fori" and "unroll" run the same
    rank-1 steps in the same order; "broadcast" reduces in XLA's order."""
    if variant not in VARIANTS:
        raise ValueError(
            f"variant={variant!r} is not supported: the port runs the "
            f"k-ascending chain of {VARIANTS} only (\"broadcast\" reduces in "
            f"XLA's own order, which no kernel here reproduces)"
        )


def _stage_compute(
    acc: torch.Tensor, a_blk: torch.Tensor, b_blk: torch.Tensor,
    semiring: Semiring, variant: str = "fori",
) -> torch.Tensor:
    """⊕-accumulate one (…, bm×bk)·(…, bk×bn) panel-slice stage into acc."""
    check_variant(variant)
    for kk in range(a_blk.shape[-1]):
        acc = semiring.relax(acc, a_blk[..., :, kk, None], b_blk[..., kk, None, :])
    return acc


# ------------------------------------------- shared by the kernel wrappers
BLOCK_SIZES = (16, 32, 64, 128)  # the pivot widths the round kernels take
_SEMIRING_IDS = {"min_plus": 0, "max_plus": 1, "max_min": 2, "or_and": 3,
                 "plus_mul": 4}


def _raise_on(err: int, kind: str) -> None:
    if err:
        raise RuntimeError(f"{kind} launch failed: cudaError_t {err}")


# Storage lowerings of the kernels: tag → storage code of the *_lowered.cu
# sources.  The two int32 tags share the integer storage; the semiring code
# tells them apart.
LOWERINGS = {"bf16": 0, "f16": 1, "int16": 2, "packed": 3, "or_and_i32": 4,
             "plus_mul_i32": 4}
_INT32_TAGS = {"or_and": "or_and_i32", "plus_mul": "plus_mul_i32"}
_FLOAT_TAGS = {torch.float32: None, torch.bfloat16: "bf16", torch.float16: "f16"}


def storage_tag(w: torch.Tensor, semiring: Semiring) -> str | None:
    """The storage tag of a kernel on w (None = the f32 kernels), one of
    ``LOWERINGS``; raises TypeError where w's dtype is not the semiring's
    storage."""
    if semiring.packed:
        want, tag = torch.int32, "packed"
    elif semiring.dtype == "int16":
        want, tag = torch.int16, "int16"
    elif w.dtype in _FLOAT_TAGS:
        return _FLOAT_TAGS[w.dtype]
    elif w.dtype == torch.int32 and semiring.name in _INT32_TAGS:
        return _INT32_TAGS[semiring.name]
    else:
        raise TypeError(f"w must be float32, bfloat16 or float16 (int32 for or_and, "
                        f"plus_mul) for semiring {semiring.name!r}, got {w.dtype}")
    if w.dtype != want:
        raise TypeError(f"semiring {semiring.name!r} stores {want}, got w of {w.dtype}")
    return tag


def check_operand(t: torch.Tensor, what: str, like: torch.Tensor | None = None) -> None:
    """(r, c) or (B, r, c), on the CPU or a CUDA device, and (given
    ``like``) in like's dtype: the storage is never converted."""
    if t.ndim not in (2, 3):
        raise ValueError(f"{what} must be 2-D or batched 3-D, got {tuple(t.shape)}")
    if like is not None and t.dtype != like.dtype:
        raise TypeError(f"{what} is {t.dtype}, the other operands {like.dtype}: one "
                        f"storage dtype throughout")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} must lie on the CPU or a CUDA device, not {t.device}")


def view_args(t: torch.Tensor, what: str) -> tuple[int, int, int]:
    """(pointer, row stride, batch stride) of a card operand, which must
    have unit column stride."""
    if t.stride(-1) != 1 and t.shape[-1] > 1:
        raise ValueError(f"{what} must have unit column stride, got strides {t.stride()}")
    return t.data_ptr(), t.stride(-2), (t.stride(0) if t.ndim == 3 else 0)


def output(out, shape, like: torch.Tensor, what: str = "out") -> torch.Tensor:
    """``out`` checked against shape, dtype and device, or a new tensor in
    like's dtype."""
    if out is None:
        return torch.empty(shape, dtype=like.dtype, device=like.device)
    if tuple(out.shape) != tuple(shape) or out.device != like.device or out.dtype != like.dtype:
        raise ValueError(f"{what} {tuple(out.shape)} {out.dtype} on {out.device} does not "
                         f"fit a {like.dtype} result {tuple(shape)} on {like.device}")
    return out


def semiring_id(semiring: Semiring) -> int:
    """The kernels' semiring code: a lowering maps to its abstract
    semiring's (``min_plus_i16`` → min_plus, ``or_and_packed`` → or_and),
    and the storage code tells the two apart."""
    sid = _SEMIRING_IDS.get(semiring.name.removesuffix("_i16").removesuffix("_packed"))
    if sid is None:
        raise ValueError(f"no CUDA kernel for semiring {semiring.name!r}")
    return sid


def zero_bits(semiring: Semiring, dtype: torch.dtype) -> int:
    """The bits of the semiring's ⊕-identity in the storage ``dtype``, as the
    unsigned int the kernels take (the low 16 bits for 2-byte storages)."""
    z = torch.tensor(semiring.zero, dtype=dtype)
    width = z.element_size() * 8
    return int(z.view({16: torch.int16, 32: torch.int32}[width])) & ((1 << width) - 1)


# ------------------------------------------------------------- the kernel
KINDS = ("semiring_matmul",) + tuple(f"semiring_matmul[{tag}]" for tag in LOWERINGS)
LAUNCHES = dict.fromkeys(KINDS, 0)
LAUNCH_SHAPES: collections.Counter = collections.Counter()  # (kind, m, k, n) -> launches


def reset_launch_counts() -> None:
    for kind in LAUNCHES:
        LAUNCHES[kind] = 0
    LAUNCH_SHAPES.clear()


@functools.cache
def _lib(lowered: bool = False) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    p, i, q, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
    operands = [p, q, q, p, q, q, p, q, q, p, q, q, i, i, i, i, u]
    if lowered:
        lib = _build.load("minplus_matmul_lowered")
        lib.semiring_matmul_lowered_launch.argtypes = [i, i] + operands + [i, p]
        lib.semiring_matmul_lowered_launch.restype = i
    else:
        lib = _build.load("minplus_matmul")
        lib.semiring_matmul_launch.argtypes = operands + [i, i, p]
        lib.semiring_matmul_launch.restype = i
    return lib


STAGINGS = ("scalar", "vector")  # the kernel's staging codes, by index


def staging(itemsize: int, pointers, strides) -> int:
    """The kernel's staging for operands of ``itemsize`` bytes: 1 (16-byte
    vector copies) when every pointer is 16-byte aligned and every row and
    batch stride (in elements) spans a whole number of 16 bytes, else 0
    (one element at a time).  Both are the same kernel and fold the same
    chain; this only picks how the slices reach shared memory."""
    return int(all(p % 16 == 0 for p in pointers)
               and all(s * itemsize % 16 == 0 for s in strides))


def operand_staging(*views: tuple[int, int, int], itemsize: int) -> int:
    """``staging`` of the (pointer, row stride, batch stride) triples that
    ``view_args`` gives for a, b, c (when there is one) and out."""
    return staging(itemsize, [v[0] for v in views], [s for v in views for s in v[1:]])


def staging_name(*operands: torch.Tensor | None) -> str:
    """The staging ("scalar" / "vector") a launch on these operands (a, b,
    c or None, out) takes."""
    ts = [t for t in operands if t is not None]
    views = [view_args(t, "operand") for t in ts]
    return STAGINGS[operand_staging(*views, itemsize=ts[0].element_size())]


def _shapes(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int, int, int]:
    """(B, m, k, n); B = 0 for an unbatched product."""
    if a.ndim == 3:
        if b.ndim != 3 or a.shape[0] != b.shape[0]:
            raise ValueError(f"batched operands disagree: {tuple(a.shape)} @ {tuple(b.shape)}")
        B = a.shape[0]
    elif a.ndim == 2 and b.ndim == 2:
        B = 0
    else:
        raise ValueError(f"operands must be (m,k)·(k,n) or batched, got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    (m, k), (k2, n) = a.shape[-2:], b.shape[-2:]
    if k != k2:
        raise ValueError(f"contraction mismatch {tuple(a.shape)} @ {tuple(b.shape)}")
    if min(m, k, n) < 1 or (a.ndim == 3 and B < 1):
        raise ValueError(f"empty product {tuple(a.shape)} @ {tuple(b.shape)}")
    return B, m, k, n


def semiring_matmul(
    a: torch.Tensor, b: torch.Tensor, c: torch.Tensor | None = None, *,
    semiring: Semiring = MIN_PLUS, bm: int = 256, bn: int = 256, bk: int = 32,
    variant: str = "fori", out: torch.Tensor | None = None,
) -> torch.Tensor:
    """C [⊕=] A ⊗⊕ B: a (m,k) or (B,m,k), b (k,n) or (B,k,n), optional c of
    the result's shape, all in one storage dtype (f32 or the semiring's
    lowering, ``storage_tag``).  Without c the fold starts from the
    semiring's zero.  Returns a new tensor in that dtype; c is left as it
    was.

    bm / bn / bk: the reference's tile and staging depth, which choose no
    element's chain; accepted, the kernel tiles its own way.  variant:
    "fori" or "unroll" (the same chain); "broadcast" raises.  ``out``
    (internal): the buffer to write; it may be c itself (each element reads
    only its own c before writing it), never a or b.
    """
    from repro_torch.kernels import ref  # ref imports this module

    check_variant(variant)
    for t, what in ((a, "a"), (b, "b")) + (() if c is None else ((c, "c"),)):
        check_operand(t, what, a)
    tag = storage_tag(a, semiring)
    B, m, k, n = _shapes(a, b)
    shape = (B, m, n) if a.ndim == 3 else (m, n)
    if c is not None and tuple(c.shape) != shape:
        raise ValueError(f"c {tuple(c.shape)} does not match the product's {shape}")
    if b.device != a.device or (c is not None and c.device != a.device):
        raise ValueError("a, b and c must lie on one device")
    if a.device.type == "cpu":
        res = ref.semiring_matmul_ref(a, b, c, semiring=semiring, bk=bk)
        return res if out is None else output(out, shape, a).copy_(res)
    out = output(out, shape, a)
    if max(B, 1) > 65535 or -(-m // 128) > 65535:
        raise ValueError(f"grid too large for {tuple(a.shape)} @ {tuple(b.shape)}")
    views = [view_args(a, "a"), view_args(b, "b")] + ([] if c is None else [view_args(c, "c")])
    views.append(view_args(out, "out"))
    stg = operand_staging(*views, itemsize=a.element_size())
    cv = (None, 0, 0) if c is None else views[2]
    args = (*views[0], *views[1], *cv, *views[-1], max(B, 1), m, n, k,
            zero_bits(semiring, a.dtype))
    kind = "semiring_matmul" + (f"[{tag}]" if tag else "")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if tag is None:
            err = _lib().semiring_matmul_launch(*args, semiring_id(semiring), stg, stream)
        else:
            err = _lib(True).semiring_matmul_lowered_launch(
                LOWERINGS[tag], semiring_id(semiring), *args, stg, stream)
    _raise_on(err, kind)
    LAUNCHES[kind] += 1
    LAUNCH_SHAPES[kind, m, k, n] += 1
    return out
