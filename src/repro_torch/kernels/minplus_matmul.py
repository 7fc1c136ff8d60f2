"""The staged semiring matmul and the relaxation chain it folds.

``semiring_matmul`` replaces ``repro.kernels.minplus_matmul.semiring_matmul``:
C [⊕=] A ⊗⊕ B for (m,k)·(k,n) or batched (B,m,k)·(B,k,n) f32 operands,
any m, k, n >= 1.  A tensor on the CPU goes to the plain version
(``kernels.ref.semiring_matmul_ref``), a CUDA tensor to the kernel of
``csrc/minplus_matmul.cu``, and a launch that fails raises; there is no
fallback between the two.  ``LAUNCHES`` counts the kernel's launches.

Beside it, the torch counterparts of the reference's ``_fit_block`` and of
the k-ascending variants of ``_stage_compute``, the chain every phase-3
relaxation of the port folds.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.semiring import MIN_PLUS, Semiring, require_f32_a4b

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


# Storage types of the lowerings, which the f32-only kernels refuse (A.4b).
_LOWERED_STORAGE = (torch.bfloat16, torch.float16, torch.int16, torch.int32)


def check_f32(t: torch.Tensor, what: str) -> None:
    """f32, or raise: NotImplementedError naming ROADMAP A.4b for a lowered
    storage type (never widened), TypeError for any other."""
    if t.dtype in _LOWERED_STORAGE:
        raise NotImplementedError(
            f"{what} is {t.dtype}: this kernel runs float32 only; its lowered "
            f"forms are not ported yet (ROADMAP A.4b)"
        )
    if t.dtype != torch.float32:
        raise TypeError(f"{what} must be torch.float32, got {t.dtype}")


def check_operand(t: torch.Tensor, what: str) -> None:
    """f32, (r, c) or (B, r, c), on the CPU or a CUDA device."""
    if t.ndim not in (2, 3):
        raise ValueError(f"{what} must be 2-D or batched 3-D, got {tuple(t.shape)}")
    check_f32(t, what)
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} must lie on the CPU or a CUDA device, not {t.device}")


def view_args(t: torch.Tensor, what: str) -> tuple[int, int, int]:
    """(pointer, row stride, batch stride) of a card operand, which must
    have unit column stride."""
    if t.stride(-1) != 1 and t.shape[-1] > 1:
        raise ValueError(f"{what} must have unit column stride, got strides {t.stride()}")
    return t.data_ptr(), t.stride(-2), (t.stride(0) if t.ndim == 3 else 0)


def output(out, shape, like: torch.Tensor, what: str = "out") -> torch.Tensor:
    """``out`` checked against shape and device, or a new tensor."""
    if out is None:
        return torch.empty(shape, dtype=torch.float32, device=like.device)
    if tuple(out.shape) != tuple(shape) or out.device != like.device or out.dtype != torch.float32:
        raise ValueError(f"{what} {tuple(out.shape)} {out.dtype} on {out.device} does not "
                         f"fit a float32 result {tuple(shape)} on {like.device}")
    return out


def semiring_id(semiring: Semiring, *, lowered: bool = False) -> int:
    """The kernels' semiring code.  A storage lowering raises (A.4b) unless
    ``lowered``: the lowered round maps it to its abstract semiring's code
    (``min_plus_i16`` → min_plus, ``or_and_packed`` → or_and), and its
    storage code tells the two apart."""
    name = semiring.name
    if semiring.dtype is not None:
        if not lowered:
            raise NotImplementedError(
                f"semiring {name!r} is a storage lowering: this kernel runs "
                f"float32 only (ROADMAP A.4b)"
            )
        name = name.removesuffix("_i16").removesuffix("_packed")
    sid = _SEMIRING_IDS.get(name)
    if sid is None:
        raise ValueError(f"no CUDA kernel for semiring {semiring.name!r}")
    return sid


# ------------------------------------------------------------- the kernel
LAUNCHES = {"semiring_matmul": 0}


def reset_launch_counts() -> None:
    LAUNCHES["semiring_matmul"] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("minplus_matmul")
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.semiring_matmul_launch.argtypes = [p, q, q, p, q, q, p, q, q, p, q, q,
                                           i, i, i, i, ctypes.c_float, i, p]
    lib.semiring_matmul_launch.restype = i
    return lib


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
    the result's shape; f32.  Without c the fold starts from the
    semiring's zero.  Returns a new tensor; c is left as it was.

    bm / bn / bk: the reference's tile and staging depth, which choose no
    element's chain; accepted, the kernel tiles its own way.  variant:
    "fori" or "unroll" (the same chain); "broadcast" raises.  ``out``
    (internal): the buffer to write; it may be c itself (each element reads
    only its own c before writing it), never a or b.
    """
    from repro_torch.kernels import ref  # ref imports this module

    check_variant(variant)
    require_f32_a4b(semiring, where="semiring_matmul")
    for t, what in ((a, "a"), (b, "b")) + (() if c is None else ((c, "c"),)):
        check_operand(t, what)
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
    cv = (None, 0, 0) if c is None else view_args(c, "c")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _lib().semiring_matmul_launch(
            *view_args(a, "a"), *view_args(b, "b"), *cv, *view_args(out, "out"),
            max(B, 1), m, n, k, semiring.zero, semiring_id(semiring), stream)
    _raise_on(err, "semiring_matmul")
    LAUNCHES["semiring_matmul"] += 1
    return out
