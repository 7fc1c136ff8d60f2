"""Rank-1 repair: wrappers around the Hopper kernels.

``fw_repair`` replaces ``repro.kernels.fw_repair.fw_repair`` and
``fw_repair_with_successors`` its next-hop twin.  Both absorb E
⊕-improving edge updates ``(u_e, v_e, w_e)`` into a closed (n, n) f32
matrix, in order: ``d ⊕= (d[:, u_e] ⊗ w_e) ⊗ d[v_e, :]``.  On the card a
batch of up to ``MAX_EDGES`` edges is two launches on the current stream —
stage (the evolved pivot rows into an (E, n) buffer) and apply (every row
folds all E updates); ``csrc/fw_repair.cu`` says why.  Longer batches run
one launch pair per ``MAX_EDGES`` edges, which is the same sequence of
steps.

The edges are three device vectors: ``u``, ``v`` int32 and ``w`` f32.  The
reference's int32 bit-pattern encoding of the weights
(``encode_weights``) served the TPU's scalar-prefetch channel and has no
counterpart here; bf16 / int16 / packed weights are refused, not widened (ROADMAP A.4b).

Both wrappers return new tensors and leave ``d`` (and ``succ``) as they
were.  A tensor on the CPU goes to the plain version in ``kernels.ref``; a
CUDA tensor goes to the kernels, and a launch that fails raises.  There is
no fallback between the two.  ``LAUNCHES`` counts kernel launches by kind.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.semiring import MIN_PLUS, Semiring, require_f32
from repro_torch.kernels import ref
from repro_torch.kernels.minplus_matmul import _raise_on, check_f32, semiring_id

MAX_EDGES = 64  # edges one stage + apply launch pair carries
PHASES = ("stage", "apply")
KINDS = tuple(f"{fn}/{p}" for fn in ("fw_repair", "fw_repair_with_successors")
              for p in PHASES)
LAUNCHES = dict.fromkeys(KINDS, 0)


def reset_launch_counts() -> None:
    for kind in LAUNCHES:
        LAUNCHES[kind] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("fw_repair")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fw_repair_launch.argtypes = [i, p, p, p, p, p, p, i, i, i, p]
    lib.fw_repair_launch.restype = i
    lib.fw_repair_succ_launch.argtypes = [i, p, p, p, p, p, p, p, p, i, i, p]
    lib.fw_repair_succ_launch.restype = i
    return lib


def _check(d: torch.Tensor, block_size: int, what: str = "d", dtype=torch.float32) -> int:
    """n of a (n, n) repair input; raises on what the kernels do not take."""
    if d.ndim != 2 or d.shape[0] != d.shape[1]:
        raise ValueError(f"{what} must be (n, n), got {tuple(d.shape)}")
    if dtype == torch.float32:
        check_f32(d, what)
    elif d.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {d.dtype}")
    n = d.shape[0]
    if block_size < 1 or n % block_size:
        raise ValueError(f"{what} must be (n, n) with n % {block_size} == 0, got {n}")
    if d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} must lie on the CPU or a CUDA device, not {d.device}")
    if d.device.type == "cuda" and not d.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    return n


def edge_vectors(u, v, w, n: int, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(u, v, w) → contiguous int32 / int32 / f32 vectors on ``device``.

    Raises unless they are equal-length, non-empty and 0 <= u, v < n: the
    kernels index with them unchecked (the reference's ``dynamic_slice``
    would clamp instead).
    """
    vecs = []
    for x, dt in ((u, torch.int32), (v, torch.int32), (w, torch.float32)):
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        vecs.append(t.to(dtype=dt).reshape(-1))
    u, v, w = vecs
    if not len(u) == len(v) == len(w) or len(u) < 1:
        raise ValueError(
            f"u/v/w must be equal-length non-empty edge vectors, got "
            f"{len(u)}/{len(v)}/{len(w)}"
        )
    if bool(((u < 0) | (u >= n) | (v < 0) | (v >= n)).any()):
        raise ValueError(f"edge endpoints must lie in [0, {n})")
    return tuple(t.to(device).contiguous() for t in (u, v, w))


def repair_phase(
    phase: str, d: torch.Tensor, u, v, w, staged: torch.Tensor,
    out: torch.Tensor | None = None, *, semiring: Semiring = MIN_PLUS,
) -> None:
    """Launch one phase of a repair on the card: "stage" writes the evolved
    pivot rows of d into staged (E, n); "apply" folds them into out (n, n).
    u, v, w: ``edge_vectors`` on d's device, 1 <= E <= MAX_EDGES."""
    sid = semiring_id(semiring)
    _launch("fw_repair", phase, d, None, u, v, w, staged, out, None, sid)


def repair_succ_phase(
    phase: str, d: torch.Tensor, succ: torch.Tensor, u, v, w,
    staged: torch.Tensor, out: torch.Tensor | None = None,
    succ_out: torch.Tensor | None = None,
) -> None:
    """One phase of the successor repair on the card (min-plus)."""
    _launch("fw_repair_with_successors", phase, d, succ, u, v, w, staged, out,
            succ_out, None)


def _launch(fn, phase, d, succ, u, v, w, staged, out, succ_out, sid) -> None:
    if phase not in PHASES:
        raise ValueError(f"phase must be one of {PHASES}, got {phase!r}")
    n = _check(d, 1)
    E = len(u)
    if d.device.type != "cuda":
        raise ValueError(f"{fn} phases launch a CUDA kernel; d is on the CPU")
    if not 1 <= E <= MAX_EDGES:
        raise ValueError(f"one launch takes 1..{MAX_EDGES} edges, got {E}")
    tensors = [d, staged, u, v, w]
    if phase == "apply":
        tensors += [out] if succ is None else [succ, out, succ_out]
    if any(t is None or t.device != d.device or not t.is_contiguous() for t in tensors):
        raise ValueError(f"{fn}/{phase}: every tensor must be contiguous on {d.device}")
    if tuple(staged.shape) != (E, n) or staged.dtype != torch.float32:
        raise ValueError(f"staged must be ({E}, {n}) float32, got {tuple(staged.shape)}")
    if phase == "apply":
        _check(out, 1, "out")
        if succ is not None:
            _check(succ, 1, "succ", torch.int32)
            _check(succ_out, 1, "succ_out", torch.int32)
        if any(t.shape != d.shape for t in tensors[5:]):
            raise ValueError(f"{fn}/apply: outputs must match d {tuple(d.shape)}")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        if succ is None:
            err = _lib().fw_repair_launch(
                PHASES.index(phase), d.data_ptr(), ptr(out), staged.data_ptr(),
                u.data_ptr(), v.data_ptr(), w.data_ptr(), n, E, sid, stream,
            )
        else:
            err = _lib().fw_repair_succ_launch(
                PHASES.index(phase), d.data_ptr(), succ.data_ptr(), ptr(out),
                ptr(succ_out), staged.data_ptr(), u.data_ptr(), v.data_ptr(),
                w.data_ptr(), n, E, stream,
            )
    kind = f"{fn}/{phase}"
    _raise_on(err, kind)
    LAUNCHES[kind] += 1


def fw_repair(
    d: torch.Tensor, u, v, w, *, block_size: int = 128,
    semiring: Semiring = MIN_PLUS,
) -> torch.Tensor:
    """Repair closed (n, n) f32 ``d`` for E ⊕-improving edge updates.

    u / v: (E,) endpoints; w: (E,) ⊕-deltas (the improved weight for the
    idempotent semirings, the additive delta for plus_mul).  block_size:
    the reference's contract, n % block_size == 0 (the engine pads to it);
    the kernels' own tiling does not depend on it.  Returns a new tensor.
    """
    n = _check(d, block_size)
    require_f32(semiring, where="fw_repair")
    u, v, w = edge_vectors(u, v, w, n, d.device)
    if d.device.type == "cpu":
        return ref.fw_repair_ref(d, u, v, w, semiring=semiring)
    out = d
    for c in range(0, len(u), MAX_EDGES):
        e = slice(c, c + MAX_EDGES)
        staged = torch.empty((len(u[e]), n), dtype=d.dtype, device=d.device)
        nxt = torch.empty_like(d)
        repair_phase("stage", out, u[e], v[e], w[e], staged, semiring=semiring)
        repair_phase("apply", out, u[e], v[e], w[e], staged, nxt, semiring=semiring)
        out = nxt
    return out


def fw_repair_with_successors(
    d: torch.Tensor, succ: torch.Tensor, u, v, w, *, block_size: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """min-plus repair carrying the int32 next-hop table: (dist', succ').

    The strict-improvement relaxation (``cand < d``) of
    ``fw_round_with_successors``; an improved pair (i, j) takes hop v_e
    where i == u_e, else ``succ[i, u_e]`` as it stood before step e.
    Returns new tensors.
    """
    n = _check(d, block_size)
    _check(succ, block_size, "succ", torch.int32)
    if succ.shape != d.shape or succ.device != d.device:
        raise ValueError(
            f"succ {tuple(succ.shape)} on {succ.device} does not match "
            f"d {tuple(d.shape)} on {d.device}"
        )
    u, v, w = edge_vectors(u, v, w, n, d.device)
    if d.device.type == "cpu":
        return ref.fw_repair_with_successors_ref(d, succ, u, v, w)
    out, sout = d, succ
    for c in range(0, len(u), MAX_EDGES):
        e = slice(c, c + MAX_EDGES)
        staged = torch.empty((len(u[e]), n), dtype=d.dtype, device=d.device)
        nxt, snxt = torch.empty_like(d), torch.empty_like(succ)
        repair_succ_phase("stage", out, sout, u[e], v[e], w[e], staged)
        repair_succ_phase("apply", out, sout, u[e], v[e], w[e], staged, nxt, snxt)
        out, sout = nxt, snxt
    return out, sout
