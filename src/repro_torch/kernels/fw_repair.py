"""Rank-E repair: wrappers around the Hopper kernels.

``fw_repair`` replaces ``repro.kernels.fw_repair.fw_repair`` and
``fw_repair_with_successors`` its next-hop twin.  Both absorb E
⊕-improving edge updates ``(u_e, v_e, w_e)`` into a closed (n, n) matrix,
in order: ``d ⊕= (d[:, u_e] ⊗ w_e) ⊗ d[v_e, :]``.  On the card a batch of
up to ``MAX_EDGES`` edges is two launches on the current stream — stage
(the evolved pivot rows into an (E, n) buffer, and each row's E scalars
(row i at column u_e before step e) ⊗ w_e into an (n, E) one: the
``RepairBuffers``) and apply (``d ⊕ scalars ⊗ staged``, a rank-E update
streamed over 2-D tiles); ``csrc/fw_repair.cu`` says why.  Longer batches
run one launch pair per ``MAX_EDGES`` edges, which is the same sequence of
steps.

Storage.  ``d`` is f32 (``csrc/fw_repair.cu``) or one of the storages the
reference compiles its repair for (``csrc/fw_repair_lowered.cu``, the
same ``MAX_EDGES`` a launch pair): bf16 or f16 with any of the
five semirings, int16 with the saturating ``*_i16`` lowerings, one int32
word plane of ``OR_AND_PACKED`` (w is then a lane mask), or the int32
carrier of an integer or_and / plus_mul storage; the successor repair
takes f32, bf16 or f16 distances.  The storage tags are
``fw_round.LOWERINGS``'.

The edges are three device vectors: ``u``, ``v`` int32 and ``w`` in d's
dtype.  The reference's int32 bit-pattern encoding of the weights
(``encode_weights``) served the TPU's scalar-prefetch channel and has no
counterpart here: the weights are stored in d's dtype, as that encoding
carries their bits.

Both wrappers return new tensors and leave ``d`` (and ``succ``) as they
were.  A tensor on the CPU goes to the plain version in ``kernels.ref``; a
CUDA tensor goes to the kernels, and a launch that fails raises (a strided
or unaligned one through a contiguous, aligned copy:
``fw_round.contiguous_aligned``).  There is no fallback between the two.
``LAUNCHES`` counts kernel launches by kind; a lowered launch counts under
its own kind, e.g. ``fw_repair/apply[int16]``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.semiring import MIN_PLUS, Semiring
from repro_torch.kernels import ref
from repro_torch.kernels.fw_round import LOWERINGS, contiguous_aligned, storage_tag
from repro_torch.kernels.minplus_matmul import _raise_on, semiring_id

MAX_EDGES = 64  # edges one stage + apply launch pair carries, in every storage
PHASES = ("stage", "apply")
SUCC_LOWERINGS = ("bf16", "f16")
KINDS = (
    tuple(f"{fn}/{p}" for fn in ("fw_repair", "fw_repair_with_successors") for p in PHASES)
    + tuple(f"fw_repair/{p}[{tag}]" for tag in LOWERINGS for p in PHASES)
    + tuple(f"fw_repair_with_successors/{p}[{tag}]" for tag in SUCC_LOWERINGS for p in PHASES)
)
LAUNCHES = dict.fromkeys(KINDS, 0)
_SUCC_TAGS = {torch.float32: None, torch.bfloat16: "bf16", torch.float16: "f16"}


def reset_launch_counts() -> None:
    for kind in LAUNCHES:
        LAUNCHES[kind] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("fw_repair")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fw_repair_launch.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i, p]
    lib.fw_repair_launch.restype = i
    lib.fw_repair_succ_launch.argtypes = [i, p, p, p, p, p, p, p, p, p, p, i, i, i, p]
    lib.fw_repair_succ_launch.restype = i
    return lib


@functools.cache
def _lowered_lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("fw_repair_lowered")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fw_repair_lowered_launch.argtypes = [i, i, i, p, p, p, p, p, p, p, i, i, i, p]
    lib.fw_repair_lowered_launch.restype = i
    lib.fw_repair_lowered_succ_launch.argtypes = [i, i, p, p, p, p, p, p, p, p, p, p, i, i, i, p]
    lib.fw_repair_lowered_succ_launch.restype = i
    return lib


def _check(d: torch.Tensor, block_size: int, what: str = "d", dtype=None) -> int:
    """n of a (n, n) repair input; raises on what the kernels do not take
    (dtype None: any dtype, checked by ``storage_tag``)."""
    if d.ndim != 2 or d.shape[0] != d.shape[1]:
        raise ValueError(f"{what} must be (n, n), got {tuple(d.shape)}")
    if dtype is not None and d.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {d.dtype}")
    n = d.shape[0]
    if block_size < 1 or n % block_size:
        raise ValueError(f"{what} must be (n, n) with n % {block_size} == 0, got {n}")
    if d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} must lie on the CPU or a CUDA device, not {d.device}")
    return n


def succ_tag(d: torch.Tensor) -> str | None:
    """The storage tag of a successor repair on d (None = f32)."""
    if d.dtype not in _SUCC_TAGS:
        raise TypeError(f"successor repairs take float32, bfloat16 or float16 distances, "
                        f"got {d.dtype}")
    return _SUCC_TAGS[d.dtype]


def edge_vectors(u, v, w, n: int, device, dtype=torch.float32):
    """(u, v, w) → contiguous int32 / int32 / ``dtype`` vectors on ``device``.

    Raises unless they are equal-length, non-empty and 0 <= u, v < n: the
    kernels index with them unchecked (the reference's ``dynamic_slice``
    would clamp instead).
    """
    vecs = []
    for x, dt in ((u, torch.int32), (v, torch.int32), (w, dtype)):
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


class RepairBuffers(NamedTuple):
    """What a stage launch writes and its apply reads: staged (E, n), row e
    the row v_e before step e; scalars (n, E), row i's (row i at column
    u_e before step e) ⊗ w_e, both in d's dtype; hops (n, E) int32, the
    successor repair's hop of an improvement at step e (else None)."""

    staged: torch.Tensor
    scalars: torch.Tensor
    hops: torch.Tensor | None


def repair_buffers(d: torch.Tensor, E: int, *, successors: bool = False) -> RepairBuffers:
    """Empty buffers of one launch pair of E edges on (n, n) d."""
    n = d.shape[-1]
    empty = functools.partial(torch.empty, device=d.device)
    return RepairBuffers(empty((E, n), dtype=d.dtype), empty((n, E), dtype=d.dtype),
                         empty((n, E), dtype=torch.int32) if successors else None)


def apply_vectors(*tables: torch.Tensor) -> bool:
    """Whether an apply launch moves 16-byte vectors: every row of every
    table (d, out, the staged rows, next hops) starts 16-byte aligned.
    Else it moves one element at a time (so an unaligned view of out
    holds the element path to the same values)."""
    return all(t.data_ptr() % 16 == 0 and t.shape[-1] * t.element_size() % 16 == 0
               for t in tables)


def repair_phase(
    phase: str, d: torch.Tensor, u, v, w, bufs: RepairBuffers,
    out: torch.Tensor | None = None, *, semiring: Semiring = MIN_PLUS,
) -> None:
    """Launch one phase of a repair on the card: "stage" writes the evolved
    pivot rows of d and its row scalars into ``bufs``
    (``repair_buffers``); "apply" folds them into out (n, n), which shares
    no memory with d.  u, v, w: ``edge_vectors`` on d's device in d's
    dtype, 1 <= E <= ``MAX_EDGES``; the apply's path follows
    ``apply_vectors``."""
    tag = storage_tag(d, semiring)
    sid = semiring_id(semiring)
    _launch("fw_repair", phase, tag, d, None, u, v, w, bufs, out, None, sid)


def repair_succ_phase(
    phase: str, d: torch.Tensor, succ: torch.Tensor, u, v, w, bufs: RepairBuffers,
    out: torch.Tensor | None = None, succ_out: torch.Tensor | None = None,
) -> None:
    """One phase of the successor repair on the card (min-plus; d f32,
    bf16 or f16; ``bufs`` with hops): the stage reads succ for the hops."""
    _launch("fw_repair_with_successors", phase, succ_tag(d), d, succ, u, v, w, bufs,
            out, succ_out, None)


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two contiguous tensors share a byte."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() * b.element_size() and b0 < a0 + a.numel() * a.element_size()


def _launch(fn, phase, tag, d, succ, u, v, w, bufs, out, succ_out, sid) -> None:
    if phase not in PHASES:
        raise ValueError(f"phase must be one of {PHASES}, got {phase!r}")
    n = _check(d, 1)
    E = len(u)
    if d.device.type != "cuda":
        raise ValueError(f"{fn} phases launch a CUDA kernel; d is on the CPU")
    if not 1 <= E <= MAX_EDGES:
        raise ValueError(f"one launch takes 1..{MAX_EDGES} edges, got {E}")
    staged, scal, hops = bufs
    if (succ is None) != (hops is None):
        raise ValueError(f"{fn}: hops buffer {'missing' if hops is None else 'not taken'}")
    inputs = [d, u, v, w, staged, scal] + ([succ, hops] if succ is not None else [])
    outputs = [out] if succ is None else [out, succ_out]
    tensors = inputs + (outputs if phase == "apply" else [])
    if any(t is None or t.device != d.device or not t.is_contiguous() for t in tensors):
        raise ValueError(f"{fn}/{phase}: every tensor must be contiguous on {d.device}")
    if (tuple(staged.shape) != (E, n) or tuple(scal.shape) != (n, E)
            or staged.dtype != d.dtype or scal.dtype != d.dtype or w.dtype != d.dtype):
        raise ValueError(f"staged must be ({E}, {n}), scalars ({n}, {E}) and w ({E},), all "
                         f"{d.dtype}; got {tuple(staged.shape)} {staged.dtype}, "
                         f"{tuple(scal.shape)} {scal.dtype}, w {w.dtype}")
    if hops is not None and (tuple(hops.shape) != (n, E) or hops.dtype != torch.int32):
        raise ValueError(f"hops must be ({n}, {E}) int32, got {tuple(hops.shape)} {hops.dtype}")
    if succ is not None:
        _check(succ, 1, "succ", torch.int32)
        if succ.shape != d.shape:
            raise ValueError(f"{fn}: succ must match d {tuple(d.shape)}")
    vec = False
    if phase == "apply":
        _check(out, 1, "out", d.dtype)
        if succ is not None:
            _check(succ_out, 1, "succ_out", torch.int32)
        if any(t.shape != d.shape for t in outputs):
            raise ValueError(f"{fn}/apply: outputs must match d {tuple(d.shape)}")
        tables = inputs + outputs
        if any(_overlaps(o, t) for k, o in enumerate(outputs) for m, t in enumerate(tables)
               if m != len(inputs) + k):
            raise ValueError(f"{fn}/apply: an output shares memory with an input or the "
                             f"other output")
        vec = apply_vectors(d, staged, *outputs, *([succ] if succ is not None else []))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    tables = (d, out) if succ is None else (d, succ, out, succ_out)
    bufs_p = (staged, scal) if succ is None else (staged, scal, hops)
    ptrs = (*map(ptr, tables), *map(ptr, bufs_p), *map(ptr, (u, v, w)), n, E)
    ph = PHASES.index(phase)
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        if tag is None and succ is None:
            err = _lib().fw_repair_launch(ph, *ptrs, sid, int(vec), stream)
        elif tag is None:
            err = _lib().fw_repair_succ_launch(ph, *ptrs, int(vec), stream)
        elif succ is None:
            err = _lowered_lib().fw_repair_lowered_launch(ph, LOWERINGS[tag], sid, *ptrs,
                                                          int(vec), stream)
        else:
            err = _lowered_lib().fw_repair_lowered_succ_launch(ph, LOWERINGS[tag], *ptrs,
                                                               int(vec), stream)
    kind = f"{fn}/{phase}" + (f"[{tag}]" if tag else "")
    _raise_on(err, kind)
    LAUNCHES[kind] += 1


def fw_repair(
    d: torch.Tensor, u, v, w, *, block_size: int = 128,
    semiring: Semiring = MIN_PLUS,
) -> torch.Tensor:
    """Repair closed (n, n) ``d`` for E ⊕-improving edge updates.

    d: f32, bf16 or f16 with a float semiring, int16 with an ``*_i16``
    lowering, one int32 word plane with ``OR_AND_PACKED`` (w: lane masks),
    or the int32 carrier of an integer or_and / plus_mul storage.  u / v:
    (E,) endpoints; w: (E,) ⊕-deltas in d's dtype (the improved weight for
    the idempotent semirings, the additive delta for plus_mul).
    block_size: the reference's contract, n % block_size == 0 (the engine
    pads to it); the kernels' own tiling does not depend on it.  Returns a
    new tensor.
    """
    n = _check(d, block_size)
    storage_tag(d, semiring)  # refuses a storage the kernels do not take
    u, v, w = edge_vectors(u, v, w, n, d.device, d.dtype)
    if d.device.type == "cpu":
        return ref.fw_repair_ref(d, u, v, w, semiring=semiring)
    out = d = contiguous_aligned(d)
    for c in range(0, len(u), MAX_EDGES):
        e = slice(c, c + MAX_EDGES)
        bufs = repair_buffers(d, len(u[e]))
        nxt = torch.empty_like(d)
        repair_phase("stage", out, u[e], v[e], w[e], bufs, semiring=semiring)
        repair_phase("apply", out, u[e], v[e], w[e], bufs, nxt, semiring=semiring)
        out = nxt
    return out


def fw_repair_with_successors(
    d: torch.Tensor, succ: torch.Tensor, u, v, w, *, block_size: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """min-plus repair carrying the int32 next-hop table: (dist', succ').

    d: f32, bf16 or f16 (candidates ``(d[i, u] + w) + d[v, j]``, each add
    rounded to d's dtype).  The strict-improvement relaxation (``cand <
    d``) of ``fw_round_with_successors``; an improved pair (i, j) takes hop
    v_e where i == u_e, else ``succ[i, u_e]`` as it stood before step e.
    Returns new tensors.
    """
    n = _check(d, block_size)
    succ_tag(d)  # refuses a storage the kernels do not take
    _check(succ, block_size, "succ", torch.int32)
    if succ.shape != d.shape or succ.device != d.device:
        raise ValueError(
            f"succ {tuple(succ.shape)} on {succ.device} does not match "
            f"d {tuple(d.shape)} on {d.device}"
        )
    u, v, w = edge_vectors(u, v, w, n, d.device, d.dtype)
    if d.device.type == "cpu":
        return ref.fw_repair_with_successors_ref(d, succ, u, v, w)
    out, sout = d, succ = contiguous_aligned(d), contiguous_aligned(succ)
    for c in range(0, len(u), MAX_EDGES):
        e = slice(c, c + MAX_EDGES)
        bufs = repair_buffers(d, len(u[e]), successors=True)
        nxt, snxt = torch.empty_like(d), torch.empty_like(succ)
        repair_succ_phase("stage", out, sout, u[e], v[e], w[e], bufs)
        repair_succ_phase("apply", out, sout, u[e], v[e], w[e], bufs, nxt, snxt)
        out, sout = nxt, snxt
    return out, sout
