"""APSP front-end: ``solve`` owns padding, dispatch, batching and checks.

Counterpart of ``repro.apsp.api.solve``:

  * **pad/unpad** — any n; padding vertices are ⊕-identity rows/cols with a
    ⊗-identity diagonal, unreachable under every semiring.
  * **dispatch** — "numpy" | "naive" | "blocked" | "staged" | "fused" |
    "recursive" | "distributed"; "auto" takes "naive" at n <= 64 and
    "fused" above.  "recursive" is the R-Kleene panel schedule of
    ``apsp.kleene``; ``hbm_budget=`` promotes any in-core tiled method to
    it when the padded matrix does not fit the budget, and the plan then
    keeps the matrix in pinned host memory and streams its panels.
    "staged" and "fused" both run the fused round, as the reference's do;
    the 4-dispatch round is ``core.staged.fw_staged(fused=False)``.
    "distributed" runs ``core.distributed.fw_distributed`` on the
    ``mesh=`` process grid (``launch.mesh.GridMesh``): every rank calls
    ``solve`` with the same w, the solve pads through
    ``plan.distributed_plan``, and every rank gets the full result
    (distance only), in every storage below.  "numpy" is the host's
    textbook loop, min-plus only, in the input's float dtype (f32, bf16,
    f16; int16 and packed words are refused, as the reference refuses
    them).
  * **device** — entry points run on the card (``device="cuda"``), where
    the fused round is the Hopper kernels; ``device="cpu"`` runs the plain
    versions.  Without a card, asking for "cuda" raises.
  * **batching** — a (B, n, n) input runs all B graphs through each launch.
  * **storage** — the input's float dtype is kept (f32, bf16, f16; f64
    narrows to f32); integers widen to f32 for the semirings with an
    infinite identity, as the reference promotes them, and keep their
    dtype for or_and and plus_mul (int64 narrows to int32), computed on an
    int32 carrier (``core.semiring.to_carrier``) and converted back;
    ``dtype=`` casts, and ``dtype=int16`` runs the saturating int16
    lowering; ``packed=True`` packs 32 {0,1} graphs per int32 word and runs
    one bitwise or_and closure over them (``pack_reachability``).
  * **successors** — next-hop tables (min-plus, any float dtype) via the
    fused successor round or the naive/blocked loops.
  * **validation** — min-plus solves (and their lowerings) raise
    ``NegativeCycleError`` when a diagonal entry is negative.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.apsp import plan
from repro_torch.apsp.kleene import fw_kleene
from repro_torch.core.distributed import fw_distributed, gather
from repro_torch.core.floyd_warshall import fw_blocked, fw_naive, fw_numpy
from repro_torch.core.paths import fw_blocked_with_successors, fw_with_successors
from repro_torch.core.semiring import (
    I16_INF,
    I16_NINF,
    MIN_PLUS,
    PACK_LANES,
    Semiring,
    dtype_name,
    from_carrier,
    int_carrier,
    int_storage,
    lower_semiring,
    resolve_semiring,
    to_carrier,
)
from repro_torch.core.staged import fw_staged, fw_staged_with_successors
from repro_torch.kernels.minplus_matmul import check_variant
from repro_torch.utils.interop import host_tensor

METHODS = (
    "auto", "numpy", "naive", "blocked", "staged", "fused", "recursive",
    "distributed",
)
SUCCESSOR_METHODS = ("naive", "blocked", "staged", "fused")

# 64-bit integers arrive in the reference as JAX's 32-bit ones (no x64).
_NARROW = {torch.int64: torch.int32, torch.uint64: torch.uint32}

# Below this size a padded tile pass does more work than the n sweeps of the
# naive loop; "auto" stays on the naive rung.
_NAIVE_CUTOFF = 64


class NegativeCycleError(ValueError):
    """The distance matrix certifies a negative cycle (diag < 0)."""


@dataclasses.dataclass(frozen=True)
class APSPResult:
    """Outcome of ``solve``.

    dist: (n, n) or (B, n, n) closure, unpadded, on the solve's device (on
          the host for an out-of-core recursive solve: the matrix does not
          fit the card's budget).
    succ: int32 next-hop table of the same shape (None unless
          successors=True); succ[i, j] = -1 where no i→j path exists.
    """

    dist: torch.Tensor
    succ: torch.Tensor | None
    method: str
    semiring: str
    block_size: int | None
    n: int
    padded_n: int

    @property
    def batched(self) -> bool:
        return self.dist.ndim == 3


def _is_min_plus(sr: Semiring) -> bool:
    """min_plus or one of its storage lowerings (negative-cycle semantics)."""
    return sr is MIN_PLUS or sr.name.startswith("min_plus")


def _as_tensor(w) -> torch.Tensor:
    """A tensor as it is; a numpy array or nested list as a CPU tensor of
    the same dtype and bits (ml_dtypes bfloat16 included)."""
    return w if isinstance(w, torch.Tensor) else host_tensor(w)


def pack_reachability(w) -> torch.Tensor:
    """Pack (B, n, n) or (n, n) boolean graphs into int32 bit planes.

    Graph g lands in word g // 32, bit g % 32 (LSB-first): ``(out[g // 32]
    >> (g % 32)) & 1`` is "edge i→j in graph g"; any nonzero entry is an
    edge.  B is padded to a multiple of 32 with empty graphs: the output is
    (ceil(B/32), n, n) int32 on w's device.
    """
    t = _as_tensor(w)
    if t.ndim == 2:
        t = t[None]
    if t.ndim != 3 or t.shape[-1] != t.shape[-2]:
        raise ValueError(f"w must be (n,n) or (B,n,n), got {tuple(t.shape)}")
    B, n, _ = t.shape
    words = torch.zeros((-(-B // PACK_LANES), n, n), dtype=torch.int32, device=t.device)
    for g in range(B):
        bit = g % PACK_LANES
        words[g // PACK_LANES] |= (t[g] != 0).to(torch.int32) * (
            (1 << bit) if bit < 31 else -(1 << 31))
    return words


def unpack_reachability(p, count: int | None = None, *, dtype=torch.float32) -> torch.Tensor:
    """Inverse of ``pack_reachability``: (G, n, n) int32 words → (count, n,
    n) 0/1 matrices of ``dtype`` (count defaults to all G·32 lanes)."""
    t = _as_tensor(p)
    if t.ndim == 2:
        t = t[None]
    if t.ndim != 3 or t.shape[-1] != t.shape[-2]:
        raise ValueError(f"p must be (n,n) or (G,n,n), got {tuple(t.shape)}")
    G, n, _ = t.shape
    count = G * PACK_LANES if count is None else count
    out = torch.empty((count, n, n), dtype=dtype, device=t.device)
    for g in range(count):
        out[g] = (t[g // PACK_LANES] >> (g % PACK_LANES)) & 1
    return out


def negative_cycle_mask(dist: torch.Tensor) -> torch.Tensor:
    """Per-graph bool: does the (…, n, n) closure certify a negative cycle?"""
    return torch.any(torch.diagonal(dist, dim1=-2, dim2=-1) < 0, dim=-1)


def _resolve_device(device) -> torch.device:
    try:
        dev = torch.device(device)
    except RuntimeError:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}") from None
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "versions on the host"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


def _resolve_method(method: str, n: int) -> str:
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; have {METHODS}")
    if method != "auto":
        return method
    return "naive" if n <= _NAIVE_CUTOFF else "fused"


def _resolve_shape(
    method: str, n: int, block_size: int | None, mesh=None, *,
    successors: bool = False, hbm_budget: int | None = None, batch: int = 1,
    word: int = 4,
) -> tuple[str, int | None, int]:
    """(method, block_size, n_padded) — the dispatch-and-padding policy.
    "distributed" pads to the mesh multiple through
    ``plan.distributed_plan``.  ``hbm_budget`` (device bytes) promotes an
    in-core tiled method to "recursive" when the padded matrix (batch ·
    m² · word bytes) does not fit it, never a successor solve
    (``repro/apsp/api.py:203-213``); recursive pads as fused does, so the
    promotion changes the schedule, never the padded shape."""
    meth = _resolve_method(method, n)
    if meth == "distributed":
        if mesh is None:
            raise ValueError("method='distributed' requires a mesh")
        dp = plan.distributed_plan(n, mesh.R * mesh.C, grid=(mesh.R, mesh.C),
                                   block_size=block_size)
        return meth, dp["block_size"], dp["n_padded"]
    if meth in ("blocked", "staged", "fused", "recursive"):
        s = block_size or plan.auto_block_size(n)
        m = plan.padded_size(n, s)
        if (meth != "recursive" and not successors and hbm_budget is not None
                and batch * m * m * word > hbm_budget):
            meth = "recursive"
        return meth, s, m
    return meth, None, n


def _budget_word(given: torch.dtype, store: torch.dtype, semiring: Semiring, dtype) -> int:
    """The element size the reference's promotion counts: its coerced
    array's (``repro/apsp/api.py:420-428``).  That is the storage's,
    except that a 64-bit input which no ``dtype=`` casts and which keeps
    its kind (float64, or int64 / uint64 of or_and / plus_mul) stays 64-bit
    in numpy there until the solve converts it; the port narrows it up
    front."""
    if (dtype is None and not semiring.packed and semiring.dtype != "int16"
            and given.itemsize == 8 and given.is_floating_point == store.is_floating_point):
        return 8
    return store.itemsize


def _torch_dtype(dtype) -> torch.dtype:
    """A dtype of any spelling → the torch dtype the port stores it in
    (float64 narrows to float32, as the reference's does without x64)."""
    name = dtype_name(dtype)
    if name == "float64":
        return torch.float32
    try:
        return getattr(torch, name)
    except AttributeError:
        raise ValueError(f"unknown dtype {dtype!r}") from None


def _coerce(w, semiring: Semiring, dtype, device) -> torch.Tensor:
    """Any (n,n) / (B,n,n) array or tensor → a contiguous tensor on device in
    the solve's storage dtype (``repro/apsp/api.py:217-258``).

    * packed or_and: int32 bit-plane words; uint32 is a bit view, never a
      value cast (bit 31 is graph 31).
    * int16 lowerings: weights clipped into [I16_NINF, I16_INF] first, so
      ±inf lands on the sentinels and nothing wraps.
    * an explicit float ``dtype``: a plain cast.
    * otherwise float inputs keep their dtype (float64 narrows to
      float32); integers (and bool) keep theirs for the semirings whose
      identities are finite (or_and, plus_mul; int64 narrows to int32 and
      uint64 to uint32, as ``jnp.asarray`` does) and become float32 for
      the others, which need ±inf.
    """
    t = _as_tensor(w)
    if t.ndim not in (2, 3) or t.shape[-1] != t.shape[-2]:
        raise ValueError(f"w must be (n,n) or (B,n,n), got {tuple(t.shape)}")
    t = t.to(device)
    if semiring.packed:
        if t.is_floating_point() or t.dtype == torch.bool:
            raise ValueError(
                f"semiring {semiring.name!r} takes int32 bit-plane words, got "
                f"{t.dtype}; pack boolean graphs with pack_reachability() or "
                f"call solve(..., packed=True)"
            )
        if t.dtype == torch.uint32:
            t = t.view(torch.int32)
        return t.to(torch.int32).contiguous()
    if semiring.dtype == "int16":
        if t.is_floating_point() and t.element_size() < 4:
            t = t.float()  # 32767 is not a bf16: clip where it is exact
        return t.clamp(I16_NINF, I16_INF).to(torch.int16).contiguous()
    if dtype is not None:
        return t.to(_torch_dtype(dtype)).contiguous()
    if t.is_floating_point():
        return (t.to(torch.float32) if t.dtype == torch.float64 else t).contiguous()
    if not (math.isfinite(semiring.zero) and math.isfinite(semiring.one)):
        return t.to(torch.float32).contiguous()
    return t.to(_NARROW.get(t.dtype, t.dtype)).contiguous()


def _pad(w: torch.Tensor, m: int, semiring: Semiring) -> torch.Tensor:
    """Pad (…, n, n) to (…, m, m) with ⊕-identity edges, ⊗-identity diag."""
    n = w.shape[-1]
    if m == n:
        return w
    out = w.new_full(w.shape[:-2] + (m, m), semiring.zero)
    out[..., :n, :n] = w
    idx = torch.arange(n, m, device=w.device)
    out[..., idx, idx] = semiring.one
    return out


def _solver(
    meth: str, *, semiring: Semiring, block_size: int | None, bk: int = 32,
    variant: str = "fori", successors: bool = False, mesh=None,
):
    """The solve a resolved method runs on a padded (…, m, m) tensor:
    ``run(wp)`` → dist, or (dist, succ) with successors.  Shared by
    ``solve`` and the engine's cached plans, so the two cannot drift."""
    sr, s = semiring, block_size
    if meth == "distributed":
        def run(wp):
            local = fw_distributed(wp, mesh, block_size=s, bk=bk, variant=variant,
                                   semiring=sr)
            return gather(local, mesh)

        return run
    if meth == "numpy":
        def run(wp):
            if wp.dtype == torch.bfloat16:  # numpy has no bf16: the same loop in torch
                return _fw_host_torch(wp.cpu()).to(wp.device)
            host = wp.cpu().numpy()
            out = np.stack([fw_numpy(g) for g in host]) if wp.ndim == 3 else fw_numpy(host)
            return torch.from_numpy(out).to(wp.device)

        return run
    if meth == "naive":
        if successors:
            return fw_with_successors
        return lambda wp: fw_naive(wp, semiring=sr)
    if meth == "blocked":
        if successors:
            return lambda wp: fw_blocked_with_successors(wp, block_size=s)
        return lambda wp: fw_blocked(wp, block_size=s, semiring=sr)
    if successors:
        return lambda wp: fw_staged_with_successors(wp, block_size=s)
    return lambda wp: fw_staged(wp, block_size=s, bk=bk, variant=variant, semiring=sr)


def _fw_host_torch(w: torch.Tensor) -> torch.Tensor:
    """``fw_numpy``'s loop on a host tensor in a dtype numpy lacks (bf16):
    ``np.minimum(w, w[:, k] + w[k, :])`` as ml_dtypes computes it on
    bfloat16 — the sum rounded to the storage, the minimum NaN-propagating
    and, between equal operands (+0 and -0), the second one."""
    for k in range(w.shape[-1]):
        cand = w[..., :, k, None] + w[..., k, None, :]
        w = torch.where((w < cand) | torch.isnan(w), w, cand)
    return w


def _check_negative_cycles(dist: torch.Tensor, batched: bool) -> None:
    bad = negative_cycle_mask(dist).cpu().numpy()
    if bad.any():
        which = f"graphs {np.flatnonzero(bad).tolist()}" if batched else "graph"
        raise NegativeCycleError(f"negative cycle detected in {which}")


def _check_mesh_device(mesh, dev: torch.device) -> None:
    if mesh is not None and mesh.device.type != dev.type:
        raise ValueError(f"the mesh's ranks run on {mesh.device}, the solve on {dev}: "
                         f"pass device={mesh.device.type!r}")


def _check_successor_args(meth: str, semiring: Semiring) -> None:
    if semiring is not MIN_PLUS:
        raise ValueError("successors=True requires the min_plus semiring")
    if meth not in SUCCESSOR_METHODS:
        raise ValueError(
            f"successors=True supports methods {SUCCESSOR_METHODS}, not {meth!r}"
        )


def solve(
    w,
    *,
    method: str = "auto",
    semiring: Semiring | str = MIN_PLUS,
    dtype=None,
    packed: bool = False,
    successors: bool = False,
    block_size: int | None = None,
    validate: bool = True,
    mesh=None,
    variant: str = "fori",
    leaf: int | None = None,
    hbm_budget: int | None = None,
    devices=None,
    device="cuda",
) -> APSPResult:
    """All-pairs shortest paths (semiring closure) of one or many graphs.

    w: (n, n) or (B, n, n) adjacency matrix — numpy array (ml_dtypes
       bfloat16 too), nested list or tensor; missing edges are the
       semiring's ⊕-identity (+inf for min-plus).  Any n (padded, then
       unpadded); f32, bf16 and f16 inputs are solved in their own dtype.
    method: "auto" | "numpy" | "naive" | "blocked" | "staged" | "fused" |
       "recursive" (the R-Kleene panel schedule, ``apsp.kleene``; bitwise
       equal to "fused" at the same block size) | "distributed" (needs
       ``mesh``; every rank of the grid calls ``solve`` with the same w and
       gets the full result).
    semiring: a ``Semiring`` or its name ("min_plus", "max_plus", "max_min",
       "or_and", "plus_mul", or a lowering's: "min_plus_i16", …,
       "or_and_packed" for pre-packed int32 words).
    dtype: the storage dtype (None keeps the input's float dtype).  A float
       dtype is a plain cast; int16 runs the saturating lowering (weights
       clip into [-32768, 32767], +inf ↦ 32767); plus_mul has none.
    packed: bit-packed transitive closure (or_and only): the (B, n, n) or
       (n, n) {0,1} graphs (any dtype, nonzero = edge) are packed 32 to an
       int32 word, closed once with bitwise OR / AND, and unpacked to the
       input's shape and dtype.
    successors: also return the int32 next-hop table (min-plus, any float
       dtype).
    block_size: pivot-tile size for blocked/staged/fused (None = auto; the
       fused round takes 16, 32, 64 or 128).
    validate: raise ``NegativeCycleError`` on a negative diagonal
       (min-plus and its lowerings; reads the diagonal back to the host).
    variant: "fori" or "unroll" (the same k-ascending chain).
    mesh: the ``launch.mesh.GridMesh`` of method="distributed" (ignored by
       the other methods); its device type must be ``device``'s.
    device: "cuda" (default: the Hopper kernels) or "cpu" (plain versions).
    leaf: pivot-panel width of method="recursive" (a multiple of the block
       size; None = ``plan.recursive_plan``'s pick: the fattest power of
       two whose streaming residency fits the budget when out of core,
       4·block_size in core).
    hbm_budget: device-memory budget in bytes.  When the padded matrix
       (batch · m² · word, the word of the input's storage as the
       reference counts it) exceeds it, an in-core tiled method ("auto"
       too) becomes "recursive", and the plan keeps the matrix in pinned
       host memory (``apsp.kleene.HostPanelStore``) with only the pivot
       cross, its factors and three tiles on the card; ``dist`` then comes
       back on the host.  Integer or_and / plus_mul storages are counted in
       their own word, though the card holds their int32 carrier.  Never
       promotes a successor solve, nor a packed one (the reference does
       not pass it to the inner solve; ``method="recursive"`` does run
       packed words).
    devices: cards the recursive sweep's tiles go round-robin over
       (``KleeneExecutor``); default the solve's device.
    """
    sr = resolve_semiring(semiring)
    if packed:
        # Pack → one closure over int32 bit planes → unpack: each bit lane
        # is an independent graph, so the planes equal B unpacked solves.
        if successors:
            raise ValueError("successors=True requires min_plus; packed=True is the "
                             "or_and transitive-closure lowering")
        sr = lower_semiring(sr, dtype, packed=True)
        arr = _as_tensor(w)
        count = arr.shape[0] if arr.ndim == 3 else 1
        words = pack_reachability(arr.to(_resolve_device(device)))
        inner = solve(words[0] if words.shape[0] == 1 else words, method=method,
                      semiring=sr, block_size=block_size, validate=False, mesh=mesh,
                      variant=variant, device=device)
        dist = unpack_reachability(inner.dist, count, dtype=arr.dtype)
        return dataclasses.replace(inner, dist=dist if arr.ndim == 3 else dist[0],
                                   n=arr.shape[-1])
    sr = lower_semiring(sr, dtype)
    check_variant(variant)
    dev = _resolve_device(device)
    # Under a budget the input waits on the host until the plan says
    # whether the matrix goes to the card at all.
    arr = _coerce(w, sr, dtype, torch.device("cpu") if hbm_budget is not None else dev)
    store, run_sr = arr.dtype, sr
    if int_storage(store, sr):
        arr, run_sr = to_carrier(arr, sr), int_carrier(sr, store)
    batched = arr.ndim == 3
    n, B = arr.shape[-1], arr.shape[0] if arr.ndim == 3 else 1
    given = _as_tensor(w).dtype
    meth, s, m = _resolve_shape(method, n, block_size, mesh, successors=successors,
                                hbm_budget=hbm_budget, batch=B,
                                word=_budget_word(given, store, sr, dtype))
    if meth == "distributed":
        _check_mesh_device(mesh, dev)
    if successors:
        _check_successor_args(meth, sr)
    if meth == "numpy" and sr is not MIN_PLUS:
        raise ValueError("method='numpy' implements min_plus only")

    if meth == "recursive":
        # The plan picks the leaf and whether the matrix stays on the host
        # (out of core) or on the card; either way the closure is bitwise
        # the fused solve's at the same block size.
        rp = plan.recursive_plan(n, leaf=leaf, hbm_budget=hbm_budget, block_size=s,
                                 batch=B, dtype=store, variant=variant)
        wp = _pad(arr if rp["out_of_core"] else arr.to(dev), m, run_sr)
        out = fw_kleene(wp, semiring=run_sr, block_size=s, leaf=rp["leaf"], variant=variant,
                        out_of_core=rp["out_of_core"], devices=devices, device=dev)
    else:
        run = _solver(meth, semiring=run_sr, block_size=s, variant=variant,
                      successors=successors, mesh=mesh)
        out = run(_pad(arr.to(dev), m, run_sr))
    dist, succ = out if successors else (out, None)
    dist = dist[..., :n, :n]
    if int_storage(store, sr):
        dist = from_carrier(dist, store, sr)
    if succ is not None:
        succ = succ[..., :n, :n]

    if validate and _is_min_plus(sr):
        _check_negative_cycles(dist, batched)
    return APSPResult(
        dist=dist, succ=succ, method=meth, semiring=sr.name,
        block_size=s, n=n, padded_n=m,
    )
