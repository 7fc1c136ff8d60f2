"""Batched APSP execution engine: plan cache, ragged bucketing, repair.

Counterpart of ``repro.apsp.engine`` on one device.  Serving
workloads solve the same (n, B) shapes over and over, in ragged batches,
and absorb link improvements without a full re-solve.  ``ApspEngine`` is
the session object for that:

  * **plan cache** — each distinct ``PlanKey`` (padded n, batch, dtype,
    semiring, method, block dims, successors, edge bucket, device type) is
    planned once: block size resolved, shared-memory and device-memory
    traffic modelled, and its runner built.  ``ExecutablePlan.traces``
    counts runner builds, so a warm key stays at 1.  The runner is the
    same per-method solve ``api.solve`` runs (``api._solver``); capturing
    a key's launches in a CUDA graph is open work (ROADMAP A.5).
  * **storage** — ``dtype=`` / ``packed=`` pin a storage lowering at
    construction, as the reference's do: ``dtype=torch.int16`` runs the
    saturating int16 lowerings, bf16 / f16 cast the weights, and
    ``packed=True`` (or_and) serves int32 word planes of 32 graphs (inputs
    pre-packed with ``api.pack_reachability``; ``repair`` and
    ``repair_del`` take one (1, n, n) plane, w a lane mask).  Unpinned, a
    float input keeps its dtype and an integer or_and / plus_mul input its
    integer storage (``api._coerce``), computed on an int32 carrier.  Plan
    keys carry the storage dtype, and every path — solve, ``solve_many``,
    ``repair`` (successors in bf16 / f16), ``repair_del`` — runs the
    storage's own kernels.
  * **``solve_many``** — buckets a ragged list of graphs by (method,
    padded n, block size, dtype), pads each bucket into one (B, m, m)
    batch and runs it through the kernels' batch grid (one launch set per
    round for the whole bucket).  Results come back in input order,
    bitwise equal to per-graph ``solve``.
  * **``repair``** — absorbs a batch of ⊕-improving edge updates into a
    closed matrix through the rank-1 repair kernels (``kernels.fw_repair``),
    edge batches padded to power-of-two buckets with no-op edges so that
    one plan serves every batch length up to its bucket.
  * **``repair_del``** — absorbs edge deletions and worsenings: marks the
    affected pairs (torch ops), then re-relaxes only the affected rows
    through the restricted-sweep kernels (``kernels.fw_repair_del``), or
    re-solves when ``plan.should_repair_del`` says that is cheaper.
  * **recursive** — method "recursive", or any in-core tiled method
    promoted by ``hbm_budget=`` when a padded graph does not fit it
    (decided at batch 1, as the reference decides, so that bucketing stays
    a function of n): the R-Kleene schedule of ``apsp.kleene``.  Its plan
    keys carry the leaf and ``oocore`` from one ``plan.recursive_plan``
    call; each entry keeps one ``KleeneExecutor`` (``entry.executor``:
    depth, leaf / sweep counts) and gives every solve a fresh panel store,
    pinned host memory when the plan is out of core (the result then comes
    back on the host).
  * **mesh** — ``ApspEngine(method="distributed", mesh=grid)`` runs every
    solve through the distributed solve on the ``launch.mesh.GridMesh``
    (plan keys carry the grid's signature; every rank of the grid makes
    the same calls); ``repair`` runs the distributed rank-1 repair
    (``core.distributed.build_repair_shard_fn``, key method
    "repair_distributed"), ``repair_del`` the same local mark and sweep as
    one device (its re-solve fallback is distributed), in every storage
    (the bordered round's lowerings; the repair's broadcasts move the
    storage's bytes).  Distance only: successor requests raise, as in the
    reference.

Method "staged" runs the fused round, as the reference's engine does, in
every storage.  The reference's TPU-lowering knobs ``backend=``, ``interpret=`` and ``vmem_budget=`` have
no counterpart: the port has one lowering per device, chosen by
``device=``, and the batch of a bucket rides one launch
(``PlanKey.batch_block`` is the batch).

The engine holds no device buffers between calls.  Thread-safety is the
caller's concern.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.apsp import plan
from repro_torch.apsp.kleene import DevicePanelStore, HostPanelStore, KleeneExecutor
from repro_torch.apsp.api import (
    METHODS,
    APSPResult,
    NegativeCycleError,
    _check_mesh_device,
    _check_negative_cycles,
    _check_successor_args,
    _coerce,
    _is_min_plus,
    _pad,
    _resolve_device,
    _resolve_shape,
    _solver,
)
from repro_torch.core.semiring import (
    MIN_PLUS,
    Semiring,
    dtype_name,
    from_carrier,
    int_carrier,
    int_storage,
    lower_semiring,
    resolve_semiring,
    to_carrier,
)
from repro_torch.core import distributed as _dist
from repro_torch.kernels import fw_repair as _fr
from repro_torch.kernels import fw_repair_del as _frd
from repro_torch.kernels.minplus_matmul import check_variant


@dataclasses.dataclass(frozen=True)
class PlanKey:
    """The plan-cache key: everything that changes what a runner launches.

    The reference's fields, kept: ``mesh`` is the grid's signature on
    distributed keys; ``leaf`` (the pivot-panel width) and ``oocore`` (a
    host-resident panel store) are set on recursive keys.  ``backend`` is
    the device type the runner launches on, "cuda" or "cpu".
    """

    n_padded: int
    batch: int
    dtype: str
    semiring: str
    method: str
    block_size: int | None
    bk: int
    batch_block: int | None
    successors: bool
    mesh: tuple | None = None
    edges: int = 0  # repair entries: the padded edge-batch bucket E (the
    #                 row bucket a_pad for "repair_del" sweep entries)
    leaf: int | None = None  # recursive entries: pivot-panel width
    oocore: bool = False     # recursive entries: host-resident panel store
    backend: str = "cuda"


@dataclasses.dataclass
class ExecutablePlan:
    """A planned batched solve (or repair) and its runner.

    runner: padded (batch, m, m) → padded dist, or (dist, succ).
    traces: how many times the runner was built — 1 for every cached entry.
    smem_bytes: the largest shared-memory footprint of one block of the
            round's launches (``plan.round_smem_bytes``; the reference's
            ``vmem_bytes``); None for methods without a kernel.
    hbm_bytes_per_round: the device-memory traffic model of one fused round
            at this key (one repair dispatch for repair entries; a recursive
            solve's modelled device traffic over its rounds).
    executor: the ``KleeneExecutor`` of a recursive entry (depth, leaf and
            sweep counts), else None.
    """

    key: PlanKey
    runner: Callable[..., Any]
    smem_bytes: int | None = None
    hbm_bytes_per_round: float | None = None
    traces: int = 0
    executor: Any = None


@dataclasses.dataclass
class EngineStats:
    hits: int = 0
    misses: int = 0
    solves: int = 0
    graphs_solved: int = 0
    repairs: int = 0         # rank-1 repair dispatches (ApspEngine.repair)
    edges_repaired: int = 0  # real (unpadded) edge updates absorbed by them
    repair_rejects: int = 0  # should_repair fast-rejects (edge worsenings)
    repair_dels: int = 0           # decremental sweeps (ApspEngine.repair_del)
    repair_del_rows: int = 0       # affected rows those sweeps re-relaxed
    repair_del_noops: int = 0      # empty affected set — no sweep launched
    repair_del_fallbacks: int = 0  # marked, then re-solved (cost/semiring)
    edges_deleted: int = 0         # real deletions absorbed (sweeps + noops)


class ApspEngine:
    """Session object owning the plan cache for repeated solves.

        eng = ApspEngine()
        res = eng.solve(w)                    # same surface as apsp.solve
        results = eng.solve_many(graphs)      # ragged batch, auto-bucketed
        tables = eng.solve_many(graphs, successors=True)   # routing tables
        fixed = eng.repair(res.dist, [(u, v, w_new)])      # link improvements
        fixed = eng.repair_del(res.dist, w1, [(u, v, w_old)])  # link failures

    Construction pins the solve configuration (method, semiring, block
    dims, device); per-call shape and batch variation is absorbed by the
    cache.
    """

    def __init__(
        self,
        *,
        method: str = "auto",
        semiring: Semiring | str = MIN_PLUS,
        dtype=None,
        packed: bool = False,
        block_size: int | None = None,
        bk: int = 32,
        variant: str = "fori",
        validate: bool = True,
        mesh=None,
        leaf: int | None = None,
        hbm_budget: int | None = None,
        devices=None,
        device="cuda",
    ):
        """method / semiring / block dims pin the solve configuration, and
        dtype / packed its storage lowering (``lower_semiring``).

        mesh: the ``launch.mesh.GridMesh`` of method="distributed" (its
        device type must be ``device``'s).  device: "cuda" (default: the
        Hopper kernels) or "cpu" (the plain versions); without a card,
        "cuda" raises.  leaf / hbm_budget / devices configure method
        "recursive" as ``api.solve``'s do; ``hbm_budget`` also promotes the
        in-core tiled methods to it when a padded graph (in the word of
        ``dtype``, 4 bytes when unpinned) does not fit.
        """
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r}; have {METHODS}")
        if method == "distributed" and mesh is None:
            raise ValueError("ApspEngine(method='distributed') requires a mesh= "
                             "(a launch.mesh.GridMesh)")
        check_variant(variant)
        self.method = method
        self.semiring = lower_semiring(resolve_semiring(semiring), dtype, packed=packed)
        self.dtype = dtype
        self.block_size = block_size
        self.bk = bk
        self.variant = variant
        self.validate = validate
        self.device = _resolve_device(device)
        self.mesh = mesh
        if method == "distributed":
            _check_mesh_device(mesh, self.device)
        self.leaf = leaf
        self.hbm_budget = hbm_budget
        self.devices = devices
        # Under a budget inputs are coerced on the host, and go to the card
        # only when their plan is not out of core.
        self._staging = torch.device("cpu") if hbm_budget is not None else self.device
        self.stats = EngineStats()
        self._cache: dict[PlanKey, ExecutablePlan] = {}

    # ------------------------------------------------------------- planning
    def clear_cache(self) -> None:
        self._cache.clear()

    @property
    def cache_size(self) -> int:
        return len(self._cache)

    def _lookup(self, key: PlanKey, build: Callable[[PlanKey], ExecutablePlan]):
        entry = self._cache.get(key)
        if entry is not None:
            self.stats.hits += 1
            return entry
        self.stats.misses += 1
        entry = self._cache[key] = build(key)
        entry.traces += 1
        return entry

    def _resolve_shape(self, n: int, successors: bool) -> tuple[str, int | None, int]:
        """(method, block_size, n_padded) through ``api._resolve_shape``,
        the budget's promotion evaluated at batch 1 in the word of the
        pinned dtype (4 when none is pinned), as the reference does."""
        return _resolve_shape(self.method, n, self.block_size, self.mesh,
                              successors=successors, hbm_budget=self.hbm_budget,
                              word=plan.word_for(self.dtype))

    def plan_for(
        self, n: int, batch: int = 1, *, dtype=torch.float32,
        successors: bool = False,
    ) -> ExecutablePlan:
        """Resolve (and cache) the plan for an (n, batch) solve in the
        storage ``dtype``."""
        meth, s, m = self._resolve_shape(n, successors)
        dt = dtype_name(dtype)
        if successors:
            _check_successor_args(meth, self.semiring)
        if meth == "numpy" and self.semiring is not MIN_PLUS:
            raise ValueError("method='numpy' implements min_plus only")
        bk = min(self.bk, s) if s is not None else self.bk
        rec = None
        if meth == "recursive":
            # Planned once here; the key's (leaf, oocore) and the runner's
            # schedule come from this one dict.
            rec = plan.recursive_plan(n, leaf=self.leaf, hbm_budget=self.hbm_budget,
                                      block_size=s, batch=batch, dtype=dt, bk=bk,
                                      variant=self.variant)
        key = PlanKey(
            n_padded=m, batch=batch, dtype=dt, semiring=self.semiring.name,
            method=meth, block_size=s, bk=bk,
            batch_block=batch if meth in ("staged", "fused", "distributed") else None,
            successors=successors,
            mesh=self.mesh.signature if meth == "distributed" else None,
            leaf=rec["leaf"] if rec else None,
            oocore=rec["out_of_core"] if rec else False,
            backend=self.device.type,
        )
        if rec:
            return self._lookup(key, functools.partial(self._build_recursive, rec=rec))
        return self._lookup(key, self._build)

    def _build_recursive(self, key: PlanKey, rec: dict) -> ExecutablePlan:
        """One ``KleeneExecutor`` for the key, and a runner that gives each
        solve a fresh panel store: pinned host memory when the key is out
        of core (the result then stays on the host), else the card."""
        ex = KleeneExecutor(semiring=self._run_semiring(key.dtype), block_size=key.block_size,
                            leaf=key.leaf, bk=key.bk, variant=self.variant,
                            devices=self.devices)

        def runner(wp):
            store = HostPanelStore(wp, device=self.device) if key.oocore else DevicePanelStore(wp)
            ex.run(store)
            return store.result()

        return ExecutablePlan(key=key, runner=runner, executor=ex,
                              hbm_bytes_per_round=rec["hbm_bytes_total"] / rec["rounds"])

    def _build(self, key: PlanKey) -> ExecutablePlan:
        """The batched runner of a solve key, and its models."""
        entry = ExecutablePlan(key=key, runner=_solver(
            key.method, semiring=self._run_semiring(key.dtype), block_size=key.block_size,
            bk=key.bk, variant=self.variant, successors=key.successors, mesh=self.mesh,
        ))
        word = plan.word_for(key.dtype)
        if key.method == "distributed":
            entry.smem_bytes = plan.round_smem_bytes(key.block_size, key.bk, word=word)
        elif key.method in ("staged", "fused"):
            entry.smem_bytes = plan.round_smem_bytes(
                key.block_size, key.bk, successors=key.successors, word=word,
            )
            entry.hbm_bytes_per_round = (2 if key.successors else 1) * (
                plan.fused_round_hbm_bytes(key.n_padded, key.block_size, word=word,
                                           batch=key.batch)
            )
        return entry

    # -------------------------------------------------------------- solving
    def solve(self, w, *, successors: bool = False) -> APSPResult:
        """One graph or one uniform (B, n, n) batch through the cache."""
        arr = _coerce(w, self.semiring, self.dtype, self._staging)
        batched = arr.ndim == 3
        n = arr.shape[-1]
        B = arr.shape[0] if batched else 1
        entry = self.plan_for(n, B, dtype=arr.dtype, successors=successors)
        dist, succ = self._run(entry, [arr] if not batched else list(arr), n)
        if not batched:
            dist = dist[0]
            succ = succ[0] if succ is not None else None
        if self.validate and _is_min_plus(self.semiring):
            _check_negative_cycles(dist, batched)
        self.stats.solves += 1
        self.stats.graphs_solved += B
        return self._result(entry, dist, succ, n)

    def solve_many(self, graphs: Sequence, *, successors: bool = False) -> list[APSPResult]:
        """Ragged batch: bucket by padded shape, solve each bucket batched.

        graphs: sequence of (n_i, n_i) matrices (sizes may differ) or one
        (B, n, n) array or tensor.  Returns per-graph results in input
        order, bitwise equal to per-graph ``solve`` calls.
        """
        arrs = [_coerce(g, self.semiring, self.dtype, self._staging) for g in graphs]
        for a in arrs:
            if a.ndim != 2:
                raise ValueError(f"solve_many expects (n,n) graphs, got {tuple(a.shape)}")
        buckets: dict[tuple, list[int]] = {}
        for idx, a in enumerate(arrs):
            meth, s, m = self._resolve_shape(a.shape[-1], successors)
            buckets.setdefault((meth, m, s, str(a.dtype)), []).append(idx)
        results: list[APSPResult | None] = [None] * len(arrs)
        for (_meth, m, _s, _dt), idxs in buckets.items():
            entry = self.plan_for(arrs[idxs[0]].shape[-1], len(idxs),
                                  dtype=arrs[idxs[0]].dtype, successors=successors)
            dist, succ = self._run(entry, [arrs[i] for i in idxs], m)
            ns = [arrs[i].shape[-1] for i in idxs]
            if self.validate and _is_min_plus(self.semiring):
                bad = negative_cycle_mask_padded(dist, ns)
                if bad.any():
                    which = [idxs[k] for k in np.flatnonzero(bad)]
                    raise NegativeCycleError(f"negative cycle detected in graphs {which}")
            for k, (i, n_i) in enumerate(zip(idxs, ns)):
                s_i = succ[k, :n_i, :n_i] if succ is not None else None
                results[i] = self._result(entry, dist[k, :n_i, :n_i], s_i, n_i)
        self.stats.solves += len(buckets)
        self.stats.graphs_solved += len(arrs)
        return results  # type: ignore[return-value]

    # -------------------------------------------------------------- repair
    def repair(self, dist, updates, *, succ=None) -> APSPResult:
        """Absorb a batch of ⊕-improving edge updates into a closed matrix.

        dist: a (n, n) closure (a prior solve's output; for the packed
        lowering one (1, n, n) word plane, restored to that shape);
        updates: sequence of ``(u, v, w)`` where ``w`` is the ⊕-delta
        merged into edge (u, v) — the improved weight itself for the
        idempotent semirings, the additive delta for plus_mul, the int32
        mask of the lanes that gain the edge for packed; succ: the matching
        next-hop table to patch alongside (min-plus, float distances).
        Neither input is modified.

        One stage + apply launch pair per 64 edges, in every storage
        (``kernels.fw_repair``; its plain version on the CPU) —
        O(E·n²) against the full solve's O(n³).  The result equals a full
        re-solve of the updated graph under the kernel's conditions:
        ⊕-improving updates, closure diagonal = ⊗-identity (lifted and
        restored here, in the storage dtype, for plus_mul, whose FW
        convention keeps a 0 diagonal; exact there only on DAGs), no
        optimal path using one updated edge twice, and exact arithmetic
        (integer weights whose path sums the storage holds).  Edge removals
        and min-plus weight increases go to ``repair_del``
        (``should_repair`` is the cost policy).

        Edge batches pad to ``max(4, next power of two)`` with no-op edges
        (u = v = 0, w = ⊕-identity), so the plan cache holds one entry per
        (shape, bucket) rather than one per batch length.  Endpoints
        outside [0, n), or a weight the storage cannot hold, raise
        ``ValueError``.
        """
        sr = self.semiring
        arr = _coerce(dist, sr, self.dtype, self.device)
        packed_plane = sr.packed and arr.ndim == 3 and arr.shape[0] == 1
        if packed_plane:
            arr = arr[0]
        if arr.ndim != 2 or arr.shape[0] != arr.shape[1]:
            raise ValueError(f"repair expects a (n, n) closure, got {tuple(arr.shape)}")
        n = arr.shape[-1]
        updates = list(updates)
        if not updates:
            raise ValueError("repair needs at least one (u, v, w) update")
        self._check_succ(succ, arr, "repair")
        E = len(updates)
        E_pad = max(4, 1 << (E - 1).bit_length())
        u = np.zeros(E_pad, np.int32)
        v = np.zeros(E_pad, np.int32)
        for i, (ui, vi, _) in enumerate(updates):
            u[i], v[i] = ui, vi
        w = _edge_weights(E_pad, sr.zero, arr.dtype, [wi for _, _, wi in updates])
        if not ((0 <= u) & (u < n) & (0 <= v) & (v < n)).all():
            raise ValueError(f"edge endpoints must lie in [0, {n})")
        mesh = self.mesh.signature if self.method == "distributed" else None
        if mesh is None:
            s = self.block_size or plan.auto_block_size(n)
            m = plan.padded_size(n, s)
        else:
            _, s, m = _resolve_shape("distributed", n, self.block_size, self.mesh)
        key = PlanKey(
            n_padded=m, batch=1, dtype=dtype_name(arr.dtype), semiring=sr.name,
            method="repair" if mesh is None else "repair_distributed",
            block_size=s, bk=0, batch_block=None, successors=succ is not None,
            mesh=mesh, edges=E_pad, backend=self.device.type,
        )
        entry = self._lookup(key, self._build_repair)
        work, run_sr = self._carry(arr)
        dp = _pad(work, m, run_sr)
        wc = self._carry(w)[0]
        if succ is None:
            d2, s2 = entry.runner(dp, u, v, wc)[:n, :n], None
        else:
            sp = torch.full((m, m), -1, dtype=torch.int32, device=self.device)
            sp[:n, :n] = torch.as_tensor(succ).to(self.device, torch.int32)
            d2, s2 = entry.runner(dp, sp, u, v, wc)
            d2, s2 = d2[:n, :n], s2[:n, :n]
        d2 = self._back(d2, arr.dtype)
        if self.validate and _is_min_plus(sr):
            _check_negative_cycles(d2, False)
        self.stats.repairs += 1
        self.stats.edges_repaired += E
        return self._result(entry, d2[None] if packed_plane else d2, s2, n)

    def repair_del(
        self, dist, w, deletions, *, succ=None, threshold: float = 0.5,
    ) -> APSPResult:
        """Absorb a batch of edge deletions / worsenings into a closed matrix
        — the structural events the rank-1 ``repair`` cannot touch.

        dist: a (n, n) closure (a prior solve's output; packed: one
        (1, n, n) word plane, as ``repair``); w: the **updated** weight
        matrix (a deleted edge holds the ⊕-identity, a worsened one its new
        weight); deletions: sequence of ``(u, v, w_old)``, the endpoints
        and the weight the edge carried before (packed: the int32 mask of
        the lanes that held it); succ: the matching next-hop table to
        repair alongside (min-plus, float distances).  Neither input is
        modified.

        Two stages (``kernels.fw_repair_del``): mark the pairs whose closure
        value is witnessed through a deleted edge, d[i,u] ⊗ w_old ⊗ d[v,j]
        == d[i,j], and reset them to w (packed: per lane) — O(E·n²) torch
        ops; then re-relax only the a affected rows with the restricted
        row sweep, three launches per pivot round on the card.  The result
        equals a full re-solve of w, bitwise on integer-valued weights.
        Falls back to ``self.solve(w)`` — counted in
        ``stats.repair_del_fallbacks`` — when ``plan.should_repair_del(
        threshold=...)`` rejects the affected row count or the semiring is
        plus_mul in any storage (non-idempotent ⊕ sums over all paths; no
        restricted recomputation is sound).  An empty batch, or an empty
        affected set, returns the input closure and launches no sweep
        (``repair_del_noops``).  A non-finite old weight in an integer
        lowering stays the ⊕-identity (the edge never existed there).
        Endpoints outside [0, n) raise ``ValueError``.
        """
        sr = self.semiring
        arr = _coerce(dist, sr, self.dtype, self.device)
        wa = _coerce(w, sr, self.dtype, self.device)
        packed_plane = sr.packed and arr.ndim == 3 and arr.shape[0] == 1
        if packed_plane:
            arr, wa = arr[0], wa[0]
        if arr.ndim != 2 or arr.shape[0] != arr.shape[1]:
            raise ValueError(f"repair_del expects a (n, n) closure, got {tuple(arr.shape)}")
        if wa.shape != arr.shape:
            raise ValueError(
                f"weight matrix {tuple(wa.shape)} does not match closure {tuple(arr.shape)}"
            )
        n = arr.shape[-1]
        dels = [(int(u), int(v), wi) for (u, v, wi) in deletions]
        self._check_succ(succ, arr, "repair_del")
        s0 = None if succ is None else torch.as_tensor(succ).to(self.device, torch.int32)
        d0 = arr[None] if packed_plane else arr
        E = len(dels)
        if E == 0:
            self.stats.repair_del_noops += 1
            return APSPResult(dist=d0, succ=s0, method="repair_del", semiring=sr.name,
                              block_size=self.block_size, n=n, padded_n=n)
        if not all(0 <= u < n and 0 <= v < n for u, v, _ in dels):
            raise ValueError(f"edge endpoints must lie in [0, {n})")
        if "plus_mul" in sr.name:
            # Non-idempotent ⊕ sums over ALL paths: neither the one-witness
            # marking nor any restricted recomputation is sound.
            self.stats.edges_deleted += E
            self.stats.repair_del_fallbacks += 1
            return self.solve(w, successors=succ is not None)
        s = self.block_size or plan.auto_block_size(n)
        m = plan.padded_size(n, s)
        E_pad = max(4, 1 << (E - 1).bit_length())
        # Padding edges (u = v = 0, the ⊕-identity weight) are past the live
        # count, and the marking skips them.
        u = np.zeros(E_pad, np.int32)
        v = np.zeros(E_pad, np.int32)
        for i, (ui, vi, _) in enumerate(dels):
            u[i], v[i] = ui, vi
        wold = _edge_weights(E_pad, sr.zero, arr.dtype, [wi for _, _, wi in dels],
                             lenient=True)
        dt = dtype_name(arr.dtype)
        key1 = PlanKey(
            n_padded=m, batch=1, dtype=dt, semiring=sr.name,
            method="repair_del_mark", block_size=s, bk=0, batch_block=None,
            successors=succ is not None, edges=E_pad, backend=self.device.type,
        )
        entry1 = self._lookup(key1, self._build_repair_del_mark)
        work, run_sr = self._carry(arr)
        dp, wp = _pad(work, m, run_sr), _pad(self._carry(wa)[0], m, run_sr)
        wold = self._carry(wold)[0]
        if succ is None:
            d_init, row_mask, _ = entry1.runner(dp, wp, u, v, wold, E)
            s_init = None
        else:
            sp = torch.full((m, m), -1, dtype=torch.int32, device=self.device)
            sp[:n, :n] = s0
            d_init, s_init, row_mask, _ = entry1.runner(dp, sp, wp, u, v, wold, E)
        rows = np.flatnonzero(row_mask[:n].cpu().numpy())
        a = int(rows.size)
        self.stats.edges_deleted += E
        if a == 0:
            # No shortest path was witnessed through any deleted edge: the
            # closure (and succ) is already the updated graph's.
            self.stats.repair_del_noops += 1
            return APSPResult(dist=d0, succ=s0, method="repair_del", semiring=sr.name,
                              block_size=s, n=n, padded_n=m)
        if not plan.should_repair_del(
            n, a, block_size=s, word=arr.element_size(), edges=E,
            successors=succ is not None, threshold=threshold,
        ):
            self.stats.repair_del_fallbacks += 1
            return self.solve(w, successors=succ is not None)
        a_pad = min(max(8, 1 << (a - 1).bit_length()), m)
        rows_arr = np.full(a_pad, m, np.int32)
        rows_arr[:a] = rows
        key2 = PlanKey(
            n_padded=m, batch=1, dtype=dt, semiring=sr.name, method="repair_del",
            block_size=s, bk=min(self.bk, s), batch_block=None,
            successors=succ is not None, edges=a_pad, backend=self.device.type,
        )
        entry2 = self._lookup(key2, self._build_repair_del_sweep)
        if succ is None:
            d2, s2 = entry2.runner(d_init, rows_arr)[:n, :n], None
        else:
            d2, s2 = entry2.runner(d_init, s_init, rows_arr)
            d2, s2 = d2[:n, :n], s2[:n, :n]
        d2 = self._back(d2, arr.dtype)
        if self.validate and _is_min_plus(sr):
            _check_negative_cycles(d2, False)
        self.stats.repair_dels += 1
        self.stats.repair_del_rows += a
        return self._result(entry2, d2[None] if packed_plane else d2, s2, n)

    def should_repair(
        self, n: int, pending_updates: int, *, successors: bool = False,
        dtype=None, threshold: float = 0.5, worsenings: int = 0,
    ) -> bool:
        """The staleness/accumulated-delta policy: is a rank-1 repair still
        cheaper than a full fused re-solve for this backlog?

        ``worsenings > 0`` fast-rejects regardless of cost: the rank-1
        repair only absorbs ⊕-improvements, so a worsened edge (a min-plus
        weight increase, a removal, a failed link) needs a re-solve.
        Rejects are counted in ``stats.repair_rejects``.

        Otherwise compares ``plan.repair_hbm_bytes`` for the accumulated
        edge count against ``threshold ×`` the full solve's modelled
        traffic, in the storage's word.  Both are the reference's models of
        the TPU kernels, kept so that this decides exactly as
        ``repro.apsp.ApspEngine`` does; the CUDA kernels' own traffic
        differs (``kernels/csrc/fw_repair.cu``: ~2·n² words per repair
        against ~2·n² per round), which moves the crossover but not the
        order of magnitude.
        """
        if worsenings > 0:
            self.stats.repair_rejects += 1
            return False
        if pending_updates < 1:
            return False
        s = self.block_size or plan.auto_block_size(n)
        word = plan.word_for(dtype if dtype is not None else self.dtype)
        cost = plan.repair_hbm_bytes(
            n, s, word=word, edges=pending_updates, successors=successors
        )
        full = plan.fused_solve_hbm_bytes(n, s, word=word) * (2 if successors else 1)
        return cost <= threshold * full

    def _build_repair(self, key: PlanKey) -> ExecutablePlan:
        """The repair runner of a cache key: padded (dist[, succ], u, v, w)
        on the storage's carrier → repaired padded tables."""
        sr, s = self._run_semiring(key.dtype), key.block_size
        entry = ExecutablePlan(key=key, runner=None)
        entry.hbm_bytes_per_round = plan.repair_hbm_bytes(
            key.n_padded, s, word=plan.word_for(key.dtype), edges=key.edges,
            successors=key.successors,
        )
        if key.successors:
            entry.runner = lambda dp, sp, u, v, w: _fr.fw_repair_with_successors(
                dp, sp, u, v, w, block_size=s
            )
            return entry
        if key.method == "repair_distributed":
            mesh = self.mesh
            repair = _dist.build_repair_shard_fn(mesh, key.n_padded, semiring=sr,
                                                 edges=key.edges)

            def repair_fn(dp, u, v, w):
                return _dist.gather(repair(_dist.local_block(dp, mesh), u, v, w), mesh)
        else:
            repair_fn = functools.partial(_fr.fw_repair, block_size=s, semiring=sr)

        def runner(dp, u, v, w):
            if "plus_mul" not in key.semiring:
                return repair_fn(dp, u, v, w)
            # plus_mul: FW keeps a 0 (⊕-identity) diagonal; the repair
            # recurrence needs the ⊗-identity there.  Lift, repair, restore,
            # in the storage's dtype.
            diag = torch.diagonal(dp).clone()
            lifted = dp.clone()
            torch.diagonal(lifted).fill_(sr.one)
            out = repair_fn(lifted, u, v, w)
            torch.diagonal(out).copy_(diag)
            return out

        entry.runner = runner
        return entry

    def _build_repair_del_mark(self, key: PlanKey) -> ExecutablePlan:
        """Stage-1 runner: padded (closure[, succ], weights, edge batch, live
        count) → (d_init[, s_init], affected-row mask, entry count); torch
        ops on the engine's device."""
        sr = self._run_semiring(key.dtype)
        if key.successors:
            runner = functools.partial(_frd.mark_affected_with_successors, semiring=sr)
        else:
            runner = functools.partial(_frd.mark_affected, semiring=sr)
        return ExecutablePlan(key=key, runner=runner)

    def _build_repair_del_sweep(self, key: PlanKey) -> ExecutablePlan:
        """Stage-2 runner: (d_init[, s_init], padded affected rows) → the
        repaired closure (and next hops).  key.edges carries the row bucket
        a_pad, the strip's height.  plus_mul never reaches here."""
        s = key.block_size
        entry = ExecutablePlan(key=key, runner=None)
        entry.hbm_bytes_per_round = plan.repair_del_hbm_bytes(
            key.n_padded, s, affected_rows=key.edges, word=plan.word_for(key.dtype),
            successors=key.successors,
        )
        if key.successors:
            entry.runner = functools.partial(_frd.fw_repair_del_sweep_with_successors,
                                             block_size=s)
        else:
            entry.runner = functools.partial(
                _frd.fw_repair_del_sweep, block_size=s, bk=key.bk, variant=self.variant,
                semiring=self._run_semiring(key.dtype),
            )
        return entry

    # -------------------------------------------------------------- helpers
    def _run_semiring(self, dtype: str) -> Semiring:
        """The semiring a key's kernels run: the engine's, or the one of the
        int32 carrier of an integer storage."""
        t = getattr(torch, dtype)
        return int_carrier(self.semiring, t) if int_storage(t, self.semiring) else self.semiring

    def _carry(self, t: torch.Tensor) -> tuple[torch.Tensor, Semiring]:
        """(the tensor the kernels take, their semiring): an integer or_and /
        plus_mul storage goes to its int32 carrier."""
        if int_storage(t.dtype, self.semiring):
            return to_carrier(t, self.semiring), int_carrier(self.semiring, t.dtype)
        return t, self.semiring

    def _back(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Inverse of ``_carry`` for a result in the storage ``dtype``."""
        return from_carrier(t, dtype, self.semiring) if int_storage(dtype, self.semiring) else t

    def _check_succ(self, succ, arr: torch.Tensor, what: str) -> None:
        if succ is None:
            return
        if not _is_min_plus(self.semiring):
            raise ValueError(f"successor {what} is min_plus only (like every successor path)")
        if not arr.is_floating_point():
            raise ValueError(f"successor {what} needs a float distance table (the "
                             f"strict-< relaxation is not lowered for int16)")
        if self.method == "distributed":
            raise ValueError(f"distributed {what} is distance-only (like the "
                             f"distributed solve)")

    def _run(self, entry: ExecutablePlan, graphs: list, m: int):
        """Carry, pad to the plan shape and stack the (n_i, n_i) graphs of
        one bucket, run the cached runner, unpad to m and return the
        (B, m, m) results in the storage dtype (on the host for an
        out-of-core key, whose graphs stay there)."""
        dtype = graphs[0].dtype
        if not entry.key.oocore:
            graphs = [g.to(self.device) for g in graphs]
        carried = [self._carry(g) for g in graphs]
        sr = carried[0][1]
        wb = torch.stack([_pad(c, entry.key.n_padded, sr) for c, _ in carried])
        out = entry.runner(wb)
        dist, succ = out if entry.key.successors else (out, None)
        dist = self._back(dist[..., :m, :m], dtype)
        return dist, succ[..., :m, :m] if succ is not None else None

    def _result(self, entry: ExecutablePlan, dist, succ, n: int) -> APSPResult:
        return APSPResult(
            dist=dist, succ=succ, method=entry.key.method,
            semiring=entry.key.semiring, block_size=entry.key.block_size,
            n=n, padded_n=entry.key.n_padded,
        )


def _edge_weights(count: int, fill, dtype: torch.dtype, values, *,
                  lenient: bool = False) -> torch.Tensor:
    """(count,) edge weights in the storage ``dtype`` on the CPU: ``values``
    first, ``fill`` (the ⊕-identity) after them.  A value the dtype cannot
    hold (±inf or out of range in an integer storage) raises ValueError, as
    the reference's numpy assignment does, or with ``lenient`` keeps the
    fill: a non-finite old weight in an integer lowering names an edge that
    never existed there, and the ⊕-identity witness is inert."""
    hold = torch.int64 if dtype == torch.uint32 else dtype  # uint32 has no index_put
    w = torch.full((count,), fill, dtype=hold)
    for i, x in enumerate(values):
        try:
            if dtype == torch.uint32 and not 0 <= x < 1 << 32:
                raise OverflowError(f"{x} does not fit uint32")
            w[i] = x
        except (RuntimeError, OverflowError, ValueError) as err:
            if not lenient:
                raise ValueError(f"edge weight {x!r} does not fit the {dtype} "
                                 f"storage") from err
    return w.to(dtype)


def negative_cycle_mask_padded(dist, ns: Sequence[int]) -> np.ndarray:
    """Per-graph negative-cycle mask honouring each graph's true size.

    dist: (B, m, m) padded closures; ns: true vertex counts.  Padding
    vertices have a 0 (⊗-identity) diagonal, so restricting the check to
    the real diagonal is equivalent but keeps intent explicit.
    """
    neg = (torch.diagonal(torch.as_tensor(dist), dim1=-2, dim2=-1) < 0).cpu().numpy()
    return np.array([bool(neg[k, : ns[k]].any()) for k in range(len(ns))])
