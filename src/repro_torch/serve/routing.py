"""``RoutingEngine``: the public APSP serving front end, a thin composition.

Counterpart of ``repro.serve.routing`` over the port's ``ApspEngine``.
Layers (one file each, composed here and only here):

    GraphRegistry   (registry.py)   weights, memory/LRU, dirty classification
    SnapshotStore   (snapshot.py)   double-buffered dist+succ host tables
    MicroBatcher    (scheduler.py)  max-batch/max-wait query batching
    ApspEngine      (repro_torch.apsp)  the device work: solve_many / repair

The serving contract: mutations only mark tables dirty; ``refresh()``
brings the dirty set current — structurally dirty graphs re-solve in ONE
bucketed batched ``solve_many``, edge-delta dirty graphs absorb their
pending updates with the O(E·n²) rank-1 ``repair`` when the
``should_repair`` cost model says it beats a re-solve, and graphs whose
only changes are recorded deletions take the decremental ``repair_del``.
Fresh tables are copied to the host, stage into the snapshot back buffer
and publish atomically, so queries — pure host-side walks — always read a
consistent table, even mid-refresh, and never touch the device.  A repair
hands the published host table back to the engine, which copies it to the
card.  ``query`` on a stale graph refreshes *that graph only* (under
``auto_refresh``; raises otherwise).

Tables are host arrays in their storage width; a bf16 one is its uint16
bits with the dtype beside it (``snapshot`` module docstring).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch

from repro_torch.serve import registry as _registry
from repro_torch.serve.registry import GraphRegistry
from repro_torch.serve.scheduler import MicroBatcher, PendingQuery, Ticket
from repro_torch.serve.snapshot import Snapshot, SnapshotStore, host_values

_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32,
           torch.uint64: torch.uint32}


@dataclasses.dataclass(frozen=True)
class RouteReply:
    """One answered shortest-path query."""

    graph_id: str
    src: int
    dst: int
    path: list[int]          # [] when dst is unreachable from src
    cost: float              # +inf when unreachable

    @property
    def reachable(self) -> bool:
        return bool(self.path)


def _as_storage(w, dtype: torch.dtype) -> torch.Tensor:
    """w as a 0-d tensor of the storage ``dtype``, converted as numpy
    converts a scalar (``np.asarray(w, dtype)``: a float truncates into an
    integer storage, ±inf or a value out of range raises); bf16 rounds
    through f32, as ``ml_dtypes`` does."""
    if dtype == torch.bfloat16:
        return torch.tensor(float(w), dtype=torch.float64).to(torch.bfloat16)
    like = torch.empty(0, dtype=dtype).numpy().dtype
    return torch.from_numpy(np.array(np.asarray(w, like)))


def _merge(sr, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sr.add(a, b)`` on host values as the reference computes it: JAX
    without x64 narrows 64-bit types to 32 bits; integer storages combine
    in int64 and wrap back (or_and / min / max select, plus_mul wraps, the
    packed lanes OR), which torch's CPU ops on uint32 cannot do."""
    dt = _NARROW.get(a.dtype, a.dtype)
    if a.is_floating_point():
        return sr.add(a.to(dt), b.to(dt))
    return sr.add(a.to(torch.int64), b.to(torch.int64)).to(dt)


def _values(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's values for ``np.array_equal`` (bf16 widened, exact)."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class RoutingEngine:
    """Serve shortest-path queries over many graphs via one ``ApspEngine``.

        router = RoutingEngine()               # on the card
        router.add_graph("dc-east", w_east)
        router.add_graph("dc-west", w_west)
        router.refresh()                       # ONE bucketed batched solve
        router.update_edge("dc-east", 3, 7, 0.5)   # ⊕-improvement → repair
        reply = router.query("dc-east", 12, 17)

    Mutations classify (``registry.GraphRegistry``): ``update_edge`` with an
    ⊕-improving weight accumulates an edge delta, so the next refresh of
    that graph is one fused rank-1 repair dispatch instead of an O(n³)
    re-solve; ⊕-worsenings (``set_edge``) and removals (``fail_link``)
    are recorded deletions that refresh through the decremental
    ``repair_del``; replacements (``add_graph``) re-solve.  Queries never
    touch the device: they walk the cached successor matrix on the host
    (O(path length)) off an immutable published snapshot
    (``snapshot.SnapshotStore``).  ``submit()``/``poll()`` push queries
    through the micro-batching scheduler instead of answering inline.

    ``mesh=`` (a ``launch.mesh.GridMesh``) shards refreshes across a
    process grid: the engine runs method="distributed" (the bordered round
    on every rank), the refresh caches *distances only* (the distributed
    round does not track successors; repairs go through the mesh repair
    and the local sweep), and queries reconstruct hops host-side from dist
    + the adjacency matrix (``core.paths.extract_path_from_dist``,
    O(path·n)).  Every rank of the grid makes the same router calls and
    publishes the same tables.  The grid is R×C by construction, so the
    reference's ``row_axes`` / ``col_axes`` have no counterpart.
    """

    def __init__(
        self,
        *,
        engine=None,
        method: str = "auto",
        block_size: int | None = None,
        device="cuda",
        auto_refresh: bool = True,
        mesh=None,
        capacity_bytes: int | None = None,
        max_batch: int = 32,
        max_wait_s: float = 0.002,
        repair_threshold: float = 0.5,
        clock=None,
    ):
        """engine: a pre-built ApspEngine (overrides every other solve knob).
        method/block_size/device: forwarded to the owned ApspEngine
        (device "cuda", the default, raises without a card; "cpu" runs the
        plain versions).  mesh: serve over a process grid (see class doc;
        its device must be ``device``).  auto_refresh: stale graphs
        re-solve on first read instead of raising.  capacity_bytes:
        LRU-evict solved tables past this footprint (weights always stay).
        max_batch/max_wait_s: the ``submit()`` micro-batching policy.
        repair_threshold: forwarded to ``ApspEngine.should_repair`` — the
        fraction of a full solve's modeled traffic a repair may cost
        before refresh falls back to re-solving.  clock: injectable
        monotonic clock for the scheduler."""
        from repro_torch.apsp import ApspEngine

        if engine is None:
            if mesh is not None:
                engine = ApspEngine(
                    method="distributed", block_size=block_size, mesh=mesh,
                    device=device,
                )
            else:
                engine = ApspEngine(
                    method=method, block_size=block_size, device=device,
                )
        self.engine = engine
        self.auto_refresh = auto_refresh
        self.repair_threshold = repair_threshold
        self.registry = GraphRegistry(capacity_bytes=capacity_bytes)
        self.snapshots = SnapshotStore()
        kw = {} if clock is None else {"clock": clock}
        self.batcher = MicroBatcher(
            self._flush_batch, max_batch=max_batch, max_wait_s=max_wait_s, **kw
        )
        self.repair_refreshes = 0
        self.repair_del_refreshes = 0
        self.solve_refreshes = 0

    # ------------------------------------------------------------- registry
    def add_graph(self, graph_id: str, w) -> None:
        """Register (or replace) a graph; its tables become structurally
        stale (a replacement invalidates any pending edge deltas)."""
        self.registry.put(graph_id, w)

    update_graph = add_graph

    def update_edge(
        self, graph_id: str, u: int, v: int, w, *, symmetric: bool = False
    ) -> bool:
        """Merge one edge update ``w`` under ⊕ (repair semantics: the
        improved weight for idempotent semirings, the additive delta for
        plus_mul, the int32 lane mask for packed words).  Because the merge
        is ``old ⊕ w``, this path can only *improve* the edge — so the
        graph goes edge-delta dirty and the next refresh may use the rank-1
        repair.  Returns whether anything changed (``old ⊕ w == old`` is a
        no-op).  Worsen or remove an edge with ``set_edge`` / ``fail_link``
        (structural)."""
        sr = self.engine.semiring
        wm = self.registry.weights_tensor(graph_id)
        changed = False
        for i, j in ((u, v), (v, u)) if symmetric else ((u, v),):
            old = wm[..., i, j].clone()
            new = _merge(sr, old, _as_storage(w, wm.dtype))
            if np.array_equal(_values(new), _values(old)):
                continue
            wm[..., i, j] = new
            self.registry.mark_edge_delta(graph_id, i, j, w)
            changed = True
        if changed:
            self.registry.replace_weights(graph_id, wm)
        return changed

    def set_edge(
        self, graph_id: str, u: int, v: int, w, *, symmetric: bool = False
    ) -> None:
        """Force-assign an edge weight (may worsen) — structural dirty.

        The assignment is classified per edge: a pure ⊕-*worsening* (a
        removal, a min-plus weight increase, cleared or_and lanes —
        ``old ⊕ new == old``) records the old weight with
        ``mark_deletion``, keeping the graph eligible for the decremental
        repair at the next refresh; anything else (an improvement, a
        multi-plane mixed change) is plain ``mark_structural`` and will
        re-solve.  An assignment that changes nothing stays clean.
        """
        sr = self.engine.semiring
        wm = self.registry.weights_tensor(graph_id)
        changed = False
        for i, j in ((u, v), (v, u)) if symmetric else ((u, v),):
            old = wm[..., i, j].clone()
            new = _as_storage(w, wm.dtype)
            if np.array_equal(_values(new), _values(old)):
                continue
            wm[..., i, j] = new
            changed = True
            merged = _merge(sr, old, new)
            if np.array_equal(_values(merged), _values(old)) and old.numel() == 1:
                self.registry.mark_deletion(graph_id, i, j, old.item())
            else:
                self.registry.mark_structural(graph_id)
        if changed:
            self.registry.replace_weights(graph_id, wm)

    def fail_link(self, graph_id: str, u: int, v: int, *, symmetric=True) -> None:
        """Serving-side mutation: remove edge(s) and mark the graph dirty —
        a pure worsening, so ``set_edge`` records it as a deletion and the
        next refresh absorbs it decrementally when the damage is small."""
        self.set_edge(graph_id, u, v, np.inf, symmetric=symmetric)

    def remove_graph(self, graph_id: str) -> None:
        self.registry.remove(graph_id)
        self.snapshots.drop(graph_id)

    @property
    def graph_ids(self) -> list[str]:
        return self.registry.ids()

    @property
    def dirty_count(self) -> int:
        return self.registry.dirty_count

    # -------------------------------------------------------------- solving
    def refresh(self, graph_ids: Iterable[str] | None = None) -> int:
        """Bring dirty graphs current; returns how many were refreshed.

        graph_ids: restrict to these graphs (clean ones in the list are
        skipped; None = the whole dirty set).  Edge-delta dirty graphs
        with a published snapshot go through ``ApspEngine.repair`` when
        ``should_repair`` says the backlog is still cheaper than a
        re-solve.  Structurally dirty graphs whose every change is a
        *recorded deletion/worsening* (``registry.pending_deletions``) go
        through the decremental ``ApspEngine.repair_del`` — which itself
        re-solves past the affected-fraction crossover, counted in the
        engine's ``repair_del_fallbacks``.  Everything else re-solves in
        ONE bucketed ``solve_many``.  All fresh tables stage first and
        publish together at the end — queries racing a refresh read the
        old consistent snapshots until the atomic swap.
        """
        dirty = self.registry.dirty_ids()
        if graph_ids is not None:
            want = set(graph_ids)
            dirty = [g for g in dirty if g in want]
        if not dirty:
            return 0
        from repro_torch.core.semiring import MIN_PLUS

        # Successor tables exist only for the strict-< min_plus relaxation
        # on float storage; lowered/non-tropical engines (and the
        # distributed round) serve dist-only snapshots and reconstruct
        # hops host-side via extract_path_from_dist.
        use_succ = (
            self.engine.method != "distributed"
            and self.engine.semiring is MIN_PLUS
        )
        repair_ids: list[str] = []
        repair_del_ids: list[str] = []
        solve_ids: list[str] = []
        for gid in dirty:
            snap = self.snapshots.active(gid)
            deltas = self.registry.pending_deltas(gid)
            if (
                self.registry.dirty_kind(gid) == _registry.STRUCTURAL
                and snap is not None
                and self.registry.pending_deletions(gid)
                # repair_del takes one (n, n) closure (or a single packed
                # word plane) — multi-plane snapshots re-solve.
                and (np.ndim(snap.dist) == 2 or snap.dist.shape[0] == 1)
            ):
                repair_del_ids.append(gid)
            elif (
                self.registry.dirty_kind(gid) == _registry.DELTA
                and snap is not None
                and deltas
                # worsenings= is the explicit belt to dirty_kind's braces:
                # any structural/worsening event fast-rejects inside the
                # policy itself (and counts in stats.repair_rejects), so
                # the fallback shows up in engine metrics even if a future
                # classifier bug ever left such a graph delta-dirty.
                and self.engine.should_repair(
                    snap.dist.shape[-1], len(deltas),
                    successors=snap.succ is not None,
                    dtype=snap.dtype,
                    threshold=self.repair_threshold,
                    worsenings=self.registry.structural_count(gid),
                )
            ):
                repair_ids.append(gid)
            else:
                solve_ids.append(gid)
        if solve_ids:
            results = self.engine.solve_many(
                [self.registry.weights_tensor(g) for g in solve_ids], successors=use_succ
            )
            for gid, res in zip(solve_ids, results):
                self.snapshots.stage(gid, res.dist, res.succ)
            self.solve_refreshes += len(solve_ids)
        for gid in repair_ids:
            snap = self.snapshots.active(gid)
            updates = [e.as_tuple() for e in self.registry.pending_deltas(gid)]
            res = self.engine.repair(snap.dist_tensor(), updates,
                                     succ=snap.succ_tensor())
            self.snapshots.stage(gid, res.dist, res.succ)
            self.repair_refreshes += 1
        for gid in repair_del_ids:
            snap = self.snapshots.active(gid)
            res = self.engine.repair_del(
                snap.dist_tensor(), self.registry.weights_tensor(gid),
                self.registry.pending_deletions(gid), succ=snap.succ_tensor(),
                threshold=self.repair_threshold,
            )
            self.snapshots.stage(gid, res.dist, res.succ)
            self.repair_del_refreshes += 1
        # Atomic cutover: every staged table publishes only now, after all
        # device work finished — a reader mid-refresh saw old tables only.
        for gid in dirty:
            snap = self.snapshots.publish(gid)
            self.registry.note_table_bytes(gid, snap.nbytes)
            self.registry.clear_dirty(gid)
            self.registry.touch(gid)
        for gid in self.registry.evict_over_capacity(keep=set(dirty)):
            self.snapshots.drop(gid)
        return len(dirty)

    # -------------------------------------------------------------- queries
    def _fresh_snapshot(self, graph_id: str) -> Snapshot:
        """The staleness contract shared by every read path: a dirty graph
        refreshes (that graph ONLY) under ``auto_refresh`` and raises
        otherwise."""
        if graph_id not in self.registry:
            raise KeyError(f"unknown graph {graph_id!r}")
        if self.registry.dirty_kind(graph_id) is not None:
            if not self.auto_refresh:
                raise RuntimeError(
                    f"graph {graph_id!r} is stale; call refresh()"
                )
            self.refresh([graph_id])
        return self.snapshots.active(graph_id)

    def query(self, graph_id: str, src: int, dst: int) -> RouteReply:
        """Shortest path + cost from the published snapshot.

        src/dst: vertex indices into the registered graph.  Successor
        tables give an O(path length) walk; distance-only tables (lowered
        engines, mesh serving) reconstruct each hop from dist + adjacency
        instead.  The cost is the table's entry as a float (an int16
        table's sentinel stays 32767.0, as in the reference).
        """
        from repro_torch.core.paths import extract_path, extract_path_from_dist

        snap = self._fresh_snapshot(graph_id)
        if snap.succ is not None:
            path = extract_path(snap.succ, src, dst)
        else:
            path = extract_path_from_dist(
                host_values(self.registry.get(graph_id),
                            self.registry.storage_dtype(graph_id)),
                host_values(snap.dist, snap.dtype), src, dst,
            )
        cost = float(host_values(snap.dist[src, dst], snap.dtype))
        return RouteReply(
            graph_id=graph_id, src=src, dst=dst, path=path, cost=cost
        )

    def query_many(
        self, requests: Iterable[tuple[str, int, int]]
    ) -> list[RouteReply]:
        """Answer a request batch; at most one refresh for all of them —
        and only of the graphs the batch actually touches."""
        requests = list(requests)
        if self.auto_refresh:
            touched = {g for g, _, _ in requests}
            if any(self.registry.dirty_kind(g) is not None for g in touched):
                self.refresh(touched)
        return [self.query(g, s, d) for g, s, d in requests]

    def distances(self, graph_id: str) -> np.ndarray:
        """The published (refreshing if stale) distance matrix of one graph:
        a read-only host array (bf16 as its bits; ``Snapshot.dtype``)."""
        return self._fresh_snapshot(graph_id).dist

    # ------------------------------------------------------------ scheduler
    def submit(self, graph_id: str, src: int, dst: int) -> Ticket:
        """Enqueue a query on the micro-batcher; resolve with
        ``ticket.result()`` (or let ``poll()``/max-batch flush it)."""
        return self.batcher.submit(graph_id, src, dst)

    def poll(self) -> bool:
        """Flush the batcher if its oldest query aged past max_wait_s."""
        return self.batcher.poll()

    def _flush_batch(self, batch: list[PendingQuery]) -> list[RouteReply]:
        return self.query_many([(q.graph_id, q.src, q.dst) for q in batch])
