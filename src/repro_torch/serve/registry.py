"""Graph registry: the serving layer's source-of-truth weight store.

Counterpart of ``repro.serve.registry``, the same bookkeeping and
decisions.  Weights are held as read-only host arrays in their storage
width, a bf16 matrix as its uint16 bits with its dtype beside it
(``snapshot.host_array``; ``storage_dtype`` names it), so the byte totals,
and the evictions they drive, are the reference's on the same inputs.

One ``GraphRegistry`` owns every registered adjacency matrix plus three
pieces of bookkeeping the rest of ``repro_torch.serve`` composes around:

  * **memory accounting** — per-graph bytes (weights + the solved tables
    the routing layer reports back via ``note_table_bytes``) and a running
    total, with optional ``capacity_bytes`` LRU eviction.  Eviction drops a
    graph's *solved tables* (the re-creatable part) and marks it
    structurally dirty; the weights — the irreducible source of truth —
    always stay.
  * **dirty classification** — an *edge-delta* dirty graph accumulated only
    ⊕-improving single-edge updates since its last solve, so a refresh may
    absorb them with the O(E·n²) rank-1 repair (``ApspEngine.repair``).
    A *structurally* dirty graph saw a replacement, an edge removal, or a
    ⊕-worsening — repair's exactness conditions are gone.  Structural
    events whose every change is a recorded *deletion/worsening* of a known
    edge (``mark_deletion``) stay eligible for the decremental fast path
    (``ApspEngine.repair_del``): the pending ``(u, v, w_old)`` list is the
    witness batch its affected-set marking needs.  A replacement, an
    eviction, or any unrecorded structural change clears that list — only a
    full re-solve is sound then.  Any structural event clears the pending
    delta list: deltas are relative to the last *solved* table, which the
    structural change invalidates wholesale.  Symmetrically, an improvement
    arriving *after* recorded deletions clears the deletion list: repair_del
    re-relaxes only rows the deletions touched, which cannot absorb an
    unrelated improvement.
  * **LRU order** — reads ``touch()`` a graph; eviction walks the
    least-recently-used end first and never evicts a dirty graph's place in
    line before its tables exist.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.serve.snapshot import host_array, host_tensor


@dataclasses.dataclass(frozen=True)
class EdgeUpdate:
    """One ⊕-improving edge update pending against a solved table.

    ``w`` follows ``ApspEngine.repair`` semantics: the improved weight
    itself for the idempotent semirings, the additive ⊕-delta for plus_mul,
    the int32 lane mask for packed or_and.
    """

    u: int
    v: int
    w: float

    def as_tuple(self) -> tuple[int, int, float]:
        return (self.u, self.v, self.w)


# Dirty kinds (see module docstring).
DELTA = "delta"
STRUCTURAL = "structural"


class GraphRegistry:
    """Weight store + memory accounting + dirty classification (no solving)."""

    def __init__(self, *, capacity_bytes: int | None = None):
        self.capacity_bytes = capacity_bytes
        self._graphs: dict[str, np.ndarray] = {}
        self._dtypes: dict[str, torch.dtype] = {}
        self._table_bytes: dict[str, int] = {}
        # dict preserves insertion order → doubles as the LRU list
        # (move_to_end semantics via pop + re-insert in touch()).
        self._lru: dict[str, None] = {}
        self._dirty: dict[str, str] = {}  # gid -> DELTA | STRUCTURAL
        self._deltas: dict[str, list[EdgeUpdate]] = {}
        self._structural: dict[str, int] = {}  # gid -> worsening events
        # gid -> recorded (u, v, w_old) deletions/worsenings; non-empty ⇒
        # this structurally-dirty graph is still repair_del-eligible.
        self._deletions: dict[str, list[tuple[int, int, float]]] = {}
        self.evictions = 0

    # ------------------------------------------------------------- weights
    def put(self, graph_id: str, w) -> None:
        """Register or replace a graph's weights (a structural event).

        w: an (n, n) or (P, n, n) array or tensor (any device).  The matrix
        is copied to the host and frozen: later in-place mutation of the
        caller's object cannot desynchronize the registry from the solved
        tables — changes go through the routing layer's mutators so they
        are classified.
        """
        a, dtype = host_array(w)
        if a.ndim not in (2, 3) or a.shape[-1] != a.shape[-2]:
            raise ValueError(f"graph {graph_id!r} must be (n,n), got {a.shape}")
        self._graphs[graph_id] = a
        self._dtypes[graph_id] = dtype
        self.touch(graph_id)
        self.mark_structural(graph_id)

    def replace_weights(self, graph_id: str, w) -> None:
        """Swap weights *without* touching dirty state — for the routing
        layer applying an already-classified edge mutation in place."""
        self._graphs[graph_id], self._dtypes[graph_id] = host_array(w)

    def get(self, graph_id: str) -> np.ndarray:
        """The (read-only) weight matrix; counts as a use for LRU."""
        if graph_id not in self._graphs:
            raise KeyError(f"unknown graph {graph_id!r}")
        self.touch(graph_id)
        return self._graphs[graph_id]

    def peek(self, graph_id: str) -> np.ndarray:
        """``get`` without the LRU touch (internal bookkeeping reads)."""
        if graph_id not in self._graphs:
            raise KeyError(f"unknown graph {graph_id!r}")
        return self._graphs[graph_id]

    def weights_tensor(self, graph_id: str) -> torch.Tensor:
        """A fresh CPU tensor of the weights in their storage dtype (a copy;
        no LRU touch)."""
        return host_tensor(self.peek(graph_id), self.storage_dtype(graph_id))

    def storage_dtype(self, graph_id: str) -> torch.dtype:
        """The weights' storage dtype (``peek`` of a bf16 graph is bits)."""
        if graph_id not in self._dtypes:
            raise KeyError(f"unknown graph {graph_id!r}")
        return self._dtypes[graph_id]

    def __contains__(self, graph_id: str) -> bool:
        return graph_id in self._graphs

    def remove(self, graph_id: str) -> None:
        self._graphs.pop(graph_id, None)
        self._dtypes.pop(graph_id, None)
        self._table_bytes.pop(graph_id, None)
        self._lru.pop(graph_id, None)
        self._dirty.pop(graph_id, None)
        self._deltas.pop(graph_id, None)
        self._structural.pop(graph_id, None)
        self._deletions.pop(graph_id, None)

    def ids(self) -> list[str]:
        return list(self._graphs)

    # ---------------------------------------------------------------- dirty
    def mark_structural(self, graph_id: str) -> None:
        """Replacement / removal / unrecorded ⊕-worsening: full re-solve
        required — also forfeits any recorded deletions (the pending list
        no longer describes every change since the last solve)."""
        self._dirty[graph_id] = STRUCTURAL
        self._deltas.pop(graph_id, None)
        self._deletions.pop(graph_id, None)
        self._structural[graph_id] = self._structural.get(graph_id, 0) + 1

    def mark_deletion(self, graph_id: str, u: int, v: int, w_old) -> None:
        """Record one edge deletion/worsening with the weight it carried —
        a structural event that KEEPS decremental-repair eligibility.

        Downgrades to plain ``mark_structural`` when the pending state
        cannot be absorbed by ``ApspEngine.repair_del`` anyway: pending
        ⊕-improvements (kind DELTA — the snapshot-relative witness test
        would run against a closure the improvements have not reached), or
        an earlier unrecorded structural event (replacement/eviction —
        the recorded list would be incomplete).
        """
        kind = self._dirty.get(graph_id)
        if kind == DELTA or (kind == STRUCTURAL
                             and graph_id not in self._deletions):
            self.mark_structural(graph_id)
            return
        self._dirty[graph_id] = STRUCTURAL
        self._structural[graph_id] = self._structural.get(graph_id, 0) + 1
        self._deletions.setdefault(graph_id, []).append((u, v, w_old))

    def mark_edge_delta(self, graph_id: str, u: int, v: int, w) -> None:
        """Accumulate one ⊕-improving update; stays delta-dirty unless the
        graph is already structurally dirty (structural wins — and an
        improvement after recorded deletions forfeits repair_del, whose
        sweep only re-relaxes the deletion-affected rows)."""
        if self._dirty.get(graph_id) == STRUCTURAL:
            self._deletions.pop(graph_id, None)
            return
        self._dirty[graph_id] = DELTA
        self._deltas.setdefault(graph_id, []).append(EdgeUpdate(u, v, w))

    def dirty_kind(self, graph_id: str) -> str | None:
        """DELTA, STRUCTURAL, or None when the graph is clean."""
        return self._dirty.get(graph_id)

    def pending_deltas(self, graph_id: str) -> list[EdgeUpdate]:
        return list(self._deltas.get(graph_id, ()))

    def pending_deletions(self, graph_id: str) -> list[tuple[int, int, float]]:
        """The recorded ``(u, v, w_old)`` deletion batch — non-empty exactly
        when this structurally-dirty graph may refresh via
        ``ApspEngine.repair_del`` instead of a full re-solve."""
        return list(self._deletions.get(graph_id, ()))

    def structural_count(self, graph_id: str) -> int:
        """Worsening/structural events since the last solve — the count
        ``ApspEngine.should_repair(worsenings=…)`` fast-rejects on."""
        return self._structural.get(graph_id, 0)

    def clear_dirty(self, graph_id: str) -> None:
        self._dirty.pop(graph_id, None)
        self._deltas.pop(graph_id, None)
        self._structural.pop(graph_id, None)
        self._deletions.pop(graph_id, None)

    def dirty_ids(self) -> list[str]:
        """Insertion-ordered dirty set; drives refresh batching."""
        return list(self._dirty)

    @property
    def dirty_count(self) -> int:
        return len(self._dirty)

    # --------------------------------------------------------------- memory
    def touch(self, graph_id: str) -> None:
        self._lru.pop(graph_id, None)
        self._lru[graph_id] = None

    def note_table_bytes(self, graph_id: str, nbytes: int) -> None:
        """The routing layer reports solved-table footprint after publish."""
        self._table_bytes[graph_id] = int(nbytes)

    def graph_bytes(self, graph_id: str) -> int:
        """Weights + solved tables for one graph."""
        w = self._graphs.get(graph_id)
        return (w.nbytes if w is not None else 0) + self._table_bytes.get(
            graph_id, 0
        )

    @property
    def total_bytes(self) -> int:
        return sum(self.graph_bytes(g) for g in self._graphs)

    def evict_over_capacity(self, *, keep: set[str] | None = None) -> list[str]:
        """LRU-evict solved tables until under ``capacity_bytes``.

        Returns the evicted graph ids — the caller (routing layer) must
        drop their snapshots.  Each evicted graph is marked structurally
        dirty so a later query re-solves it; weights are never dropped, so
        the floor is the sum of registered weight matrices.  ``keep``
        shields graphs refreshed *this* cycle — evicting a table the
        caller is about to read would thrash; they join the normal LRU
        order for the next cycle.
        """
        if self.capacity_bytes is None:
            return []
        keep = keep or set()
        evicted: list[str] = []
        for gid in list(self._lru):
            if self.total_bytes <= self.capacity_bytes:
                break
            if gid in keep or self._table_bytes.get(gid, 0) == 0:
                continue  # shielded, or nothing re-creatable to free
            self._table_bytes.pop(gid, None)
            self.mark_structural(gid)
            evicted.append(gid)
            self.evictions += 1
        return evicted
