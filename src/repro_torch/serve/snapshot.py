"""Double-buffered snapshot store: consistent reads under live refreshes.

Counterpart of ``repro.serve.snapshot``.  The serving invariant: a query
must never observe a half-updated routing table.  ``SnapshotStore`` gets
this with immutability plus a two-slot (front/back) buffer per graph:

  * the **active** slot is what queries read — an immutable ``Snapshot``
    (read-only host arrays, a frozen dataclass);
  * a refresh writes its freshly solved tables into the **staged** slot
    with ``stage()``; queries keep hitting the old active snapshot;
  * ``publish()`` swaps staged → active in one reference assignment.

A reader that grabbed ``active(gid)`` before a publish keeps a fully
consistent (dist, succ, version) view for as long as it holds the object —
the swap never mutates a published snapshot, it only changes which object
subsequent readers get.

Host tables.  Snapshots (and the registry's weights) live on the host as
read-only numpy arrays in their storage width, whatever device solved
them, so a table of n² entries counts n² × its word in bytes: 4 in f32 and
int32, 2 in bf16, f16 and int16.  bfloat16 is not a numpy dtype and the
port imports no ``ml_dtypes``, so a bf16 table is held as its **uint16
bits**, and the storage dtype (a ``torch.dtype``) rides beside every table
(``Snapshot.dtype``, ``GraphRegistry.storage_dtype``).  Three functions
convert:

  * ``host_array(x)`` — a tensor on any device, or a numpy array (an
    ``ml_dtypes`` bfloat16 one by bit view), → (a fresh read-only host
    array, its storage dtype);
  * ``host_tensor(a, dtype)`` — a fresh CPU tensor in the storage dtype: a
    copy, so nothing written to it reaches the table;
  * ``host_values(a, dtype)`` — the values numpy can compare and sum
    (bf16 bits lifted to float32, exactly; any other dtype as it is).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _is_bfloat16(dtype: np.dtype) -> bool:
    return dtype.name == "bfloat16" and dtype.itemsize == 2


def _frozen(a: np.ndarray) -> np.ndarray:
    a.flags.writeable = False
    return a


def host_array(x, *, copy: bool = True) -> tuple[np.ndarray, torch.dtype]:
    """(read-only host array, storage dtype) of a tensor or an array.

    copy=False keeps a numpy array that is already read-only as it is (the
    reference's ``_freeze``: a view-or-copy); every other input is copied,
    so a later write to the caller's object cannot reach the result.
    """
    if isinstance(x, torch.Tensor):
        t = x.detach()
        t = t.clone() if t.device.type == "cpu" else t.cpu()
        if t.dtype == torch.bfloat16:
            return _frozen(t.view(torch.int16).numpy().view(np.uint16)), torch.bfloat16
        return _frozen(t.numpy()), t.dtype
    a = np.asarray(x)
    if _is_bfloat16(a.dtype):
        a, dtype = a.view(np.uint16), torch.bfloat16
    else:
        dtype = torch.from_numpy(np.zeros(0, a.dtype)).dtype
    if copy or a.flags.writeable:
        a = np.array(a, copy=True)
    return _frozen(a), dtype


def host_tensor(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A fresh CPU tensor of a host array in its storage ``dtype``."""
    a = np.array(a, copy=True)
    if dtype == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def host_values(a, dtype: torch.dtype) -> np.ndarray:
    """A host array's values for numpy: bf16 bits lifted to float32 (exact),
    any other storage as it is."""
    a = np.asarray(a)
    if dtype == torch.bfloat16:
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """One immutable solved view of a graph: distances + next hops.

    ``succ`` is None when the refresh ran distance-only (lowered engines,
    distributed meshes); queries then reconstruct hops from dist + the
    adjacency matrix.  ``version`` increases monotonically per graph with
    every publish, so a reply can be traced to the exact table that served
    it.  ``dtype`` is dist's storage dtype (see the module docstring: a
    bf16 ``dist`` holds uint16 bits).
    """

    dist: np.ndarray
    succ: np.ndarray | None
    version: int
    dtype: torch.dtype = torch.float32

    @property
    def nbytes(self) -> int:
        return self.dist.nbytes + (0 if self.succ is None else self.succ.nbytes)

    def dist_tensor(self) -> torch.Tensor:
        """A fresh CPU tensor of dist in its storage dtype."""
        return host_tensor(self.dist, self.dtype)

    def succ_tensor(self) -> torch.Tensor | None:
        return None if self.succ is None else host_tensor(self.succ, torch.int32)


class SnapshotStore:
    """Per-graph front/back snapshot buffers (see module docstring)."""

    def __init__(self):
        self._active: dict[str, Snapshot] = {}
        self._staged: dict[str, Snapshot] = {}
        self.publishes = 0

    # -------------------------------------------------------------- writers
    def stage(self, graph_id: str, dist, succ=None) -> Snapshot:
        """Write a solved table (a tensor on any device, or an array) into
        the back buffer (not yet visible)."""
        version = self.version(graph_id) + 1
        d, dtype = host_array(dist, copy=False)
        snap = Snapshot(
            dist=d,
            succ=None if succ is None else host_array(succ, copy=False)[0],
            version=version,
            dtype=dtype,
        )
        self._staged[graph_id] = snap
        return snap

    def publish(self, graph_id: str) -> Snapshot:
        """Atomically swap the staged snapshot to active."""
        snap = self._staged.pop(graph_id, None)
        if snap is None:
            raise KeyError(f"nothing staged for graph {graph_id!r}")
        self._active[graph_id] = snap
        self.publishes += 1
        return snap

    def publish_all(self) -> int:
        """Publish every staged snapshot; returns how many flipped."""
        n = 0
        for gid in list(self._staged):
            self.publish(gid)
            n += 1
        return n

    def drop(self, graph_id: str) -> None:
        self._active.pop(graph_id, None)
        self._staged.pop(graph_id, None)

    # -------------------------------------------------------------- readers
    def active(self, graph_id: str) -> Snapshot | None:
        """The snapshot queries should read, or None before first publish."""
        return self._active.get(graph_id)

    def staged(self, graph_id: str) -> Snapshot | None:
        return self._staged.get(graph_id)

    def version(self, graph_id: str) -> int:
        """Highest version either buffer holds (0 = never solved)."""
        a = self._active.get(graph_id)
        s = self._staged.get(graph_id)
        return max(a.version if a else 0, s.version if s else 0)

    def ids(self) -> list[str]:
        return list(self._active)

    @property
    def total_bytes(self) -> int:
        return sum(s.nbytes for s in self._active.values()) + sum(
            s.nbytes for s in self._staged.values()
        )
