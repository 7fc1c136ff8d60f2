"""The process grid of the distributed solve: ``GridMesh`` and ``run_grid``.

Counterpart of ``repro.launch.mesh.make_host_mesh`` and of the shard_map
mesh the reference builds on it.  Here a mesh is an R×C grid of processes
in one ``torch.distributed`` group: rank ``r·C + c`` holds the (n/R, n/C)
block at grid row r and grid column c.  ``GridMesh`` gives a rank its
coordinates, one group per grid row and one per grid column, its device
(the card unless the caller asks for the CPU) and the one collective the
solve needs, ``broadcast``, with a counter of the bytes it hands to
collectives (``comm_bytes``).  A broadcast moves the tensor's bytes as a
``uint8`` view, whatever its dtype: gloo and NCCL have no int16 or uint32
type, and a pure copy of the bytes is exact for every storage.

Transport.  NCCL refuses two ranks on one card, so ranks that share a card
(or run on the CPU) talk over ``gloo``, and ``nccl`` is used only when each
rank has a card of its own.  ``gloo`` moves host memory: a CUDA tensor is
staged through a pinned host buffer around each broadcast, explicitly, so
the transport does not depend on which CUDA collectives this build of
``gloo`` has; ``staged_bytes`` counts what went that way.  The kernels run
on the card either way.

``run_grid`` spawns the R·C processes, rendezvous through a file store in a
temporary directory, runs ``fn(mesh, *args)`` on every rank and returns
each rank's result, or raises with the failing rank's traceback.  Every
wait has a deadline, so a rank that hangs or dies fails the run instead of
stalling it.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist


class GridError(RuntimeError):
    """A rank of ``run_grid`` failed, died or did not finish in time."""


class GridMesh:
    """This rank's view of an R×C process grid over the initialized default
    ``torch.distributed`` group (world size R·C)."""

    def __init__(self, R: int, C: int, *, device="cuda"):
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' for a grid "
                               "of host ranks")
        if not dist.is_initialized():
            raise RuntimeError("GridMesh needs an initialized torch.distributed group")
        if dist.get_world_size() != R * C:
            raise ValueError(f"a {R}x{C} grid needs {R * C} ranks, the group has "
                             f"{dist.get_world_size()}")
        self.R, self.C = R, C
        self.rank = dist.get_rank()
        self.my_r, self.my_c = divmod(self.rank, C)
        self.device = torch.device(device)
        self.backend = dist.get_backend()
        # Every rank creates every group, in one order (new_group is collective).
        rows = [dist.new_group([r * C + c for c in range(C)]) for r in range(R)]
        cols = [dist.new_group([r * C + c for r in range(R)]) for c in range(C)]
        self.row_group = rows[self.my_r]  # the C ranks of my grid row
        self.col_group = cols[self.my_c]  # the R ranks of my grid column
        self.host_staged = self.backend == "gloo" and self.device.type == "cuda"
        self.comm_bytes = 0
        self.staged_bytes = 0
        self._pinned: dict[int, torch.Tensor] = {}

    @property
    def signature(self) -> tuple:
        """What a plan key needs to know of the grid."""
        return ("grid", self.R, self.C, self.device.type)

    def rank_of(self, r: int, c: int) -> int:
        return r * self.C + c

    def group_size(self, group) -> int:
        if group is None:
            return self.R * self.C
        return self.C if group is self.row_group else self.R

    def broadcast(self, t: torch.Tensor, src: int, group=None) -> torch.Tensor:
        """t ← rank ``src``'s t over ``group`` (None = the whole grid), in
        place, bit for bit; t must be contiguous, of any dtype (its bytes
        travel as a ``uint8`` view).  A group of one rank moves nothing and
        counts nothing."""
        if self.group_size(group) == 1:
            return t
        if not t.is_contiguous():
            raise ValueError("broadcast needs a contiguous tensor")
        nbytes = t.numel() * t.element_size()
        self.comm_bytes += nbytes
        raw = t.reshape(-1).view(torch.uint8)
        if not self.host_staged:
            dist.broadcast(raw, src, group=group)
            return t
        host = self._pinned.get(nbytes)
        if host is None:
            host = self._pinned[nbytes] = torch.empty(nbytes, dtype=torch.uint8,
                                                      pin_memory=True)
        if self.rank == src:
            host.copy_(raw)
        dist.broadcast(host, src, group=group)
        if self.rank != src:
            raw.copy_(host)
        self.staged_bytes += nbytes
        return t


def _rank_main(fn, rank: int, R: int, C: int, device: str, backend: str, store: str,
               args: Sequence, timeout: float, results) -> None:
    """One spawned rank: join the group, run fn, report its result or its
    traceback."""
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(1)  # R·C ranks share the host's cores
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                world_size=R * C,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(GridMesh(R, C, device=dev), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:  # noqa: BLE001 — the rank's boundary: report, then exit
        results.put((rank, False, traceback.format_exc()))


def _grid_devices(R: int, C: int, device="cuda") -> tuple[list[str], str]:
    """(each rank's device, the backend) for an R×C grid on ``device``:
    one card a rank over nccl when there are R·C cards, else every rank on
    the same device over gloo."""
    dev = torch.device(device)
    world = R * C
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu'")
        if world > 1 and torch.cuda.device_count() >= world:
            return [f"cuda:{r}" for r in range(world)], "nccl"
        return [f"cuda:{dev.index or 0}"] * world, "gloo"
    if dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return ["cpu"] * world, "gloo"


def run_grid(fn: Callable[..., Any], R: int, C: int, *, device="cuda",
             args: Sequence = (), timeout: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` on every rank of an R×C grid of spawned
    processes and return the results in rank order.

    fn and args are pickled into each process (fn by its import path, so
    it is a module-level function).  Raises ``GridError`` with the failing
    rank's traceback when a rank raises, dies, or the grid has not finished
    within ``timeout`` seconds; the other ranks are then killed.
    """
    world = R * C
    devices, backend = _grid_devices(R, C, device)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="grid-") as tmp:
        store = os.path.join(tmp, "store")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, R, C, devices[r], backend, store, args,
                                   timeout, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        out: dict[int, Any] = {}
        deadline = time.monotonic() + timeout
        ok = False
        try:
            while len(out) < world:
                try:
                    rank, good, payload = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in out]
                    if dead:
                        raise GridError(f"rank {dead[0]} of the {R}x{C} grid died "
                                        f"(exit code {procs[dead[0]].exitcode})") from None
                    if time.monotonic() > deadline:
                        raise GridError(f"the {R}x{C} grid did not finish within "
                                        f"{timeout:.0f} s") from None
                    continue
                if not good:
                    raise GridError(f"rank {rank} of the {R}x{C} grid failed:\n{payload}")
                out[rank] = payload
            ok = True
        finally:
            for p in procs:
                p.join(timeout=30 if ok else 0)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
            results.close()
    return [out[r] for r in range(world)]
