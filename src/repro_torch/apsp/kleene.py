"""Recursive (R-Kleene) Floyd-Warshall: stream panels past device memory.

Counterpart of ``repro.apsp.kleene``.  Every other path needs the whole
padded matrix on the card.  This one cuts the pivot rounds into a binary
R-Kleene recursion (``plan.kleene_ranges``) whose leaves hold a *pivot
cross* on the device, the (m, P) column band and (P, m) row band of one
P-wide run of rounds, while every tile outside the cross stays in a
backing store and passes through the device once a leaf.

**Bitwise equal to the fused solve by construction** (the reference's
argument, ``repro/apsp/kleene.py:13-44``).  A leaf replays the fused
rounds on the cross: per round, ``fw_phase1`` closes the pivot tile,
``fw_phase2_row`` / ``fw_phase2_col`` the bands (the closed tile spliced
over each), and the closed bands, exactly the operands the fused round's
relax reads, are kept as the leaf's *factor panels*.  The round's phase 3
runs on the cross alone (two ``semiring_matmul`` calls, the bands their
own ``c``).  After the leaf, every outside tile takes all R deferred
phase-3 updates in ONE ``semiring_matmul`` of the P-deep factors: one
k-ascending chain an element, the same chain as R rounds of s-deep
relaxation in round order, for every semiring (plus_mul too).  The
(P, P) diagonal block lives in both resident bands, and both copies take
the same splices and relaxations, so the write-back order does not
matter.

**The port's buffers.**  A torch slice is a view, where a JAX slice is a
copy: ``get`` copies into memory of its own (the two bands of a leaf share
the diagonal block, and a view would let one band's relaxation feed the
other's).  The closed bands of each round are written straight into
preallocated (m, P) / (P, m) factor buffers (no list to concatenate), and
the sweep rotates three P x P tile buffers, so the card holds
``plan.recursive_hbm_resident_bytes`` (4·P·m + 3·P² words) plus one
s x s tile.

**Streaming.**  ``HostPanelStore`` keeps the padded matrix in pinned host
memory and moves each panel with one ``cudaMemcpy2DAsync`` a graph each
way (no host staging).  The executor puts copies to the card on one side
stream and copies from it on another, and orders them with events, never
a host synchronisation a tile: tile i + 1 comes in while tile i's product
runs and tile i - 1 goes back.  ``DevicePanelStore`` is the in-core twin
(device-to-device copies, zero transfer bytes).  On the CPU every copy is
a plain one and every kernel wrapper its plain version.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import itertools
import math
from pathlib import Path
from typing import Sequence

import torch

from repro_torch.apsp.plan import kleene_ranges
from repro_torch.core.semiring import MIN_PLUS, Semiring
from repro_torch.kernels.fw_phase1 import fw_phase1
from repro_torch.kernels.fw_phase2 import fw_phase2_col, fw_phase2_row
from repro_torch.kernels.minplus_matmul import _fit_block, check_variant, semiring_matmul
from repro_torch.utils.interop import host_tensor

_H2D, _D2H = 1, 2  # cudaMemcpyHostToDevice, cudaMemcpyDeviceToHost


def _device(device) -> torch.device:
    """A device with its index: "cuda" names the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@functools.cache
def _cudart() -> ctypes.CDLL:
    """The CUDA runtime torch loaded (found by its soname), else the
    toolkit's."""
    names = ["libcudart.so.12", "libcudart.so"]
    try:
        import nvidia.cuda_runtime as rt  # the wheel torch depends on

        names.append(str(Path(list(rt.__path__)[0]) / "lib" / "libcudart.so.12"))
    except ImportError:
        pass
    names.append("/usr/local/cuda/lib64/libcudart.so")
    for name in names:
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError:
            continue
    else:
        raise RuntimeError(f"no CUDA runtime library found (tried {names})")
    p, z = ctypes.c_void_p, ctypes.c_size_t
    lib.cudaMemcpy2DAsync.argtypes = [p, z, p, z, z, z, ctypes.c_int, p]
    lib.cudaMemcpy2DAsync.restype = ctypes.c_int
    return lib


def _copy_2d(dst: torch.Tensor, src: torch.Tensor, kind: int) -> None:
    """dst ← src, one ``cudaMemcpy2DAsync`` a (rows, cols) matrix of the
    batch, on the current stream of the card's side; both have unit
    column stride, and the host side is pinned."""
    if dst.shape != src.shape or dst.dtype != src.dtype:
        raise ValueError(f"copy {tuple(src.shape)} {src.dtype} → {tuple(dst.shape)} {dst.dtype}")
    card = dst.device if kind == _H2D else src.device
    isz = dst.element_size()
    h, w = dst.shape[-2:]
    for t in (dst, src):
        if t.stride(-1) != 1 and w > 1:
            raise ValueError(f"panel copies need unit column stride, got {t.stride()}")
    lib = _cudart()
    with torch.cuda.device(card):
        stream = torch.cuda.current_stream(card).cuda_stream
        for idx in itertools.product(*map(range, dst.shape[:-2])):
            d, s = dst[idx], src[idx]
            err = lib.cudaMemcpy2DAsync(d.data_ptr(), d.stride(0) * isz, s.data_ptr(),
                                        s.stride(0) * isz, w * isz, h, kind, stream)
            if err:
                raise RuntimeError(f"cudaMemcpy2DAsync of a ({h}, {w}) panel failed: "
                                   f"cudaError_t {err}")


# ---------------------------------------------------------------- stores
class PanelStore:
    """Backing store of a padded (m, m) or (B, m, m) matrix, addressed by
    2-D panel.

    ``get`` / ``put`` move rectangular (h, w) panels of the trailing two
    dims (a batch rides along whole) on the current stream; the executor
    orders them.  The byte counters are the measured side of the
    ``plan.recursive_transfer_bytes`` model; the in-core store keeps them
    at zero.
    """

    h2d_bytes: int = 0
    d2h_bytes: int = 0
    gets: int = 0
    puts: int = 0
    device: torch.device

    def __init__(self, w: torch.Tensor):
        if w.ndim not in (2, 3) or w.shape[-1] != w.shape[-2]:
            raise ValueError(f"store needs (m, m) or (B, m, m), got {tuple(w.shape)}")
        self.h2d_bytes = self.d2h_bytes = self.gets = self.puts = 0
        self._w = w

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self._w.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self._w.dtype

    def _panel(self, r0: int, c0: int, h: int, w: int) -> torch.Tensor:
        return self._w[..., r0:r0 + h, c0:c0 + w]

    def _out(self, out, h: int, w: int) -> torch.Tensor:
        if out is None:
            return torch.empty(self.shape[:-2] + (h, w), dtype=self.dtype, device=self.device)
        if tuple(out.shape) != self.shape[:-2] + (h, w) or out.dtype != self.dtype:
            raise ValueError(f"out {tuple(out.shape)} {out.dtype} does not fit a ({h}, {w}) "
                             f"panel of {self.shape} {self.dtype}")
        return out

    def _panel_bytes(self, h: int, w: int) -> int:
        return math.prod(self.shape[:-2]) * h * w * self._w.element_size()

    def get(self, r0: int, c0: int, h: int, w: int, out=None) -> torch.Tensor:
        """The (…, h, w) panel at (r0, c0), copied into ``out`` (memory of
        its own, never a view of the store) or into a new tensor on the
        store's device."""
        raise NotImplementedError

    def put(self, r0: int, c0: int, arr: torch.Tensor) -> None:
        """Write ``arr`` back at (r0, c0)."""
        raise NotImplementedError

    def result(self) -> torch.Tensor:
        """The whole (closed) matrix."""
        return self._w


class DevicePanelStore(PanelStore):
    """In-core store: the matrix stays one tensor on its device (its own
    copy: the caller's tensor is left as it was); panels are copies of its
    slices and write-backs copies into them.  Transfer counters stay zero.
    ``solve(method="recursive")`` takes it when the plan fits the budget."""

    def __init__(self, w):
        super().__init__((w if isinstance(w, torch.Tensor) else host_tensor(w)).clone())
        self.device = self._w.device

    def get(self, r0, c0, h, w, out=None):
        self.gets += 1
        return self._out(out, h, w).copy_(self._panel(r0, c0, h, w))

    def put(self, r0, c0, arr):
        self.puts += 1
        self._panel(r0, c0, arr.shape[-2], arr.shape[-1]).copy_(arr)


class HostPanelStore(PanelStore):
    """Out-of-core store: the matrix lives in host memory, panels cross on
    demand, and every byte each way is counted.

    ``device`` is where panels go: for a CUDA device the matrix is held in
    pinned (page-locked) memory, so that every copy is one asynchronous
    ``cudaMemcpy2DAsync`` a graph straight from or into the strided host
    panel; a failed pinning or copy raises.  For the CPU it is plain
    memory and a copy a ``copy_``; the counters are the same.  The matrix
    is the store's own copy of ``w`` (numpy array or tensor).  ``result``
    waits for the write-backs the store has queued, then returns the host
    tensor.
    """

    def __init__(self, w, *, device="cuda"):
        src = w.detach().cpu() if isinstance(w, torch.Tensor) else host_tensor(w)
        self.device = _device(device)
        pin = self.device.type == "cuda"
        host = torch.empty(src.shape, dtype=src.dtype, pin_memory=pin)
        if pin and not host.is_pinned():
            raise RuntimeError("could not pin the host store's memory")
        super().__init__(host.copy_(src))
        self._written: list = []  # an event after the last write-back of each stream

    def get(self, r0, c0, h, w, out=None):
        self.gets += 1
        self.h2d_bytes += self._panel_bytes(h, w)
        out = self._out(out, h, w)
        if out.device.type == "cuda":
            _copy_2d(out, self._panel(r0, c0, h, w), _H2D)
        else:
            out.copy_(self._panel(r0, c0, h, w))
        return out

    def put(self, r0, c0, arr):
        self.puts += 1
        self.d2h_bytes += self._panel_bytes(arr.shape[-2], arr.shape[-1])
        dst = self._panel(r0, c0, arr.shape[-2], arr.shape[-1])
        if arr.device.type != "cuda":
            dst.copy_(arr)
            return
        _copy_2d(dst, arr, _D2H)
        stream = torch.cuda.current_stream(arr.device)
        self._written = [e for e in self._written if e[0] != stream]
        self._written.append((stream, stream.record_event()))

    def result(self):
        for _, event in self._written:
            event.synchronize()
        self._written = []
        return self._w


# -------------------------------------------------------------- executor
def _on(stream):
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)


def _mark(stream):
    """An event recorded on a card stream now (None on the CPU)."""
    return None if stream is None else stream.record_event()


def _after(stream, *events) -> None:
    """Make a card stream wait for the events (no-op on the CPU)."""
    for e in events:
        if stream is not None and e is not None:
            stream.wait_event(e)


class _Lane:
    """One device of the schedule: its compute stream (the current one),
    a side stream for copies to the card (``up``) and one for copies from
    it (``down``); None for all three on the CPU."""

    def __init__(self, device: torch.device):
        self.device = device
        cuda = device.type == "cuda"
        self.main = torch.cuda.current_stream(device) if cuda else None
        self.up = torch.cuda.Stream(device) if cuda else None
        self.down = torch.cuda.Stream(device) if cuda else None


class KleeneExecutor:
    """The recursive schedule: leaves on the cross, a factor sweep outside.

    ``leaf_calls`` / ``sweep_calls`` count leaves and sweep products (the
    plan's ``leaf_calls`` / ``sweep_calls``), ``depth`` is the last run's
    recursion depth, and ``traces`` counts the schedules planned: one per
    matrix size, so a warm run at a planned size plans nothing (the
    reference's count of jit traces).  The executor holds no device memory
    between runs.

    ``devices``: the sweep's tiles go round-robin over them (the factors
    copied once a leaf to each), the leaf to the store's device; default
    the store's device alone.  Each entry is a lane with its own copy
    streams and tile ring: the first entry naming the store's device is
    the leaf's lane, and a device named again gets a lane of its own, so
    one card listed twice runs the cross-lane ordering.  A list of two or
    more cards has not been run: the machine this port was measured on has
    one.
    """

    def __init__(
        self,
        *,
        semiring: Semiring = MIN_PLUS,
        block_size: int,
        leaf: int,
        bk: int = 32,
        variant: str = "fori",
        devices: Sequence | None = None,
    ):
        if leaf % block_size:
            raise ValueError(
                f"leaf ({leaf}) must be a multiple of block_size "
                f"({block_size}) — leaves replay whole fused pivot rounds"
            )
        check_variant(variant)
        self.semiring = semiring
        self.s = block_size
        self.leaf = leaf
        self.bk = _fit_block(block_size, bk)
        self.variant = variant
        self.devices = [_device(d) for d in devices] if devices else None
        self.traces = 0
        self.leaf_calls = 0
        self.sweep_calls = 0
        self.depth = 0
        self._schedules: dict[int, tuple] = {}

    def _schedule(self, m: int) -> tuple:
        """(leaf ranges, depth, each leaf's outside tiles (r0, c0, h, w))
        for an m x m matrix, planned once per m."""
        sched = self._schedules.get(m)
        if sched is None:
            s = self.s
            ranges, depth = kleene_ranges(m // s, min(self.leaf, m) // s)
            tiles = [[((rlo * s, clo * s, (rhi - rlo) * s, (chi - clo) * s))
                      for i, (rlo, rhi) in enumerate(ranges) if i != p
                      for j, (clo, chi) in enumerate(ranges) if j != p]
                     for p in range(len(ranges))]
            sched = self._schedules[m] = (ranges, depth, tiles)
            self.traces += 1
        return sched

    def _leaf(self, colband, rowband, colf, rowf, diag, LO: int, R: int) -> None:
        """Close one pivot cross in place: R fused rounds on the resident
        bands colband (…, m, P) and rowband (…, P, m), the closed bands of
        round r written into colf[…, :, rs:rs+s] / rowf[…, rs:rs+s, :]
        (the factors the sweep replays).  Round by round the reference's
        ``_leaf_impl`` (``repro/apsp/kleene.py:260-327``): phases 1 / 2 on
        the kernels, the splices of ``:307-315``, then phase 3 on the cross
        as two products whose ``c`` is the band."""
        sr, s = self.semiring, self.s
        P = R * s
        for r in range(R):
            q, o = r * s, LO + r * s
            fw_phase1(rowband[..., q:q + s, o:o + s], semiring=sr, out=diag)
            row, col = rowf[..., q:q + s, :], colf[..., :, q:q + s]
            fw_phase2_row(diag, rowband[..., q:q + s, :], semiring=sr, out=row)
            row[..., :, o:o + s].copy_(diag)
            fw_phase2_col(diag, colband[..., :, q:q + s], semiring=sr, out=col)
            col[..., o:o + s, :].copy_(diag)
            col_cross, row_cross = col[..., LO:LO + P, :], row[..., :, LO:LO + P]
            rowband[..., q:q + s, :].copy_(row)
            rowband[..., :, o:o + s].copy_(col_cross)
            colband[..., :, q:q + s].copy_(col)
            colband[..., o:o + s, :].copy_(row_cross)
            semiring_matmul(col_cross, row, rowband, semiring=sr, out=rowband)
            semiring_matmul(col, row_cross, colband, semiring=sr, out=colband)

    def run(self, store: PanelStore) -> PanelStore:
        """Close the store's matrix in place (returns the store).

        Leaves run in round order (the depth-first traversal of the binary
        recursion), which keeps every element's ⊕-chain the fused
        schedule's.  The order of the copies, given that neither CUDA nor
        the caching allocator tracks host memory across streams:

        * At the start of a leaf, every lane's copies to the card wait
          for every write-back queued so far, on every lane (host memory
          read after written): the leaf's bands cross every tile, and any
          of its tiles may lie where the previous leaf's bands or another
          lane's tiles were written.  That wait also frees the band
          buffers: their last readers were the previous leaf's band
          write-backs.
        * A tile's get into ring slot k also waits for the write-back of
          the tile that last held slot k (its last reader).  The tiles of
          one leaf are disjoint and lie outside its cross, so no write-back
          of the same leaf touches what another of its gets reads.
        * A product waits for its tile's get; a write-back for its
          product.  So a region is never written back before the get that
          read it has landed (host memory written after read).
        * At the end every compute stream waits for the last write-backs,
          so the buffers freed here are free in stream order and a device
          store's matrix is final; a host store's ``result`` waits on the
          host.
        """
        m, s = store.shape[-1], self.s
        if m % s:
            raise ValueError(f"matrix size {m} not a multiple of s={s}")
        ranges, self.depth, tiles_of = self._schedule(m)
        home = _Lane(store.device)
        lanes: list[_Lane] = []
        for d in self.devices or [store.device]:
            lanes.append(home if d == store.device and home not in lanes else _Lane(d))
        every = lanes if home in lanes else lanes + [home]
        if any(lane.device.type != store.device.type for lane in lanes):
            raise ValueError(f"devices {self.devices} are not of the store's type "
                             f"({store.device.type})")
        lead, dtype = store.shape[:-2], store.dtype
        Pm = max(hi - lo for lo, hi in ranges) * s
        new = functools.partial(torch.empty, dtype=dtype)
        colband, colf = (new(lead + (m, Pm), device=home.device) for _ in "ab")
        rowband, rowf = (new(lead + (Pm, m), device=home.device) for _ in "ab")
        diag = new(lead + (s, s), device=home.device)
        ring = {id(lane): [new(lead + (Pm, Pm), device=lane.device) for _ in range(3)]
                for lane in lanes}
        freed = {id(lane): [None] * 3 for lane in lanes}
        factors = {id(lane): (colf, rowf) if lane is home else
                   (new(lead + (m, Pm), device=lane.device),
                    new(lead + (Pm, m), device=lane.device)) for lane in lanes}
        written: dict[int, object] = {}  # the last write-back event of each down stream
        copied = []  # the factor copies of the last leaf, read from colf / rowf

        def slot(i):
            lane = lanes[i % len(lanes)]
            return lane, (i // len(lanes)) % 3

        def fetch(i, tile):
            lane, k = slot(i)
            r0, c0, h, w = tile
            buf = ring[id(lane)][k][..., :h, :w]
            with _on(lane.up):
                _after(lane.up, freed[id(lane)][k])
                store.get(r0, c0, h, w, out=buf)
                return buf, _mark(lane.up)

        for p, (lo, hi) in enumerate(ranges):
            LO, P = lo * s, (hi - lo) * s
            cb, rb = colband[..., :, :P], rowband[..., :P, :]
            cf, rf = colf[..., :, :P], rowf[..., :P, :]
            for lane in every:
                _after(lane.up, *written.values())
            with _on(home.up):
                store.get(0, LO, m, P, out=cb)
                store.get(LO, 0, P, m, out=rb)
                bands_in = _mark(home.up)
            _after(home.main, bands_in, *copied)
            self._leaf(cb, rb, cf, rf, diag, LO, hi - lo)
            self.leaf_calls += 1
            leaf_done = _mark(home.main)
            with _on(home.down):
                _after(home.down, leaf_done)
                store.put(0, LO, cb)
                store.put(LO, 0, rb)
                written[id(home.down)] = _mark(home.down)
            tiles = tiles_of[p]
            if not tiles:
                continue
            copied = []
            for lane in lanes:
                if lane is not home:
                    fc, fr = factors[id(lane)]
                    with _on(lane.main):
                        _after(lane.main, leaf_done)
                        fc[..., :, :P].copy_(cf)
                        fr[..., :P, :].copy_(rf)
                        copied.append(_mark(lane.main))
            nxt = fetch(0, tiles[0])
            for i, (r0, c0, h, w) in enumerate(tiles):
                (buf, landed), lane = nxt, slot(i)[0]
                if i + 1 < len(tiles):
                    nxt = fetch(i + 1, tiles[i + 1])
                fc, fr = factors[id(lane)]
                _after(lane.main, landed)
                with _on(lane.main):
                    semiring_matmul(fc[..., r0:r0 + h, :P], fr[..., :P, c0:c0 + w], buf,
                                    semiring=self.semiring, out=buf)
                    done = _mark(lane.main)
                self.sweep_calls += 1
                with _on(lane.down):
                    _after(lane.down, done)
                    store.put(r0, c0, buf)
                    freed[id(lane)][slot(i)[1]] = written[id(lane.down)] = _mark(lane.down)
        for lane in every:
            _after(lane.main, *written.values())
        return store


# --------------------------------------------------------------- frontend
def fw_kleene(
    w,
    *,
    semiring: Semiring = MIN_PLUS,
    block_size: int,
    leaf: int | None = None,
    bk: int = 32,
    variant: str = "fori",
    out_of_core: bool = False,
    devices: Sequence | None = None,
    store: PanelStore | None = None,
    device="cuda",
) -> torch.Tensor:
    """Recursive-schedule closure of a padded (m, m) or (B, m, m) matrix.

    m must be a multiple of ``block_size`` (``apsp.solve`` owns padding).
    ``leaf`` defaults to min(m, 4·block_size).  ``out_of_core=True`` keeps
    the matrix in a ``HostPanelStore`` (pinned host memory, panels streamed
    to ``device``) and returns the closed HOST tensor, since the matrix is
    not meant to fit the card; otherwise a ``DevicePanelStore`` on
    ``device`` and a device tensor.  Pass an explicit ``store`` to keep it
    (its byte counters are the measured side of
    ``plan.recursive_transfer_bytes``).  Bitwise equal to
    ``core.staged.fw_staged`` at the same block size on every storage.
    ``device``: "cuda" (the kernels) or "cpu" (their plain versions).
    """
    m = w.shape[-1]
    if leaf is None:
        leaf = min(m, 4 * block_size)
    ex = KleeneExecutor(semiring=semiring, block_size=block_size, leaf=min(leaf, m), bk=bk,
                        variant=variant, devices=devices)
    if store is None:
        if out_of_core:
            store = HostPanelStore(w, device=device)
        else:
            t = w if isinstance(w, torch.Tensor) else host_tensor(w)
            store = DevicePanelStore(t.to(device))
    ex.run(store)
    return store.result()
