"""Time the fused round's launches and the solves built on them, on the card.

    PYTHONPATH=src python src/repro_torch/launch/round_bench.py [--n 8192]
        [--label L] [--build-only]
        [--sweep | --phases | --succ | --sweep-succ | --sweep-relax | --repair]

Prints one JSON line with the card's name and power limit: each
``fw_round`` launch kind (diag, bands, relax) alone at (n, n) in min-plus
f32, pivot round n/s/2 (median of 11 between CUDA events); the diag and
bands launches in every storage (f32, int16, bf16, f16 min-plus, packed
or_and words) at (n, n), at (n/2, n/2) and on the 2×2 grid's bordered
rank block (s + n/2, s + n/2) with no owner echo, each first held by bits
against its plain phase (``chains_*_ok``), timed between CUDA events and
as device time (``*_dev_ms``, ``torch.profiler``: a launch this short on
an idle stream otherwise waits for its wrapper's host work); the relax in
plus_mul beside ``torch.addmm`` and in min-plus beside ``semiring_matmul``
on the same (n,s)·(s,n) + C product; the int16 and bf16 relax; the
successor relax at (n/2, n/2) in f32 and bf16; and, by host clock around
work that ends in a synchronize (median of 3 after a warm-up), ``solve`` at
n in f32, int16, bf16 and f16 and of 32 packed graphs, ``solve(successors=True)``
at n/2 and ``fw_staged(fused=False)`` at n, on the seeded density-0.5
digraph.  Each timed relax is first held by bits against its plain phase
(``*_ok``).

``--sweep`` times the restricted sweep of ``ApspEngine.repair_del``
instead: its diag and panels launches at (n, n), pivot round n/s/2, strips
of 8 and 64 rows, in f32, int16, bf16 and f16 min-plus and packed or_and
words, each first held by bits against its plain phase (``sweep_*_ok``),
then timed between CUDA events and as device time (``*_dev_ms``), and the
f32 relax beside them; then, by host clock (median of 3 after a warm-up),
``fw_repair_del_sweep`` of 8 rows of the f32 graph (``*_host_ms``: until
the call returns, its launches queued; ``*_dev_ms``: device time) and
``repair_del`` of 1 and of 16 on-path deletions of the seeded integer graph
at n (the deletions ``chip_smoke.py`` takes), each first checked by bits
against a re-solve of the updated graph, and that re-solve.

``--phases`` times the 4-dispatch round's phase kernels instead: the
closure (``fw_phase1``), row band and col band launches at (n, n), pivot
round n/s/2, in f32, int16, bf16 and f16 min-plus and packed or_and words,
each first held by bits against its plain phase (``phases_*_ok``), then
timed between CUDA events and as device time (``*_dev_ms``); then, by host
clock (median of 3 after a warm-up), ``fw_staged(fused=False)`` and the
fused ``fw_staged`` at n in each of those storages.

``--succ`` times the successor round's chains instead: its diag and bands
launches at (n/2, n/2) and (n, n), pivot round n/s/2, in f32, bf16 and f16
distances, each first held by bits, distances and next hops, against its
plain phase (``succ_chains_*_ok``), then timed between CUDA events and as
device time (``*_dev_ms``); then, by host clock (median of 3 after a
warm-up), ``solve(successors=True)`` at n/2 in each of those storages.

``--sweep-succ`` times the successor sweep of ``ApspEngine.repair_del``
instead: its diag and panels launches at (n/2, n/2) and (n, n), pivot round
n/s/2, strips of 8 and 64 rows, in f32, bf16 and f16 distances, each first
held by bits, distances and next hops, against its plain phase
(``succ_sweep_*_ok``), then timed between CUDA events and as device time
(``*_dev_ms``); then ``repair_del`` with next hops of the 16 on-path edges
of ``chip_smoke.py``'s successor repair_del path at n/2 (the tie-free
graph, the deletions ranked by the pairs they affect), checked by bits,
distances and next hops, against a re-solve, and timed beside it by host
clock (median of 3 after a warm-up), with its marking and sweep apart and
the sweep's device time by launch kind (``torch.profiler``).

``--sweep-relax`` times the restricted sweep's relax launch (and its
successor twin) instead, at (m, m) for m = n/2 and n, pivot round m/s/2,
on the strip that round's diag and panels launches leave: the plain relax
in f32 at strips of 8, 32, 64, 128, 512 and m rows, in int16, bf16 and f16
min-plus, packed or_and words and the int32 or_and carrier at 8 and m;
the successor relax in f32, bf16 and f16 at 8, 32, 64, 128, 512 and m; each
first held by bits against its plain phase (``relax_*_ok``), then timed
between CUDA events (``*_ms``, median of 11) and as device time
(``*_dev_ms``, ``torch.profiler``, mean of 20).  Where the tree has the
relax's tile heights (``fw_repair_del.relax_height``), the f32 relax and
the f32 and bf16 successor relax at every strip are also timed
on every tile height (``height_*_dev_ms``; each result held by bits).
Then, by host clock (median of 3 after a warm-up), ``repair_del`` as
``--sweep`` and ``--sweep-succ`` run it (f32 at n, E = 1 and 16; with next
hops in f32 at n/2, E = 16) and the bf16 and f16 successor engine path of
``chip_smoke.py`` at n/2 (integer weights in [1, 16], density 0.02, 16
on-path deletions: a strip of n/2 rows), each checked against a re-solve,
with the sweep's device time by launch kind.

``--repair`` times the rank-E repair instead (``repair_cases``): its stage
and apply launches alone at (n, n) in every storage, E = 1, 16, 32 and 64
(as far as one of the tree's launch pairs carries), ``fw_repair`` of 40,
48 and 64 edges in every storage, whole and as a repair of 32 edges and
one of the rest, the f32 plus_mul apply beside ``torch.addmm(d, scalars,
staged)``, the successor stage and apply at (n/2, n/2) in f32, bf16 and
f16, each first held by bits against its plain twins (``repair_*_ok``),
then timed as device time (``*_dev_ms``); ``ApspEngine.repair`` of 16
improvements at n (== a re-solve first) by host clock (median of 5 medians of 3) and
as device time; and a f32
``RoutingEngine`` repair refresh with next hops at n/2 and an int16 one at
n, each under the profiler (wall, kernels by name; table == re-solve
first).  In a tree without ``fw_repair.repair_buffers`` the stage's staged
rows are its buffer.

``--build-only`` builds the libraries those calls load and prints one JSON
line of their build seconds and the registers and spills of each relax,
successor relax, diag, bands (with ``--sweep``: panels; with ``--phases``:
closure and band; with ``--succ``: the successor diag, bands and relax
alone; with ``--sweep-succ``: the successor sweep's diag, panels and relax
alone; with ``--repair``: the stage and apply) and vector f32
``matmul_kernel`` instantiation
(``_build.kernel_infos``) and, in each f32 relax, diag and bands (panels;
closure and band) kernel's SASS (``cuobjdump -sass`` of the f32 round
(sweep, phase) library), the count of the opcodes a relaxation is made
of, of the shared-memory, shuffle and barrier instructions and of the
spill instructions, then exits: run it for every tree at once, then the
timings in turns.

Run it with PYTHONPATH pointing at two trees, in turns inside one chip
call (parent, change, change, parent), to compare them on one card.  Only
the API both trees share is used (``fw_round_phase``,
``fw_round_with_successors_phase``, ``fw_round_bordered_phase``, the band
buffers, ``semiring_matmul``, ``solve``, ``fw_staged``; ``sweep_buffers``,
``sweep_phase``, ``sweep_succ_phase``, ``ApspEngine.repair_del``; ``fw_phase1``,
``fw_phase2_row`` / ``fw_phase2_col`` with ``out``).
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path


def event_ms(fn, reps: int = 11) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        fn()
        ev[1].record()
        ev[1].synchronize()
        times.append(ev[0].elapsed_time(ev[1]))
    return statistics.median(times)


def device_ms(fn, reps: int = 20) -> float:
    """Device ms a call: the time of its kernels in a ``torch.profiler``
    trace of reps calls (nan where the profiler records no device time).
    Unlike ``event_ms`` it leaves out the wrapper's host work before a
    launch, which a short launch on an idle stream waits for."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
             for ev in prof.key_averages())
    return us / reps / 1e3 if us else float("nan")


def host_ms(fn) -> float:
    import torch

    fn()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def queue_ms(fn) -> float:
    """Host ms from the call until it returns, the device idle at the call
    (median of 3): the host work of a sequence of launches that fits the
    launch queue, which the device does not hold back."""
    import torch

    fn()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


SASS_OPS = ("FADD", "FFMA", "FMNMX", "FSETP", "FSEL", "SEL", "LOP3", "PRMT", "LDS", "STS",
            "SHFL", "BAR", "STL", "LDL")
KERNELS = ("relax_kernel", "diag_kernel", "bands_kernel", "panels_kernel", "closure_kernel",
           "band_kernel", "stage_kernel", "apply_kernel")


def sass_counts(lib_path) -> dict:
    """Per relax, diag and bands kernel (mangled name) of a library: how many
    of its SASS instructions have each opcode of ``SASS_OPS`` (modifiers
    dropped)."""
    import re

    text = subprocess.run([str(Path(_nvcc_dir()) / "cuobjdump"), "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=600).stdout
    counts, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if any(k in m.group(1) for k in KERNELS) else None
            if name:
                counts[name] = dict.fromkeys(SASS_OPS, 0)
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)", line)
        if name and m and m.group(1) in counts[name]:
            counts[name][m.group(1)] += 1
    return counts


def _nvcc_dir() -> str:
    from repro_torch.kernels import _build

    return str(Path(_build._nvcc()).parent)


def build_report(label: str, mode: str = "") -> int:
    import repro_torch
    from repro_torch.kernels import _build

    out = dict(label=label, package=repro_torch.__file__, seconds={}, kernels=[])
    # The libraries reported, and those the timings also load (built here,
    # not reported): the engine's solve, the 4-dispatch matmul and fused round.
    names, extra = {
        "sweep": (("fw_repair_del", "fw_repair_del_lowered"), ("fw_round",)),
        "phases": (("fw_phase", "fw_phase_lowered"),
                   ("minplus_matmul", "minplus_matmul_lowered", "fw_round", "fw_round_lowered")),
        "succ": (("fw_round", "fw_round_lowered"), ()),
        "sweep_succ": (("fw_repair_del", "fw_repair_del_lowered"), ("fw_round",)),
        "sweep_relax": (("fw_repair_del", "fw_repair_del_lowered"),
                        ("fw_round", "fw_round_lowered")),
        "repair": (("fw_repair", "fw_repair_lowered"), ("fw_round", "fw_round_lowered")),
    }.get(mode, (("fw_round", "fw_round_lowered", "minplus_matmul", "fw_phase"), ()))
    only_succ = mode in ("succ", "sweep_succ")

    def shown(name: str) -> bool:
        if only_succ:
            return "succ_" in name
        return (any(x in name for x in KERNELS)
                or ("matmul_kernel" in name and "float, true" in name))

    for built in _build.build_all(names + extra):
        if built.name not in names:
            continue
        out["seconds"][built.name] = built.seconds
        out["kernels"] += [
            dict(name=k.name, registers=k.registers, spill_stores=k.spill_stores,
                 spill_loads=k.spill_loads)
            for k in _build.kernel_infos(built) if shown(k.name)]
        if built.name == names[0] and built.seconds:  # built here: its SASS is fresh
            out["sass"] = {k: v for k, v in sass_counts(built.path).items()
                           if not only_succ or "succ_" in k}
    print(json.dumps(out))
    return 0


def storages(w) -> dict:
    """key → make(x) = (x in the storage, its semiring): f32, int16, bf16
    and f16 min-plus of x, and random packed or_and words of x's shape."""
    import torch

    from repro_torch.apsp import api
    from repro_torch.core.semiring import MIN_PLUS, MIN_PLUS_I16, OR_AND_PACKED

    g = torch.Generator(device=w.device).manual_seed(3)
    return {
        "f32": lambda x: (x, MIN_PLUS),
        "int16": lambda x: (api._coerce(x, MIN_PLUS_I16, None, x.device), MIN_PLUS_I16),
        "bf16": lambda x: (x.to(torch.bfloat16), MIN_PLUS),
        "f16": lambda x: (x.to(torch.float16), MIN_PLUS),
        "packed": lambda x: (torch.randint(-(1 << 31), 1 << 31, x.shape, generator=g,
                                           device=x.device, dtype=torch.int32), OR_AND_PACKED),
    }


def chain_cases(w, n: int, s: int) -> dict:
    """The diag and bands launches in every storage at (n, n), (n/2, n/2)
    and the 2×2 grid's bordered rank block (s + n/2, s + n/2): each held by
    bits against its plain phase, then timed."""
    import torch

    from repro_torch.kernels import fw_round as fr
    from repro_torch.kernels import ref
    from repro_torch.utils.bits import bits_equal

    out = {}
    half = n // 2
    geoms = {"n": (w, n // s // 2, False), "n2": (w[:half, :half].contiguous(), half // s // 2,
                                                 False),
             "bordered": (w[:s + half, :s + half].contiguous(), 0, True)}
    for key, make in storages(w).items():
        for gname, (base, b, bordered) in geoms.items():
            x, sr = make(base)
            o = slice(b * s, (b + 1) * s)
            kw = dict(block_size=s, semiring=sr)
            if bordered:
                bands = fr.bordered_round_buffers(x, s)
                launch = lambda p: fr.fw_round_bordered_phase(p, x, -1, -1, bands, **kw)  # noqa: E731
            else:
                bands = fr.round_buffers(x, s)
                launch = lambda p: fr.fw_round_phase(p, x, b, bands, **kw)  # noqa: E731
            launch("diag")
            launch("bands")
            diag = ref.close_diag(x[o, o], sr)
            row, col = (ref.close_bordered_bands(x, diag, -1, -1, sr) if bordered
                        else ref.close_bands(x, diag, b, sr))
            torch.cuda.synchronize()
            out[f"chains_{key}_{gname}_ok"] = bits_equal(bands[0][0], row) and bits_equal(
                bands[1][0], col)
            for phase in ("diag", "bands"):
                out[f"{phase}_{key}_{gname}_ms"] = event_ms(lambda: launch(phase))
                out[f"{phase}_{key}_{gname}_dev_ms"] = device_ms(lambda: launch(phase))
            del bands, row, col, diag, x
    return out


def phase_cases(w, n: int, s: int) -> dict:
    """The 4-dispatch closure, row band and col band launches in every
    storage at (n, n), pivot round n/s/2: each held by bits against its
    plain phase, then timed; then ``fw_staged(fused=False)`` and the fused
    ``fw_staged`` at n in that storage, by host clock."""
    import torch

    from repro_torch.core.staged import fw_staged
    from repro_torch.kernels import fw_phase1 as fph
    from repro_torch.kernels import fw_phase2
    from repro_torch.kernels import ref
    from repro_torch.utils.bits import bits_equal

    out = {}
    o = slice(n // s // 2 * s, (n // s // 2 + 1) * s)
    for key, make in storages(w).items():
        x, sr = make(w)
        tile, row, col = x[o, o], x[o, :], x[:, o]
        diag, rb, cb = (x.new_empty(shape) for shape in ((s, s), (s, n), (n, s)))
        launches = {
            "closure": lambda: fph.fw_phase1(tile, semiring=sr, out=diag),
            "row": lambda: fw_phase2.fw_phase2_row(diag, row, semiring=sr, out=rb),
            "col": lambda: fw_phase2.fw_phase2_col(diag, col, semiring=sr, out=cb),
        }
        for launch in launches.values():
            launch()
        torch.cuda.synchronize()
        out[f"phases_{key}_ok"] = (
            bits_equal(diag, ref.fw_phase1_ref(tile, semiring=sr))
            and bits_equal(rb, ref.fw_phase2_row_ref(diag, row, semiring=sr))
            and bits_equal(cb, ref.fw_phase2_col_ref(diag, col, semiring=sr)))
        for phase, launch in launches.items():
            out[f"{phase}_{key}_ms"] = event_ms(launch)
            out[f"{phase}_{key}_dev_ms"] = device_ms(launch)
        del diag, rb, cb
        out[f"four_dispatch_{key}_ms"] = host_ms(
            lambda: fw_staged(x, block_size=s, semiring=sr, fused=False))
        out[f"fused_{key}_ms"] = host_ms(lambda: fw_staged(x, block_size=s, semiring=sr))
        del x
    return out


def succ_chain_cases(n: int, s: int) -> dict:
    """The successor diag and bands launches in f32, bf16 and f16 at (n/2,
    n/2) and (n, n), pivot round n/s/2: each held by bits, distances and next
    hops, against its plain phase, then timed; then ``solve(successors=True)``
    at n/2 in each storage, by host clock."""
    import torch

    from repro_torch.apsp import solve
    from repro_torch.core.graph import random_digraph
    from repro_torch.core.paths import _init_successors
    from repro_torch.kernels import fw_round as fr
    from repro_torch.kernels import ref
    from repro_torch.utils.bits import bits_equal

    out = {}
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
    for m in (n // 2, n):
        w = torch.from_numpy(random_digraph(m, density=0.5, seed=2)).cuda()
        b = m // s // 2
        o = slice(b * s, (b + 1) * s)
        for key, dt in dtypes.items():
            x = w.to(dt)
            succ = _init_successors(x).contiguous()
            bands = fr.succ_round_buffers(x, s)
            launch = lambda p: fr.fw_round_with_successors_phase(  # noqa: E731
                p, x, succ, b, bands, block_size=s)
            launch("diag")
            launch("bands")
            diag, dsucc = ref.close_diag_succ(x[o, o], succ[o, o])
            want = ref.close_bands_succ(x, succ, diag, dsucc, b)
            rw, cw, rs, cs = (t[0] for t in bands)
            torch.cuda.synchronize()
            out[f"succ_chains_{key}_n{m}_ok"] = all(
                bits_equal(g, v) for g, v in zip((rw, rs, cw, cs), want))
            for phase in ("diag", "bands"):
                out[f"succ_{phase}_{key}_n{m}_ms"] = event_ms(lambda: launch(phase))
                out[f"succ_{phase}_{key}_n{m}_dev_ms"] = device_ms(lambda: launch(phase))
            del bands, want, diag, dsucc, rw, cw, rs, cs, succ, x
        if m == n // 2:
            for key, dt in dtypes.items():
                x = w.to(dt)
                out[f"succ_solve_{key}_ms"] = host_ms(lambda: solve(x, successors=True))
        del w
    return out


def device_by_kind(fn) -> dict:
    """Device ms of one call of fn by kernel kind (diag, panels, relax,
    other): the kernels' times in a ``torch.profiler`` trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per = dict.fromkeys(("diag", "panels", "relax", "other"), 0.0)
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        kind = next((k for k in ("diag", "panels", "relax") if f"{k}_kernel" in ev.key), "other")
        per[kind] += us / 1e3
    return per


def sweep_rows(n: int, a: int, seed: int):
    """a distinct rows, sorted (a a multiple of 8: no padding)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n, a, replace=False)).astype(np.int32)


def sweep_cases(w, n: int, s: int) -> dict:
    """The sweep's diag and panels launches in every storage at (n, n),
    round n/s/2, strips of 8 and 64 rows: each held by bits against its
    plain phase, then timed; the f32 relax at a = 8 beside them."""
    import torch

    from repro_torch.kernels import fw_repair_del as fd
    from repro_torch.kernels import ref
    from repro_torch.utils.bits import bits_equal

    out = {}
    b = n // s // 2
    o = slice(b * s, (b + 1) * s)
    for key, make in storages(w).items():
        x, sr = make(w)
        for a in (8, 64):
            sw = fd.sweep_buffers(x, sweep_rows(n, a, seed=a), block_size=s)
            launch = lambda p: fd.sweep_phase(p, sw, b, semiring=sr)  # noqa: E731
            launch("diag")
            launch("panels")
            diag = ref.sweep_diag_ref(x, sw.strip, sw.rows, b, block_size=s, semiring=sr)
            band, acol = ref.sweep_panels_ref(x, sw.strip, sw.rows, diag, b, semiring=sr)
            torch.cuda.synchronize()
            out[f"sweep_{key}_a{a}_ok"] = (bits_equal(sw.band[:, o], diag)
                                           and bits_equal(sw.band, band)
                                           and bits_equal(sw.acol, acol))
            phases = ("diag", "panels", "relax") if key == "f32" and a == 8 else ("diag", "panels")
            for phase in phases:
                out[f"sweep_{phase}_{key}_a{a}_ms"] = event_ms(lambda: launch(phase))
                out[f"sweep_{phase}_{key}_a{a}_dev_ms"] = device_ms(lambda: launch(phase))
            del sw, band, acol, diag
        del x
    rows = sweep_rows(n, 8, seed=8)
    sweep = lambda: fd.fw_repair_del_sweep(w, rows, block_size=s)  # noqa: E731
    out["sweep_f32_a8_ms"] = host_ms(sweep)
    out["sweep_f32_a8_host_ms"] = queue_ms(sweep)
    out["sweep_f32_a8_dev_ms"] = device_ms(sweep, reps=3)
    return out


def succ_sweep_cases(n: int, s: int) -> dict:
    """The successor sweep's diag and panels launches in f32, bf16 and f16
    at (n/2, n/2) and (n, n), round m/s/2, strips of 8 and 64 rows: each
    held by bits, distances and next hops, against its plain phase, then
    timed."""
    import torch

    from repro_torch.core.graph import random_digraph
    from repro_torch.core.paths import _init_successors
    from repro_torch.kernels import fw_repair_del as fd
    from repro_torch.kernels import ref
    from repro_torch.utils.bits import bits_equal

    out = {}
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
    for m in (n // 2, n):
        w = torch.from_numpy(random_digraph(m, density=0.5, seed=2)).cuda()
        b = m // s // 2
        o = slice(b * s, (b + 1) * s)
        for key, dt in dtypes.items():
            x = w.to(dt)
            succ = _init_successors(x).contiguous()
            for a in (8, 64):
                sw = fd.sweep_buffers(x, sweep_rows(m, a, seed=a), block_size=s, s_init=succ)
                launch = lambda p: fd.sweep_succ_phase(p, sw, b)  # noqa: E731
                launch("diag")
                launch("panels")
                diag, dsucc = ref.sweep_diag_succ_ref(x, succ, sw.strip, sw.strip_s, sw.rows, b,
                                                      block_size=s)
                want = ref.sweep_panels_succ_ref(x, succ, sw.strip, sw.strip_s, sw.rows, diag,
                                                 dsucc, b)
                torch.cuda.synchronize()
                out[f"succ_sweep_{key}_n{m}_a{a}_ok"] = (
                    bits_equal(sw.band[:, o], diag) and bits_equal(sw.band_s[:, o], dsucc)
                    and all(bits_equal(g, v) for g, v in zip(
                        (sw.band, sw.band_s, sw.acol, sw.acol_s), want)))
                for phase in ("diag", "panels"):
                    tag = f"{phase}_{key}_n{m}_a{a}"
                    out[f"succ_sweep_{tag}_ms"] = event_ms(lambda: launch(phase))
                    out[f"succ_sweep_{tag}_dev_ms"] = device_ms(lambda: launch(phase))
                del sw, want, diag, dsucc
            del x, succ
        del w
    return out


def relax_storages(w) -> dict:
    """``storages`` and the int32 carrier of an integer or_and storage."""
    import torch

    from repro_torch.core.semiring import OR_AND

    out = storages(w)
    g = torch.Generator(device=w.device).manual_seed(4)
    out["i32"] = lambda x: (torch.randint(0, 2, x.shape, generator=g, device=x.device,
                                          dtype=torch.int32), OR_AND)
    return out


def relax_case(out: dict, key: str, x, a: int, s: int, *, sr=None, succ=None,
               heights: bool = False) -> None:
    """One strip of a rows of x in round m/s/2 (``sweep_rows``): diag and
    panels, then the relax launch (successor relax where succ is given)
    held by bits against its plain phase and timed; heights: also on every
    tile height, each result held by bits."""
    import torch

    from repro_torch.kernels import fw_repair_del as fd
    from repro_torch.kernels import ref
    from repro_torch.utils.bits import bits_equal

    m = x.shape[-1]
    b = m // s // 2
    sw = fd.sweep_buffers(x, sweep_rows(m, a, seed=a), block_size=s, s_init=succ)
    if succ is None:
        launch = lambda p, **kw: fd.sweep_phase(p, sw, b, semiring=sr, **kw)  # noqa: E731
        bufs = (sw.strip,)
        plain = lambda st: (ref.sweep_relax_ref(*st, sw.rows, sw.band, sw.acol, b,  # noqa: E731
                                                semiring=sr),)
    else:
        launch = lambda p, **kw: fd.sweep_succ_phase(p, sw, b, **kw)  # noqa: E731
        bufs = (sw.strip, sw.strip_s)
        plain = lambda st: ref.sweep_relax_succ_ref(  # noqa: E731
            *st, sw.rows, sw.band, sw.band_s, sw.acol, sw.acol_s, b)
    launch("diag")
    launch("panels")
    start = tuple(t.clone() for t in bufs)
    want = plain(start)
    launch("relax")
    torch.cuda.synchronize()
    tag = f"{key}_n{m}_a{a}"
    out[f"relax_{tag}_ok"] = all(bits_equal(g, v) for g, v in zip(bufs, want))
    out[f"relax_{tag}_ms"] = event_ms(lambda: launch("relax"))
    out[f"relax_{tag}_dev_ms"] = device_ms(lambda: launch("relax"))
    if heights:
        out[f"relax_{tag}_height"] = fd.relax_height(a, m)
        for h in (*fd.SHORT_HEIGHTS, fd.LONG_HEIGHT):
            for t, t0 in zip(bufs, start):
                t.copy_(t0)
            launch("relax", height=h)
            torch.cuda.synchronize()
            out[f"height_{tag}_h{h}_ok"] = all(bits_equal(g, v) for g, v in zip(bufs, want))
            out[f"height_{tag}_h{h}_dev_ms"] = device_ms(lambda: launch("relax", height=h))


def sweep_relax_cases(n: int, s: int) -> dict:
    """The relax launches of ``--sweep-relax`` at (n/2, n/2) and (n, n)."""
    import torch

    from repro_torch.core.graph import random_digraph
    from repro_torch.core.paths import _init_successors
    from repro_torch.kernels import fw_repair_del as fd

    out = {}
    heights = hasattr(fd, "relax_height")
    for m in (n // 2, n):
        w = torch.from_numpy(random_digraph(m, density=0.5, seed=0)).cuda()
        for key, make in relax_storages(w).items():
            x, sr = make(w)
            for a in ((8, 32, 64, 128, 512, m) if key == "f32" else (8, m)):
                relax_case(out, key, x, a, s, sr=sr, heights=heights and key == "f32")
            del x
        for key, dt in (("succ_f32", torch.float32), ("succ_bf16", torch.bfloat16),
                        ("succ_f16", torch.float16)):
            x = w.to(dt)
            succ = _init_successors(x).contiguous()
            for a in (8, 32, 64, 128, 512, m):
                relax_case(out, key, x, a, s, succ=succ,
                           heights=heights and key != "succ_f16")
            del x, succ
        del w
    return out


def integer_graph(n: int, seed: int, *, hi: int, density: float):
    """Integer weights in [1, hi] at the given density, 0 diagonal: every
    path sum stays an integer below 2^24, exact in f32 (``chip_smoke.py``'s
    graphs)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    w = rng.integers(1, hi + 1, (n, n)).astype(np.float32)
    w[rng.uniform(size=(n, n)) >= density] = np.inf
    np.fill_diagonal(w, 0.0)
    return w


def on_path_deletions(w, dist, count: int, seed: int):
    """(deletions, updated weights): ``count`` edges on shortest paths (w ==
    dist, not 0 and off the diagonal), drawn with a seeded rng, each removed
    (set to the ⊕-identity: inf for float weights, 0 for an integer or_and
    storage)."""
    import numpy as np
    import torch

    d0 = torch.as_tensor(dist).cpu().to(torch.float64).numpy()
    w0 = w.astype(np.float64)
    on = np.argwhere((w0 == d0) & (w0 != 0) & np.isfinite(w0) & ~np.eye(w.shape[-1], dtype=bool))
    if len(on) < count:
        raise RuntimeError("too few on-path edges to delete")
    rng = np.random.default_rng(seed)
    w1, dels = w.copy(), []
    for u, v in on[rng.choice(len(on), size=count, replace=False)]:
        dels.append((int(u), int(v), w[u, v].item()))
        w1[u, v] = np.inf if w.dtype.kind == "f" else 0
    return dels, w1


def lowered_succ_repair_del_cases(n: int, E: int = 16) -> dict:
    """The bf16 and f16 successor ``repair_del`` of ``chip_smoke.py``'s
    lowered engine path at n (graph seed 61, deletions seed 67): checked
    against a re-solve (distances), then timed by host clock beside it, with
    the affected rows and the sweep's device time by launch kind."""
    import torch

    from repro_torch.apsp import ApspEngine
    from repro_torch.utils.bits import bits_equal

    w = integer_graph(n, 61, hi=16, density=0.02)
    out = {}
    for key, dt in (("bf16", torch.bfloat16), ("f16", torch.float16)):
        eng = ApspEngine(dtype=dt)
        s0 = eng.solve(w, successors=True)
        dels, w1 = on_path_deletions(w, s0.dist, E, seed=67)
        w1 = torch.from_numpy(w1).cuda()
        rep = lambda: eng.repair_del(s0.dist, w1, dels, succ=s0.succ,  # noqa: E731
                                     threshold=100.0)
        got, want = rep(), eng.solve(w1, successors=True)
        tag = f"succ_repair_del_{key}_E{E}"
        out[f"{tag}_ok"] = got.method == "repair_del" and bits_equal(got.dist, want.dist)
        out[f"{tag}_ms"] = host_ms(rep)
        out[f"succ_resolve_{key}_E{E}_ms"] = host_ms(lambda: eng.solve(w1, successors=True))
        _, sweep, sw, _ = marked_sweep(s0.dist, w1.to(dt), dels, succ=s0.succ)
        out[f"{tag}_a"] = int((sw.rows < n).sum())
        out[f"{tag}_a_pad"] = int(sw.rows.numel())
        out[f"{tag}_sweep_ms"] = host_ms(sweep)
        per = device_by_kind(sweep)
        out[f"{tag}_sweep_dev_ms"] = sum(per.values())
        out.update({f"{tag}_sweep_{k}_dev_ms": v for k, v in per.items()})
        del eng, s0, got, want, sw
    return out


def tie_free_graph(n: int, seed: int):
    """Large random integer weights in [1, 1e6), density 0.4: shortest
    paths are unique, so next hops compare bitwise with a re-solve (the
    min-plus graph of the reference's ``launch/fw_serve.py:repair_scenario``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    w = rng.integers(1, 10**6, (n, n)).astype(np.float32)
    w[rng.uniform(size=(n, n)) > 0.4] = np.inf
    np.fill_diagonal(w, 0.0)
    return w


def succ_repair_del_cases(n: int, E: int = 16) -> dict:
    """``ApspEngine.repair_del`` with next hops of the E on-path edges that
    affect the fewest pairs of the tie-free graph at n (``chip_smoke.py``'s
    successor repair_del: graph seed 16, deletions ranked with seed 17),
    threshold 100 so that the sweep runs: checked by bits, distances and
    next hops, against a re-solve, then timed beside it by host clock; the
    marking and the sweep apart (as the engine runs them), and the sweep's
    device time by launch kind."""
    import torch

    from repro_torch.apsp import ApspEngine
    from repro_torch.utils.bits import bits_equal

    w = tie_free_graph(n, seed=16)
    eng = ApspEngine()
    r0 = eng.solve(w, successors=True)
    dels, w1 = deletion_batch(w, ranked_deletions(w, r0.dist, E, seed=17))
    w1 = torch.from_numpy(w1).cuda()
    rep = lambda: eng.repair_del(r0.dist, w1, dels, succ=r0.succ, threshold=100.0)  # noqa: E731
    got, want = rep(), eng.solve(w1, successors=True)
    key = f"succ_repair_del_E{E}"
    out = {f"{key}_ok": (got.method == "repair_del" and bits_equal(got.dist, want.dist)
                         and bits_equal(got.succ, want.succ))}
    out[f"{key}_ms"] = host_ms(rep)
    out[f"succ_resolve_E{E}_ms"] = host_ms(lambda: eng.solve(w1, successors=True))
    mark, sweep, sw, _ = marked_sweep(r0.dist, w1, dels, succ=r0.succ)
    a = int((sw.rows < n).sum())
    out[f"{key}_a"] = a
    out[f"{key}_mark_ms"] = host_ms(mark)
    out[f"{key}_sweep_ms"] = host_ms(sweep)
    per = device_by_kind(sweep)
    out[f"{key}_sweep_dev_ms"] = sum(per.values())
    out.update({f"{key}_sweep_{k}_dev_ms": t for k, t in per.items()})
    return out


def marked_sweep(dist, w1, dels, *, succ=None, s: int = 128):
    """The two stages of a ``repair_del`` of ``dels`` on the card, apart:
    (mark, sweep, buffers, pairs).  ``mark()`` runs the marking, with next
    hops where ``succ`` is given; ``sweep()`` the sweep of the rows it
    affects (padded with n to a power of two of at least 8, as the engine
    pads them) from its result; ``buffers`` the ``sweep_buffers`` of that
    sweep (``rows < n``: the affected rows); ``pairs`` the count of affected
    pairs.  w1 is the updated graph on the card in dist's dtype."""
    import numpy as np

    from repro_torch.kernels import fw_repair_del as fd

    nn, E = dist.shape[-1], len(dels)
    E_pad = max(4, 1 << (E - 1).bit_length())
    u, v, wold = np.zeros(E_pad, np.int32), np.zeros(E_pad, np.int32), np.full(
        E_pad, np.inf, np.float32)
    for i, (ui, vi, wi) in enumerate(dels):
        u[i], v[i], wold[i] = ui, vi, wi
    if succ is None:
        mark = lambda: fd.mark_affected(dist, w1, u, v, wold, E)  # noqa: E731
        d_init, row_mask, cnt = mark()
        s_init = None
    else:
        mark = lambda: fd.mark_affected_with_successors(dist, succ, w1, u, v, wold, E)  # noqa: E731
        d_init, s_init, row_mask, cnt = mark()
    a = int(row_mask.sum())
    rows = np.full(min(max(8, 1 << (a - 1).bit_length()), nn), nn, np.int32)
    rows[:a] = np.flatnonzero(row_mask.cpu().numpy())
    if succ is None:
        sweep = lambda: fd.fw_repair_del_sweep(d_init, rows, block_size=s)  # noqa: E731
    else:
        sweep = lambda: fd.fw_repair_del_sweep_with_successors(  # noqa: E731
            d_init, s_init, rows, block_size=s)
    return mark, sweep, fd.sweep_buffers(d_init, rows, block_size=s, s_init=s_init), int(cnt)


def ranked_deletions(w, dist, count: int, seed: int, sample: int = 256):
    """On-path edges (w == dist, u != v) ranked by how many pairs deleting
    each one affects, fewest first, zero excluded — the ranking of
    ``benchmarks/run.py:bench_fw_repair_del``: ``sample`` candidates drawn
    with a seeded rng, each scored by count(dist[:, u] + w[u, v] +
    dist[v, :] == dist, dist finite), on the card.  Returns [(pairs, u, v)].
    ``chip_smoke.py`` deletes the same edges."""
    import numpy as np
    import torch

    d = torch.as_tensor(dist).cuda()
    wt = torch.as_tensor(w).cuda()
    n = d.shape[-1]
    on = (wt == d) & torch.isfinite(wt) & ~torch.eye(n, dtype=torch.bool, device=d.device)
    cand = torch.nonzero(on).cpu().numpy()
    if len(cand) == 0:
        raise RuntimeError("no on-path edge to delete")
    rng = np.random.default_rng(seed)
    fin = torch.isfinite(d)
    scored = []
    for u, v in cand[rng.choice(len(cand), size=min(sample, len(cand)), replace=False)]:
        pairs = int((((d[:, u, None] + wt[u, v]) + d[None, v, :] == d) & fin).sum())
        if pairs:
            scored.append((pairs, int(u), int(v)))
    return sorted(scored)[:count]


def deletion_batch(w, ranked):
    """(deletions, updated weights): each ranked edge removed."""
    import numpy as np

    w1 = w.copy()
    dels = []
    for _, u, v in ranked:
        dels.append((u, v, float(w[u, v])))
        w1[u, v] = np.inf
    return dels, w1


def repair_del_cases(n: int) -> dict:
    """``ApspEngine.repair_del`` of the fewest-pairs on-path edge and of the
    16 fewest at n (min-plus, integer weights in [1, 1e4), density 0.5: the
    graph and deletions of ``chip_smoke.py``'s repair_del path), threshold
    100 so that the sweep runs, weights on the card; each checked by bits
    against a re-solve, then timed beside it."""
    import numpy as np
    import torch

    from repro_torch.apsp import ApspEngine
    from repro_torch.utils.bits import bits_equal

    rng = np.random.default_rng(10)
    w = rng.integers(1, 10**4, (n, n)).astype(np.float32)
    w[rng.uniform(size=(n, n)) >= 0.5] = np.inf
    np.fill_diagonal(w, 0.0)
    eng = ApspEngine()
    r0 = eng.solve(w)
    ranked = ranked_deletions(w, r0.dist, 256, seed=15)
    out = {}
    for label, batch in (("E1", ranked[:1]), ("E16", ranked[:16])):
        dels, w1 = deletion_batch(w, batch)
        w1 = torch.from_numpy(w1).cuda()
        got = eng.repair_del(r0.dist, w1, dels, threshold=100.0)
        out[f"repair_del_{label}_ok"] = (got.method == "repair_del"
                                         and bits_equal(got.dist, eng.solve(w1).dist))
        out[f"repair_del_{label}_ms"] = host_ms(
            lambda: eng.repair_del(r0.dist, w1, dels, threshold=100.0))
        out[f"resolve_{label}_ms"] = host_ms(lambda: eng.solve(w1))
    return out


def repair_edges(x, sr, E: int, seed: int):
    """E edge updates on x's device in x's dtype (``fw_repair.edge_vectors``):
    random endpoints, a repeated u and a u == v edge, weights in the
    storage's domain (int16 [1, 30], a random lane mask for packed words,
    [-1000, 1000) on an int32 carrier, [1, 10) in the floats, [0, 1/n) for
    plus_mul)."""
    import numpy as np
    import torch

    from repro_torch.kernels import fw_repair as fp

    rng = np.random.default_rng(seed)
    n = x.shape[-1]
    u, v = rng.integers(0, n, E).astype(np.int32), rng.integers(0, n, E).astype(np.int32)
    if E > 2:
        u[1], v[2] = u[0], u[2]
    if x.dtype == torch.int16:
        w = rng.integers(1, 31, E)
    elif x.dtype == torch.int32:
        w = (rng.integers(-(1 << 31), 1 << 31, E) if sr.packed
             else rng.integers(-1000, 1000, E))
    elif sr.name == "plus_mul":
        w = rng.uniform(0.0, 1.0 / n, E)
    else:
        w = rng.uniform(1.0, 10.0, E)
    return fp.edge_vectors(u, v, torch.from_numpy(np.asarray(w)).to(x.dtype), n, x.device,
                           x.dtype)


def repair_launches(x, sr, u, v, w, succ=None):
    """(stage, apply, held) of one repair launch pair on x in the tree's API
    (the stage's ``repair_buffers`` where the tree has them, else its
    staged rows): held() runs both once and holds the staged rows and the
    apply's output (and next hops) by bits against the plain twins."""
    import torch

    from repro_torch.kernels import fw_repair as fp
    from repro_torch.kernels import ref
    from repro_torch.utils.bits import bits_equal

    E, n = len(u), x.shape[-1]
    if hasattr(fp, "repair_buffers"):
        bufs = fp.repair_buffers(x, E, successors=succ is not None)
        staged = bufs.staged
    else:
        bufs = staged = torch.empty((E, n), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    if succ is None:
        stage = lambda: fp.repair_phase("stage", x, u, v, w, bufs, semiring=sr)  # noqa: E731
        apply = lambda: fp.repair_phase("apply", x, u, v, w, bufs, out, semiring=sr)  # noqa: E731
    else:
        sout = torch.empty_like(succ)
        stage = lambda: fp.repair_succ_phase("stage", x, succ, u, v, w, bufs)  # noqa: E731
        apply = lambda: fp.repair_succ_phase("apply", x, succ, u, v, w, bufs,  # noqa: E731
                                             out, sout)

    def held() -> bool:
        stage()
        apply()
        want = ref.repair_stage_ref(x, u, v, w, semiring=sr, strict=succ is not None)
        if succ is None:
            got, wo = (out,), (ref.repair_apply_ref(x, want, u, w, semiring=sr),)
        else:
            got, wo = (out, sout), ref.repair_apply_succ_ref(x, succ, want, u, v, w)
        torch.cuda.synchronize()
        return bits_equal(staged, want) and all(map(bits_equal, got, wo))

    return stage, apply, held


def _kernel_name(key: str) -> str:
    name = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0]


def _union_ms(intervals) -> float:
    """Total length of the union of (start, end) µs intervals, in ms."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def profiled(fn) -> dict:
    """fn() under ``torch.profiler`` (device events only): its wall time
    (host clock, profiled), its kernels' device time and event count by
    name, their sum ``dev``, the device time of its copies to, from and on
    the card, and the time the device was busy at all (the union of the
    events' intervals; the sums overlap)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels: dict[str, list] = {}
    copies = {"HtoD": 0.0, "DtoH": 0.0, "DtoD": 0.0}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if not us:
            continue
        if ev.key.startswith("Memcpy"):
            copies[next((k for k in copies if k in ev.key), "DtoD")] += us / 1e3
            continue
        k = kernels.setdefault(_kernel_name(ev.key), [0.0, 0])
        k[0] += us / 1e3
        k[1] += ev.count
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return dict(wall=wall, copies=copies, kernels=kernels,
                dev=sum(v[0] for v in kernels.values()),
                busy=_union_ms(spans) if spans else None)


def improvements(dist, count: int, seed: int):
    """``count`` ⊕-improving link updates on distinct (u, v), u != v, with
    dist[u, v] >= 2: the new weight dist[u, v] // 2 beats every path."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = dist.shape[-1]
    upd, seen = [], set()
    while len(upd) < count:
        u, v = (int(x) for x in rng.integers(0, n, 2))
        if u == v or (u, v) in seen:
            continue
        d = float(dist[u, v])
        if np.isfinite(d) and d >= 2:
            seen.add((u, v))
            upd.append((u, v, float(d // 2)))
    return upd


def updated(w, upd):
    """The weight matrix a re-solve of the repaired graph closes."""
    w1 = w.copy()
    for u, v, x in upd:
        w1[u, v] = min(w1[u, v], x)
    return w1


def repair_cases(n: int) -> dict:
    """``--repair``: each repair launch alone at (n, n), device time
    (``device_ms``), held by bits first (``repair_*_ok``): the stage and the
    apply in f32 min-plus (E = 1, 16, 32, 64) and plus_mul (E = 16, beside
    ``torch.addmm(d, scalars, staged)``, TF32 off), int16 min-plus, bf16 and
    f16 min-plus, packed words and the int32 or_and / plus_mul carriers (E =
    1, 16, 32, 64; launches of more edges than the tree's pair carries are
    left out), and ``fw_repair`` of 40, 48 and 64 edges in each but f32
    plus_mul, whole (``repair_full_*``) and as a repair of 32 and one of the
    rest (``repair_split_*``), held by bits against ``fw_repair_ref``, the
    device time of every launch pair; the successor stage and apply at n/2 in f32, bf16, f16 (E =
    1, 16).  Then ``ApspEngine.repair`` at n, E = 16 (== a re-solve first)
    by host clock and as device time, and two ``RoutingEngine`` repair refreshes under the
    profiler: f32 with next hops at n/2 (E = 1), int16 at n (E = 8)."""
    import numpy as np
    import torch

    from repro_torch.apsp import ApspEngine, api
    from repro_torch.core.graph import random_digraph
    from repro_torch.core.paths import _init_successors
    from repro_torch.core.semiring import (
        MIN_PLUS, MIN_PLUS_I16, OR_AND, OR_AND_PACKED, PLUS_MUL)
    from repro_torch.kernels import fw_repair as fp
    from repro_torch.kernels import ref
    from repro_torch.launch import fw_serve
    from repro_torch.serve.routing import RoutingEngine
    from repro_torch.utils.bits import bits_equal

    out = {}
    lowered_cap = getattr(fp, "MAX_EDGES_LOWERED", fp.MAX_EDGES)  # older trees: 32
    w = torch.from_numpy(random_digraph(n, density=0.5, seed=1)).cuda()
    rng = np.random.default_rng(50)
    carrier = torch.from_numpy(rng.integers(-1000, 1000, (n, n)).astype(np.int32)).cuda()
    words = torch.from_numpy(rng.integers(0, 1 << 32, (n, n), dtype=np.uint64)
                             .astype(np.uint32).view(np.int32)).cuda()
    cases = {
        "f32": (lambda: w, MIN_PLUS, (1, 16, 32, 64)),
        "f32_plus_mul": (lambda: torch.from_numpy(
            np.random.default_rng(5).uniform(0.0, 1.0 / n, (n, n)).astype(np.float32)).cuda(),
            PLUS_MUL, (16,)),
        "int16": (lambda: api._coerce(w, MIN_PLUS_I16, None, w.device), MIN_PLUS_I16,
                  (1, 16, 32, 64)),
        "bf16": (lambda: w.to(torch.bfloat16), MIN_PLUS, (1, 16, 32, 64)),
        "f16": (lambda: w.to(torch.float16), MIN_PLUS, (1, 16, 32, 64)),
        "packed": (lambda: words, OR_AND_PACKED, (1, 16, 32, 64)),
        "or_and_i32": (lambda: carrier, OR_AND, (1, 16, 32, 64)),
        "plus_mul_i32": (lambda: carrier, PLUS_MUL, (1, 16, 32, 64)),
    }
    for key, (make, sr, Es) in cases.items():
        x = make()
        cap = fp.MAX_EDGES if x.dtype == torch.float32 else lowered_cap
        for E in (E for E in Es if E <= cap):
            u, v, wt = repair_edges(x, sr, E, seed=52 + E)
            stage, apply, held = repair_launches(x, sr, u, v, wt)
            tag = f"{key}_E{E}"
            out[f"repair_{tag}_ok"] = held()
            out[f"repair_stage_{tag}_dev_ms"] = device_ms(stage)
            out[f"repair_apply_{tag}_dev_ms"] = device_ms(apply)
            if key == "f32_plus_mul":
                if hasattr(fp, "repair_buffers"):  # the stage's own buffers
                    b = fp.repair_buffers(x, E)
                    fp.repair_phase("stage", x, u, v, wt, b, semiring=sr)
                    lib = torch.empty_like(x)
                    tf32 = torch.backends.cuda.matmul.allow_tf32
                    torch.backends.cuda.matmul.allow_tf32 = False
                    out[f"repair_addmm_{tag}_dev_ms"] = device_ms(
                        lambda: torch.addmm(x, b.scalars, b.staged, out=lib))
                    torch.backends.cuda.matmul.allow_tf32 = tf32
        for E in (40, 48, 64) if key != "f32_plus_mul" else ():  # whole repairs
            u, v, wt = repair_edges(x, sr, E, seed=116 + E)
            want = ref.fw_repair_ref(x, u, v, wt, semiring=sr)
            runs = {
                "full": lambda: fp.fw_repair(x, u, v, wt, semiring=sr),
                # the same edges as a repair of 32, then one of the rest
                "split": lambda: fp.fw_repair(fp.fw_repair(x, u[:32], v[:32], wt[:32],
                                                           semiring=sr),
                                              u[32:], v[32:], wt[32:], semiring=sr),
            }
            for how, fn in runs.items():
                out[f"repair_{how}_{key}_E{E}_ok"] = bits_equal(fn(), want)
                out[f"repair_{how}_{key}_E{E}_dev_ms"] = device_ms(fn)
            del want
        del x
    ns = n // 2
    ws = torch.from_numpy(random_digraph(ns, density=0.5, seed=2)).cuda()
    for key, dt in (("f32", torch.float32), ("bf16", torch.bfloat16), ("f16", torch.float16)):
        x = ws.to(dt)
        succ = _init_successors(x).contiguous()
        for E in (1, 16):
            u, v, wt = repair_edges(x, MIN_PLUS, E, seed=54 + E)
            stage, apply, held = repair_launches(x, MIN_PLUS, u, v, wt, succ=succ)
            tag = f"succ_{key}_E{E}"
            out[f"repair_{tag}_ok"] = held()
            out[f"repair_stage_{tag}_dev_ms"] = device_ms(stage)
            out[f"repair_apply_{tag}_dev_ms"] = device_ms(apply)

    eng = ApspEngine()
    g = integer_graph(n, 10, hi=10**4, density=0.5)
    r0 = eng.solve(g)
    upd = improvements(r0.dist, 16, seed=11)
    rep = eng.repair(r0.dist, upd)
    out["engine_repair_E16_ok"] = bits_equal(rep.dist, eng.solve(updated(g, upd)).dist)
    repair = lambda: eng.repair(r0.dist, upd)  # noqa: E731
    out["engine_repair_E16_ms"] = statistics.median(host_ms(repair) for _ in range(5))
    out["engine_repair_E16_dev_ms"] = device_ms(repair, reps=10)
    del eng, r0, rep

    router = RoutingEngine(max_batch=16)
    router.add_graph("g0", fw_serve.repair_scenario("min_plus", ns, seed=0)[0])
    router.refresh()
    router.update_edge("g0", 5, ns - 9, 1.0)
    prof = profiled(router.refresh)
    table = router.snapshots.active("g0").dist_tensor()
    full = router.engine.solve(router.registry.weights_tensor("g0").cuda(), successors=True)
    out["refresh_f32_succ_ok"] = bits_equal(table, full.dist.cpu())
    out["refresh_f32_succ_wall_ms"] = prof["wall"]
    out["refresh_f32_succ_kernels_ms"] = {k: t for k, (t, _) in prof["kernels"].items()}
    del router, full
    r16 = RoutingEngine(engine=ApspEngine(dtype=torch.int16))
    r16.add_graph("big", integer_graph(n, 60, hi=16, density=0.02))
    r16.refresh()
    d16 = r16.snapshots.active("big").dist_tensor()
    for u, v, x in improvements(d16, 8, seed=63):
        r16.update_edge("big", u, v, x)
    prof = profiled(r16.refresh)
    full = r16.engine.solve(r16.registry.weights_tensor("big"))
    out["refresh_int16_ok"] = bits_equal(r16.snapshots.active("big").dist_tensor(),
                                         full.dist.cpu())
    out["refresh_int16_wall_ms"] = prof["wall"]
    out["refresh_int16_kernels_ms"] = {k: t for k, (t, _) in prof["kernels"].items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--label", default="")
    ap.add_argument("--build-only", action="store_true")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--sweep", action="store_true",
                      help="time the restricted sweep and repair_del instead")
    mode.add_argument("--phases", action="store_true",
                      help="time the 4-dispatch round's phase kernels and loop instead")
    mode.add_argument("--succ", action="store_true",
                      help="time the successor round's chains and solve instead")
    mode.add_argument("--sweep-succ", action="store_true",
                      help="time the successor sweep's chains and repair_del instead")
    mode.add_argument("--sweep-relax", action="store_true",
                      help="time the sweep's relax launches and repair_del instead")
    mode.add_argument("--repair", action="store_true",
                      help="time the repair's stage and apply, the engine repair and two "
                           "serving refreshes instead")
    args = ap.parse_args(argv)
    import torch

    if args.build_only:
        return build_report(args.label, "sweep" if args.sweep else
                            "repair" if args.repair else
                            "sweep_relax" if args.sweep_relax else
                            "phases" if args.phases else "succ" if args.succ else
                            "sweep_succ" if args.sweep_succ else "")

    import repro_torch
    from repro_torch.apsp import api, solve
    from repro_torch.core.graph import random_digraph
    from repro_torch.core.paths import _init_successors
    from repro_torch.core.semiring import MIN_PLUS, MIN_PLUS_I16, PLUS_MUL
    from repro_torch.core.staged import fw_staged
    from repro_torch.kernels import fw_round as fr
    from repro_torch.kernels import minplus_matmul as fmm
    from repro_torch.kernels import ref
    from repro_torch.utils.bits import bits_equal

    if not torch.cuda.is_available():
        print("round_bench: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    out = dict(label=args.label, package=repro_torch.__file__, nvidia_smi=smi, n=args.n)
    n, s = args.n, 128
    b = n // s // 2
    if args.repair:
        out.update(repair_cases(n))
        print(json.dumps(out))
        return 0 if all(v for k, v in out.items() if k.endswith("_ok")) else 1
    if args.sweep_relax:
        out.update(sweep_relax_cases(n, s))
        out.update(repair_del_cases(n))
        out.update(succ_repair_del_cases(n // 2))
        out.update(lowered_succ_repair_del_cases(n // 2))
        print(json.dumps(out))
        return 0 if all(v for k, v in out.items() if k.endswith("_ok")) else 1
    if args.succ or args.sweep_succ:
        if args.succ:
            out.update(succ_chain_cases(n, s))
        else:
            out.update(succ_sweep_cases(n, s))
            out.update(succ_repair_del_cases(n // 2))
        print(json.dumps(out))
        return 0 if all(v for k, v in out.items() if k.endswith("_ok")) else 1
    w = torch.from_numpy(random_digraph(n, density=0.5, seed=0)).cuda()
    if args.sweep or args.phases:
        out.update(sweep_cases(w, n, s) if args.sweep else phase_cases(w, n, s))
        del w
        if args.sweep:
            out.update(repair_del_cases(n))
        print(json.dumps(out))
        return 0 if all(v for k, v in out.items() if k.endswith("_ok")) else 1

    def round_case(x, sr, key, *, phases=("relax",)):
        """Close the bands of round b of x, check the relax launch against
        its plain phase, time the launches named."""
        bands = fr.round_buffers(x, s)
        kw = dict(block_size=s, semiring=sr)
        for phase in ("diag", "bands"):
            fr.fw_round_phase(phase, x, b, bands, **kw)
        got = x.clone()
        fr.fw_round_phase("relax", got, b, bands, **kw)
        want = ref.relax(x, bands[0][0], bands[1][0], b, semiring=sr)
        torch.cuda.synchronize()
        out[f"{key}_ok"] = bits_equal(got, want)
        del want
        for phase in phases:
            out[f"{key}_{phase}_ms"] = event_ms(
                lambda: fr.fw_round_phase(phase, got, b, bands, **kw))
        return bands

    chains = chain_cases(w, n, s)
    out.update(chains)
    bands = round_case(w, MIN_PLUS, "f32", phases=("diag", "bands", "relax"))
    mm = torch.empty_like(w)
    out["f32_matmul_ms"] = event_ms(
        lambda: fmm.semiring_matmul(bands[1][0], bands[0][0], w, semiring=MIN_PLUS, out=mm))
    bands = round_case(w, PLUS_MUL, "plus_mul")
    out["plus_mul_matmul_ms"] = event_ms(
        lambda: fmm.semiring_matmul(bands[1][0], bands[0][0], w, semiring=PLUS_MUL, out=mm))
    out["plus_mul_addmm_ms"] = event_ms(
        lambda: torch.addmm(w, bands[1][0], bands[0][0], out=mm))
    del bands, mm
    round_case(api._coerce(w, MIN_PLUS_I16, None, w.device), MIN_PLUS_I16, "int16")
    round_case(w.to(torch.bfloat16), MIN_PLUS, "bf16")

    ns = n // 2
    bs = ns // s // 2
    ws = torch.from_numpy(random_digraph(ns, density=0.5, seed=2)).cuda()
    for dt, key in ((torch.float32, "succ_f32"), (torch.bfloat16, "succ_bf16")):
        x = ws.to(dt)
        succ = _init_successors(x).contiguous()
        bands = fr.succ_round_buffers(x, s)
        for phase in ("diag", "bands"):
            fr.fw_round_with_successors_phase(phase, x, succ, bs, bands, block_size=s)
        gd, gs = x.clone(), succ.clone()
        fr.fw_round_with_successors_phase("relax", gd, gs, bs, bands, block_size=s)
        rw, cw, rs, cs = (t[0] for t in bands)
        wd, wsu = ref.relax_succ_tiles(x, succ, rw, rs, cw, cs, bs)
        torch.cuda.synchronize()
        out[f"{key}_ok"] = bits_equal(gd, wd) and bits_equal(gs, wsu)
        out[f"{key}_relax_ms"] = event_ms(lambda: fr.fw_round_with_successors_phase(
            "relax", gd, gs, bs, bands, block_size=s))
        del bands, gd, gs, wd, wsu

    out["solve_ms"] = host_ms(lambda: solve(w))
    for key, kw in (("int16", dict(dtype=torch.int16)), ("bf16", dict(dtype=torch.bfloat16)),
                    ("f16", dict(dtype=torch.float16))):
        out[f"solve_{key}_ms"] = host_ms(lambda: solve(w, **kw))
    planes = torch.rand((32, n, n), device=w.device) < 2.0 / n
    out["solve_packed_ms"] = host_ms(lambda: solve(planes, semiring="or_and", packed=True))
    del planes
    out["succ_solve_ms"] = host_ms(lambda: solve(ws, successors=True))
    out["four_dispatch_ms"] = host_ms(lambda: fw_staged(w, block_size=s, fused=False))
    print(json.dumps(out))
    return 0 if all(v for k, v in out.items() if k.endswith("_ok")) else 1


if __name__ == "__main__":
    sys.exit(main())
