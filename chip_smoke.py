#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py            # the whole run, one card
    python3 chip_smoke.py --quick    # build + kernel-vs-plain checks only

Phases, each of which raises (exit code 1) on any failure:

  1. device: the card's name and power limit; build the CUDA kernels from
     ``src/repro_torch/kernels/csrc`` and print their registers and spills.
  2. check: every kernel held bitwise (NaN equal to NaN) against its plain
     torch version on the same card tensors — the fused round on all five
     semirings at (1024,1024) s=128, (4,512,512) batched, n=1000 through
     ``solve`` (padded to 1024), n=100 (s=32) and n=60 (s=16); the
     successor round at (1024,1024) and (3,512,512).  The small solves are
     also held against ``solve(device="cpu")``, the plain path the CPU
     tests hold bitwise against the JAX reference.
  3. kernels: each launch kind alone at the main path's shapes, against
     the plain version of its phase: max abs error, median ms, plain ms
     and the bound (the larger of operations / 67 TFLOP/s fp32 and bytes /
     3.35 TB/s, the H100 SXM's published peaks).
  4. main path: ``solve(w)`` at n=8192 (min-plus, f32, a seeded random
     digraph of density 0.5) and ``solve(w, successors=True)`` at n=4096,
     with the launch counts of that run, bitwise against the plain round
     loop, then timed (warm-up, median of 3; host clock around work that
     ends in ``synchronize()``).

The last lines are the ``{"kernels": [...]}`` record and then
``{"ok": true, "device": {...}}``.  The script imports nothing of JAX or of
the ``repro`` package.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_FP32_OPS = 67e12  # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
SOURCE = "src/repro_torch/kernels/csrc/fw_round.cu"
REPLACES = {
    "fw_round": "src/repro/kernels/fw_round.py:413",
    "fw_round_with_successors": "src/repro/kernels/fw_round.py:611",
}


class SmokeFailure(RuntimeError):
    pass


def same(a, b) -> bool:
    """Bitwise-equal values, NaN equal to NaN (torch.equal says NaN != NaN)."""
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ------------------------------------------------------------------ inputs
def graph(name: str, shape, seed: int):
    """A matrix in the value domain of each semiring, missing edges = 0̄."""
    import numpy as np

    from repro_torch.core.semiring import SEMIRINGS

    rng = np.random.default_rng(seed)
    n = shape[-1]
    if name == "plus_mul":
        return rng.uniform(0.0, 1.0 / n, size=shape).astype(np.float32)
    if name == "or_and":
        w = (rng.uniform(size=shape) < 0.1).astype(np.float32)
    else:
        w = rng.uniform(1.0, 10.0, size=shape).astype(np.float32)
        if name == "max_plus":  # longest paths: a DAG, or cycles grow to inf
            lo = np.tril_indices(n, -1)
            w[..., lo[0], lo[1]] = -np.inf
        w[rng.uniform(size=shape) < 0.3] = SEMIRINGS[name].zero
    idx = np.arange(n)
    w[..., idx, idx] = SEMIRINGS[name].one
    return w


def plain_solve(w, *, block_size: int, semiring):
    """The plain round loop on w's device: pad, n/s plain rounds, unpad."""
    from repro_torch.apsp import api, plan
    from repro_torch.kernels import ref

    n = w.shape[-1]
    wp = api._pad(w, plan.padded_size(n, block_size), semiring)
    for b in range(wp.shape[-1] // block_size):
        wp = ref.fw_round_ref(wp, b, block_size=block_size, semiring=semiring)
    return wp[..., :n, :n]


def plain_solve_succ(w, *, block_size: int):
    from repro_torch.core.paths import _init_successors
    from repro_torch.kernels import ref

    succ = _init_successors(w)
    for b in range(w.shape[-1] // block_size):
        w, succ = ref.fw_round_with_successors_ref(w, succ, b, block_size=block_size)
    return w, succ


# ------------------------------------------------------------------ timing
def sync():
    import torch

    torch.cuda.synchronize()


def event_ms(fn, reps: int) -> float:
    """Median of ``reps`` single runs of fn, each between two CUDA events."""
    import torch

    fn()
    sync()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn) -> float:
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    return (time.perf_counter() - t0) * 1e3


def max_abs_err(a, b) -> float:
    import torch

    eq = (a == b) | (torch.isnan(a) & torch.isnan(b))
    diff = torch.where(eq, torch.zeros_like(a), (a.double() - b.double()).abs())
    return float(torch.nan_to_num(diff, nan=float("inf")).max())


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / PEAK_FP32_OPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# ------------------------------------------------------------------ phases
def phase_device():
    import torch

    from repro_torch.kernels import _build

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"nvidia-smi: {smi}")
    for built in _build.build_all():
        print(f"built {built.path.name} in {built.seconds:.1f} s")
        func, spill = None, ""
        for line in built.log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                func = m.group(1)
                kern = re.search(r"([a-z_]+_kernel)", func)
                size = re.search(r"ILi(\d+)E", func)
                op = re.search(r"(MinPlus|MaxPlus|MaxMin|PlusMul)", func)
                func = "/".join(x.group(1) for x in (kern, size, op) if x)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                spill = f"spill {m.group(1)}/{m.group(2)} B"
            m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
            if m and func:
                print(f"  ptxas {func}: {m.group(1)} regs, {m.group(2) or 0} B static "
                      f"smem, {spill}")
    return name


def phase_check():
    import torch

    from repro_torch.apsp import solve
    from repro_torch.core.semiring import SEMIRINGS
    from repro_torch.kernels import fw_round as fr
    from repro_torch.kernels import ref
    from repro_torch.core.paths import _init_successors

    dev = torch.device("cuda")
    checked = 0
    for name, sr in sorted(SEMIRINGS.items()):
        for shape, b in (((1024, 1024), 3), ((4, 512, 512), 1)):
            w = torch.from_numpy(graph(name, shape, 7)).to(dev)
            got = fr.fw_round(w.clone(), b, block_size=128, semiring=sr)
            want = ref.fw_round_ref(w, b, block_size=128, semiring=sr)
            sync()
            require(same(got, want), f"fw_round {name} {shape} b={b} != plain")
            checked += 1
        for n, s in ((1000, 128), (100, 32), (60, 16)):
            w_np = graph(name, (n, n), n)
            w = torch.from_numpy(w_np).to(dev)
            got = solve(w, method="fused", semiring=sr, block_size=s).dist
            want = plain_solve(w, block_size=s, semiring=sr)
            sync()
            require(same(got, want), f"solve {name} n={n} s={s} != plain")
            if n < 1000:
                host = solve(w_np, method="fused", semiring=sr, block_size=s,
                             device="cpu").dist
                require(same(got.cpu(), host),
                        f"solve {name} n={n} s={s}: card != plain on the CPU")
            checked += 1
    for shape, b in (((1024, 1024), 5), ((3, 512, 512), 2)):
        w = torch.from_numpy(graph("min_plus", shape, 11)).to(dev)
        succ = _init_successors(w).contiguous()
        gd, gs = fr.fw_round_with_successors(w.clone(), succ.clone(), b, block_size=128)
        wd, ws = ref.fw_round_with_successors_ref(w, succ, b, block_size=128)
        sync()
        require(same(gd, wd) and same(gs, ws),
                f"fw_round_with_successors {shape} b={b} != plain")
        checked += 1
    print(f"check: {checked} kernel-vs-plain cases bitwise equal")


def phase_kernels(n: int, n_succ: int, s: int = 128):
    """Each launch kind alone at the main path's shapes: error vs its plain
    phase, median ms, plain ms, bound."""
    import torch

    from repro_torch.core.graph import random_digraph
    from repro_torch.core.paths import _init_successors
    from repro_torch.core.semiring import MIN_PLUS
    from repro_torch.kernels import fw_round as fr
    from repro_torch.kernels import ref

    rows = {}
    dev = torch.device("cuda")

    def record(kind, err, ms, plain, ops, nbytes):
        bms, by = bound(ops, nbytes)
        fn = kind.split("/")[0]
        rows[kind] = dict(name=kind, route="cuda", source=SOURCE, replaces=REPLACES[fn],
                          launches=0, max_abs_err=err, ms=ms, plain_ms=plain,
                          bound_ms=bms, bound_by=by, library_ms=None)
        print(f"kernel {kind}: err {err}, {ms:.4f} ms (plain {plain:.3f} ms, "
              f"bound {bms:.5f} ms by {by})")

    # --- fw_round at (n, n), pivot round b
    T = n // s
    b = T // 2
    o = slice(b * s, (b + 1) * s)
    w = torch.from_numpy(random_digraph(n, density=0.5, seed=1)).to(dev)
    bands = fr.round_buffers(w, s)
    kw = dict(block_size=s, semiring=MIN_PLUS)

    fr.fw_round_phase("diag", w, b, bands, **kw)
    diag = ref.close_diag(w[o, o], MIN_PLUS)
    sync()
    require(same(bands[0][0, :, o], diag) and same(bands[1][0, o, :], diag),
            "diag launch != plain close_diag")
    record("fw_round/diag", max_abs_err(bands[0][0, :, o], diag),
           event_ms(lambda: fr.fw_round_phase("diag", w, b, bands, **kw), 11),
           event_ms(lambda: ref.close_diag(w[o, o], MIN_PLUS), 3),
           2.0 * s**3, 2 * s * s * 4)

    fr.fw_round_phase("bands", w, b, bands, **kw)
    row, col = ref.close_bands(w, diag, b, MIN_PLUS)
    sync()
    require(same(bands[0][0], row) and same(bands[1][0], col),
            "bands launch != plain close_bands")
    tiles = 2 * (T - 1)
    record("fw_round/bands", max(max_abs_err(bands[0][0], row), max_abs_err(bands[1][0], col)),
           event_ms(lambda: fr.fw_round_phase("bands", w, b, bands, **kw), 11),
           event_ms(lambda: ref.close_bands(w, diag, b, MIN_PLUS), 3),
           2.0 * tiles * s**3, (s * s + 2 * tiles * s * s) * 4)

    wk = w.clone()
    fr.fw_round_phase("relax", wk, b, bands, **kw)
    want = ref.relax(w, row, col, b, semiring=MIN_PLUS)
    sync()
    require(same(wk, want), "relax launch != plain relax")
    record("fw_round/relax", max_abs_err(wk, want),
           event_ms(lambda: fr.fw_round_phase("relax", wk, b, bands, **kw), 5),
           event_ms(lambda: ref.relax(w, row, col, b, semiring=MIN_PLUS), 1),
           2.0 * n * n * s, (2 * n * n + 2 * n * s) * 4)
    del w, wk, want, bands

    # --- fw_round_with_successors at (n_succ, n_succ); words are f32 + i32
    T = n_succ // s
    b = T // 2
    o = slice(b * s, (b + 1) * s)
    w = torch.from_numpy(random_digraph(n_succ, density=0.5, seed=2)).to(dev)
    succ = _init_successors(w).contiguous()
    bands = fr.succ_round_buffers(w, s)
    fr.fw_round_with_successors_phase("diag", w, succ, b, bands, block_size=s)
    diag, dsucc = ref.close_diag_succ(w[o, o], succ[o, o])
    sync()
    require(same(bands[0][0, :, o], diag) and same(bands[2][0, :, o], dsucc)
            and same(bands[1][0, o, :], diag) and same(bands[3][0, o, :], dsucc),
            "successor diag launch != plain")
    record("fw_round_with_successors/diag", max_abs_err(bands[0][0, :, o], diag),
           event_ms(lambda: fr.fw_round_with_successors_phase(
               "diag", w, succ, b, bands, block_size=s), 11),
           event_ms(lambda: ref.close_diag_succ(w[o, o], succ[o, o]), 3),
           2.0 * s**3, 2 * s * s * 8)

    fr.fw_round_with_successors_phase("bands", w, succ, b, bands, block_size=s)
    want_b = ref.close_bands_succ(w, succ, diag, dsucc, b)
    sync()
    got_b = tuple(t[0] for t in bands)
    require(all(same(g, x) for g, x in zip(got_b, (want_b[0], want_b[2],
                                                           want_b[1], want_b[3]))),
            "successor bands launch != plain")
    tiles = 2 * (T - 1)
    record("fw_round_with_successors/bands",
           max(max_abs_err(got_b[0], want_b[0]), max_abs_err(got_b[1], want_b[2])),
           event_ms(lambda: fr.fw_round_with_successors_phase(
               "bands", w, succ, b, bands, block_size=s), 11),
           event_ms(lambda: ref.close_bands_succ(w, succ, diag, dsucc, b), 3),
           2.0 * tiles * s**3, (s * s + 2 * tiles * s * s) * 8)

    wk, sk = w.clone(), succ.clone()
    fr.fw_round_with_successors_phase("relax", wk, sk, b, bands, block_size=s)
    wd, ws = ref.relax_succ_tiles(w, succ, *want_b, b)
    sync()
    require(same(wk, wd) and same(sk, ws), "successor relax launch != plain")
    record("fw_round_with_successors/relax", max_abs_err(wk, wd),
           event_ms(lambda: fr.fw_round_with_successors_phase(
               "relax", wk, sk, b, bands, block_size=s), 5),
           event_ms(lambda: ref.relax_succ_tiles(w, succ, *want_b, b), 1),
           2.0 * n_succ * n_succ * s, (2 * n_succ * n_succ + 2 * n_succ * s) * 8)
    return rows


def phase_main(rows: dict, n: int, n_succ: int, s: int = 128):
    import torch

    from repro_torch.apsp import solve
    from repro_torch.core.graph import random_digraph
    from repro_torch.core.semiring import MIN_PLUS
    from repro_torch.kernels import fw_round as fr

    dev = torch.device("cuda")
    w = torch.from_numpy(random_digraph(n, density=0.5, seed=0)).to(dev)
    ws = torch.from_numpy(random_digraph(n_succ, density=0.5, seed=3)).to(dev)

    fr.reset_launch_counts()
    res = solve(w)
    res_s = solve(ws, successors=True)
    sync()
    counts = dict(fr.LAUNCHES)
    print(f"main path launch counts: {json.dumps(counts)}")
    for kind, row in rows.items():
        row["launches"] = counts[kind]
        require(counts[kind] > 0, f"{kind} was not launched on the main path")
    require(res.method == "fused" and res.block_size == s, f"solve took {res.method}")

    d = res.dist
    require(d.shape == (n, n) and bool(torch.isfinite(d).all()), "n=8192 dist not finite")
    require(bool((torch.diagonal(d) == 0).all()) and bool((d <= w).all()),
            "n=8192 dist is not a min-plus closure of w")
    t0 = time.perf_counter()
    want = plain_solve(w, block_size=s, semiring=MIN_PLUS)
    sync()
    t_plain = (time.perf_counter() - t0) * 1e3
    require(same(d, want), f"solve n={n} != plain round loop")
    del want
    t0 = time.perf_counter()
    want_d, want_s = plain_solve_succ(ws, block_size=s)
    sync()
    t_plain_s = (time.perf_counter() - t0) * 1e3
    require(same(res_s.dist, want_d) and same(res_s.succ, want_s),
            f"solve(successors=True) n={n_succ} != plain round loop")
    del want_d, want_s

    def report(label, nn, fn, plain_ms, word):
        fn()  # warm-up
        times = [host_ms(fn) for _ in range(3)]
        ms = statistics.median(times)
        ops = 2.0 * nn**3
        nbytes = (nn // s) * 2.0 * nn * nn * word
        bms, by = bound(ops, nbytes)
        print(f"main {label}: median {ms:.2f} ms of {['%.2f' % t for t in times]}, "
              f"{nn**3 / (ms / 1e3):.4e} relaxations/s, bound {bms:.2f} ms by {by} "
              f"({100 * bms / ms:.1f}% of it), plain {plain_ms:.0f} ms")
        return ms

    report(f"solve n={n} min_plus f32", n, lambda: solve(w), t_plain, 4)
    report(f"solve n={n_succ} successors=True", n_succ,
           lambda: solve(ws, successors=True), t_plain_s, 8)
    breakdown(w.clone(), s)


def breakdown(w, s: int):
    """Where a solve's device time goes: the round loop of ``fw_staged``
    with CUDA events between its launches, summed by launch kind; the rest
    of the span between the first and last event is gaps between launches."""
    import torch

    from repro_torch.kernels import fw_round as fr

    bands = fr.round_buffers(w, s)
    ev = []
    sync()
    for b in range(w.shape[-1] // s):
        for phase in fr.PHASES:
            ev.append(torch.cuda.Event(enable_timing=True))
            ev[-1].record()
            fr.fw_round_phase(phase, w, b, bands, block_size=s)
    ev.append(torch.cuda.Event(enable_timing=True))
    ev[-1].record()
    sync()
    per = dict.fromkeys(fr.PHASES, 0.0)
    for i in range(len(ev) - 1):
        per[fr.PHASES[i % 3]] += ev[i].elapsed_time(ev[i + 1])
    span = ev[0].elapsed_time(ev[-1])
    parts = ", ".join(f"{p} {t:.2f} ms ({100 * t / span:.1f}%)" for p, t in per.items())
    print(f"main breakdown n={w.shape[-1]} (events between launches; each share "
          f"includes the gap after it): {parts}; span {span:.2f} ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and run the kernel-vs-plain checks only")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository (src/repro_torch "
              "is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    name = phase_device()
    phase_check()
    if not args.quick:
        rows = phase_kernels(8192, 4096)
        phase_main(rows, 8192, 4096)
        print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
