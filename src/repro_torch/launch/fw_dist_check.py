"""Distributed-solve check and bench on an R×C process grid.

    python -m repro_torch.launch.fw_dist_check --devices 4 --n 256 --bs 32 --bitwise
    python -m repro_torch.launch.fw_dist_check --devices 8 --n 96 --bs 32 \\
        --method solve --bitwise --semiring plus_mul --device cpu
    python -m repro_torch.launch.fw_dist_check --devices 4 --n 256 --bs 32 \\
        --bitwise --dtype int16 --device cpu

Counterpart of ``repro.launch.fw_dist_check``.  Spawns the R×C grid of
``launch.mesh.run_grid`` (R, C = ``plan.mesh_factorization(--devices)``) on
``--device``; ranks that share one card talk over gloo.  Every rank holds
its own result against the port's single-device solve on its own device.
Exit code 0 on success.  Modes:

  (default)        fw_distributed == fw_naive (allclose, rtol = atol = 2e-5:
                   the blocked order rounds differently from the naive one).
  --bitwise        == the single-device fused solve, bitwise (NaN equal to
                   NaN) — the owner-echo guarantee of the bordered round.
  --method solve   through ``solve(method="distributed")``, which pads any n
                   through ``plan.distributed_plan`` (e.g. --n 96); --batch B
                   closes B graphs at once.
  --dtype D        the storage: float32 (default), bfloat16, float16, or
                   int16 (the semiring's saturating ``*_i16`` lowering);
                   --semiring also takes a lowering's name (min_plus_i16,
                   or_and_packed).  Lowered checks need --bitwise: they hold
                   against the lowered single-device fused solve.
  --packed         or_and on bit-packed words: 32 graphs a word (``--batch``
                   words), closed by ``OR_AND_PACKED``; with --repair the
                   mesh repair of one word plane.
  --chunked        direct mode in chunks of a quarter of the rounds,
                   restarted from the half-way checkpoint: both runs ==
                   the single-device solve.
  --repair         ``ApspEngine(method="distributed").repair`` == the
                   single-device repair == a re-solve of the updated
                   graph, bitwise; a warm repair builds no new runner.
  --repair-del     ``ApspEngine(method="distributed").repair_del`` of
                   on-path link failures (threshold 100: the sweep, not
                   the re-solve) == the single-device repair_del == a
                   re-solve of the deleted graph, bitwise, after the mesh
                   solve == the single-device one; plus_mul takes the
                   re-solve fallback, == the mesh engine's own re-solve.
  --method engine  ``ApspEngine(method="distributed").solve_many`` of three
                   ragged graphs (n, max(n/2, 2·bs), n) == the
                   single-device fused solve of each; a second pass builds
                   no new runner.
  --pods P         the grid of ``plan.mesh_factorization(--devices, P)``.
  --bench          ``METRICS {json}``: per-round ms and the bytes each rank
                   handed to collectives, against
                   ``plan.dist_round_comm_bytes`` × rounds and the SUMMA
                   bound.

The rank functions ``grid_check`` (a list of such checks on one grid,
returning small records) and ``run_cases`` (raw results, which the tests
hold against the JAX reference) are what ``chip_smoke.py`` and
``tests/test_torch_distributed.py`` run through ``run_grid``.
"""
from __future__ import annotations

import argparse
import functools
import json
import statistics
import sys
import time

import numpy as np
import torch

from repro_torch.apsp import ApspEngine, plan, solve
from repro_torch.apsp.api import _coerce
from repro_torch.core.distributed import fw_distributed, gather, local_block
from repro_torch.core.floyd_warshall import fw_naive
from repro_torch.core.graph import random_digraph
from repro_torch.core.semiring import (
    LOWERED_SEMIRINGS,
    PACK_LANES,
    SEMIRINGS,
    Semiring,
    lower_semiring,
    resolve_semiring,
)
from repro_torch.kernels import fw_round as fr

STORAGES = ("float32", "bfloat16", "float16", "int16")
from repro_torch.launch.mesh import run_grid


# ------------------------------------------------------------------ inputs
def graph_for(semiring: str, n: int, seed: int = 0, density: float = 0.3) -> np.ndarray:
    """Per-semiring f32 input whose closure stays finite: tiny weights for
    plus_mul, a sparse 0/1 graph for or_and, a random digraph (missing
    edges = the ⊕-identity) otherwise, a DAG for max_plus."""
    rng = np.random.default_rng(seed)
    if semiring == "plus_mul":
        return rng.uniform(1e-3, 1e-2, (n, n)).astype(np.float32)
    if semiring == "or_and":
        w = (rng.uniform(0, 1, (n, n)) < 0.05).astype(np.float32)
        np.fill_diagonal(w, 1.0)
        return w
    w = random_digraph(n, density=density, seed=seed)
    sr = SEMIRINGS[semiring]
    if semiring != "min_plus":
        w[np.isinf(w)] = sr.zero
        np.fill_diagonal(w, sr.one)
    if semiring == "max_plus":  # longest paths need a DAG
        w[np.tril_indices(n, -1)] = -np.inf
    return w


def repair_scenario(semiring: str, n: int, seed: int = 0, edges: int | None = None):
    """(w, updates, baseline method) on which a repair is exact: integer
    weights, ⊕-improving updates, a DAG with additive deltas for plus_mul,
    whose closure only plain FW ("naive") gives.  ``edges`` random
    improving updates replace the fixed ones (min_plus)."""
    rng = np.random.default_rng(seed)
    if semiring == "min_plus":
        w = rng.integers(1, 10**6, (n, n)).astype(np.float32)
        w[rng.uniform(size=(n, n)) > 0.4] = np.inf
        np.fill_diagonal(w, 0.0)
        upd = [(3, 7, 5.0), (n // 2, 2, 3.0), (1, n - 2, 17.0)]
        if edges is not None:
            uv = rng.integers(0, n, (edges, 2))
            upd = [(int(u), int(v), float(rng.integers(1, 100))) for u, v in uv]
        return w, upd, "fused"
    if edges is not None:
        raise ValueError("random edge batches are drawn for min_plus only")
    if semiring == "max_plus":
        w = np.full((n, n), -np.inf, np.float32)
        iu = np.triu_indices(n, 1)
        mask = rng.uniform(size=len(iu[0])) < 0.3
        w[iu[0][mask], iu[1][mask]] = rng.integers(1, 100, mask.sum()).astype(np.float32)
        np.fill_diagonal(w, 0.0)
        return w, [(3, n // 2, 500.0), (1, n - 2, 400.0)], "fused"
    if semiring == "max_min":
        w = rng.integers(1, 100, (n, n)).astype(np.float32)
        w[rng.uniform(size=(n, n)) > 0.4] = -np.inf
        np.fill_diagonal(w, np.inf)
        return w, [(3, 7, 1000.0), (n // 2, 2, 900.0)], "fused"
    if semiring == "or_and":
        w = (rng.uniform(size=(n, n)) < 0.05).astype(np.float32)
        np.fill_diagonal(w, 1.0)
        return w, [(3, 7, 1.0), (n - 2, 9, 1.0)], "fused"
    if semiring == "plus_mul":
        w = np.zeros((n, n), np.float32)
        iu = np.triu_indices(n, 1)
        mask = rng.uniform(size=len(iu[0])) < 0.08
        w[iu[0][mask], iu[1][mask]] = 1.0
        return w, [(3, n // 2, 1.0), (1, n - 2, 1.0)], "naive"
    raise ValueError(f"no repair scenario for semiring {semiring!r}")


def apply_updates(w: np.ndarray, updates, semiring: str) -> np.ndarray:
    """The updated weight matrix a re-solve closes: each update ⊕-merged."""
    sr = SEMIRINGS[semiring]
    w1 = torch.from_numpy(np.array(w, copy=True))
    for u, v, d in updates:
        w1[u, v] = sr.add(w1[u, v], torch.tensor(d, dtype=w1.dtype))
    return w1.numpy()


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise-equal values, NaN equal to NaN."""
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def storage_semiring(cfg: dict) -> Semiring:
    """The semiring a check runs: cfg's "semiring" (a lowering's name too),
    lowered to cfg's "dtype" / "packed" storage."""
    sr = resolve_semiring(cfg["semiring"])
    if cfg.get("packed"):
        return lower_semiring(sr, packed=True)
    return lower_semiring(sr, cfg.get("dtype"))


def _base(sr: Semiring) -> str:
    return sr.name.removesuffix("_i16").removesuffix("_packed")


def packed_words(n: int, batch: int, seed: int, device) -> torch.Tensor:
    """``batch`` planes of 32 random or_and graphs a word, (batch, n, n)
    int32 on device: edge probability min(0.05, 4/n) (a closure that grows
    over many rounds), self-loops set; drawn on the device, so a plane of
    n = 8192 costs no host memory, and the same on every rank."""
    gen = torch.Generator(device=device).manual_seed(seed)
    words = torch.zeros((batch, n, n), dtype=torch.int32, device=device)
    for lane in range(PACK_LANES):
        bit = (1 << lane) if lane < 31 else -(1 << 31)
        edges = torch.rand((batch, n, n), generator=gen, device=device) < min(0.05, 4.0 / n)
        words |= edges.to(torch.int32) * bit
    idx = torch.arange(n, device=device)
    words[:, idx, idx] = -1
    return words


def _inputs(cfg: dict, device, sr: Semiring) -> torch.Tensor:
    """cfg's input in sr's storage on device: ``graph_for`` graphs cast to
    the dtype, clipped into int16, or ``packed_words``."""
    n, B = cfg["n"], cfg.get("batch", 1)
    seed, density = cfg.get("seed", 0), cfg.get("density", 0.3)
    if sr.packed:
        words = packed_words(n, B, seed, device)
        return words[0] if B == 1 else words
    graphs = [graph_for(_base(sr), n, seed=seed + i, density=density) for i in range(B)]
    w = torch.from_numpy(graphs[0] if B == 1 else np.stack(graphs)).to(device)
    if sr.dtype == "int16":
        return _coerce(w, sr, None, device)
    return w.to(getattr(torch, cfg.get("dtype") or "float32"))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _median_ms(fn, device, reps: int) -> tuple[float, list[float]]:
    """Host clock around fn() and a synchronize, median of reps after a
    warm-up."""
    fn()
    times = []
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


# ------------------------------------------------------------ rank functions
def grid_check(mesh, cfgs: list[dict]) -> list[dict]:
    """Run each check of ``cfgs`` on this rank (every rank runs the same
    list); each returns a small record with ``ok`` and what it measured."""
    return [_check(mesh, dict(cfg)) for cfg in cfgs]


def _check(mesh, cfg: dict) -> dict:
    if cfg.get("repair"):
        return _check_repair(mesh, cfg)
    if cfg.get("repair_del"):
        return _check_repair_del(mesh, cfg)
    if cfg.get("method") == "engine":
        return _check_engine(mesh, cfg)
    dev = mesh.device
    sr = storage_semiring(cfg)
    w = _inputs(cfg, dev, sr)
    s, backend = cfg.get("bs"), cfg.get("backend", "fused")
    rec = dict(rank=mesh.rank, R=mesh.R, C=mesh.C, n=cfg["n"], batch=cfg.get("batch", 1),
               semiring=sr.name, dtype=str(w.dtype).removeprefix("torch."),
               method=cfg.get("method", "direct"), backend=backend)
    single = functools.partial(solve, method="fused", semiring=sr, validate=False,
                               device=dev.type)
    mesh.comm_bytes = mesh.staged_bytes = 0
    if rec["method"] == "solve":
        res = solve(w, method="distributed", mesh=mesh, semiring=sr, block_size=s,
                    validate=False, device=dev.type)
        s, got = res.block_size, res.dist
        want = single(w, block_size=s).dist
        rec.update(block_size=s, padded_n=res.padded_n, ok=same(got, want))
        return rec
    run = functools.partial(fw_distributed, w, mesh, block_size=s, semiring=sr,
                            backend=backend)
    fr.reset_launch_counts()
    local = run()
    _sync(dev)
    rounds = cfg["n"] // s
    graphs = w.shape[0] if w.ndim == 3 else 1
    rec.update(block_size=s, rounds=rounds, comm_bytes=mesh.comm_bytes,
               launches={k: fr.LAUNCHES[k] for k in fr.KINDS if "bordered" in k},
               staged_bytes=mesh.staged_bytes,
               model_bytes=rounds * plan.dist_round_comm_bytes(
                   cfg["n"], mesh.R, mesh.C, s, word=w.element_size(), batch=graphs))
    if cfg.get("bitwise", True):
        want = local_block(single(w, block_size=s).dist, mesh)
        rec["ok"] = same(local, want)
    else:
        want = local_block(fw_naive(w, semiring=sr), mesh)
        rec["ok"] = bool(torch.allclose(local, want, rtol=2e-5, atol=2e-5, equal_nan=True))
    del local
    if cfg.get("chunked"):
        rec["chunked_ok"] = _check_chunked(mesh, w, cfg, s, sr, backend, want)
    if cfg.get("reps"):
        rec["ms"], rec["times"] = _median_ms(run, dev, cfg["reps"])
    if cfg.get("breakdown"):
        rec["breakdown"], rec["breakdown_ok"] = _breakdown(w, s, want, sr)
    return rec


def _chunked(mesh, w, rounds_per_call: int, restart_at: int, **kw):
    """(first, again, checkpoints): ``fw_distributed`` in chunks of
    ``rounds_per_call`` rounds with a checkpoint after each, and a second
    run restarted from the full matrix gathered at round ``restart_at``."""
    ckpts, saved = [], {}

    def keep(b, block):
        ckpts.append(b)
        if b == restart_at:
            saved["w"] = gather(block, mesh)

    first = fw_distributed(w, mesh, rounds_per_call=rounds_per_call, checkpoint_cb=keep,
                           **kw)
    again = fw_distributed(saved["w"], mesh, rounds_per_call=rounds_per_call,
                           start_round=restart_at, **kw)
    return first, again, ckpts


def _check_chunked(mesh, w, cfg, s, sr, backend, want) -> bool:
    rounds = w.shape[-1] // s
    rpc = cfg.get("rounds_per_call", max(1, rounds // 4))
    restart_at = cfg.get("restart_at", rpc * (rounds // rpc // 2))
    first, again, ckpts = _chunked(mesh, w, rpc, restart_at, block_size=s, semiring=sr,
                                   backend=backend)
    want_ckpts = [min(b, rounds) for b in range(rpc, rounds + rpc, rpc)]
    return ckpts == want_ckpts and same(first, want) and same(again, want)


def _breakdown(w, s, want, sr: Semiring) -> tuple[dict, bool]:
    """Device time by launch kind of a 1×1 grid's fused rounds (CUDA events
    between launches; each share includes the gap after it): the owner's
    three border copies and the three bordered launches a round."""
    n = w.shape[-1]
    buf = w.new_empty((s + n, s + n))
    buf[s:, s:] = w
    loc = buf[s:, s:]
    bands = fr.bordered_round_buffers(buf, s)
    steps = []
    for b in range(n // s):
        o = slice(b * s, (b + 1) * s)

        def copies(o=o):
            buf[:s, :s] = loc[o, o]
            buf[:s, s:] = loc[o, :]
            buf[s:, :s] = loc[:, o]

        steps.append(("border copies", copies))
        steps += [(f"fw_round_bordered/{p}",
                   functools.partial(fr.fw_round_bordered_phase, p, buf, b + 1, b + 1, bands,
                                     block_size=s, semiring=sr)) for p in fr.PHASES]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(steps) + 1)]
    torch.cuda.synchronize()
    for (_, launch), e in zip(steps, ev):
        e.record()
        launch()
    ev[-1].record()
    torch.cuda.synchronize()
    per: dict[str, float] = {}
    for (kind, _), a, b in zip(steps, ev, ev[1:]):
        per[kind] = per.get(kind, 0.0) + a.elapsed_time(b)
    per["span"] = ev[0].elapsed_time(ev[-1])
    return per, same(loc, want)


def lowered_repair_scenario(sr: Semiring, n: int, seed: int = 0, edges: int = 2):
    """(w, updates) of a repair that is exact in sr's storage: packed — one
    plane of ``packed_words``, each update an int32 mask of the lanes that
    gain the edge; otherwise min-plus integer weights in
    [1, 16] (path sums far below 256, exact in bf16, f16 and int16), a
    missing edge the ⊕-identity, each update an improving weight 1."""
    rng = np.random.default_rng(seed)
    uv = [(int(u), int(v)) for u, v in rng.integers(0, n, (edges, 2))]
    if sr.packed:
        masks = rng.integers(-(1 << 31), 1 << 31, edges)
        return packed_words(n, 1, seed, "cpu"), [(u, v, int(m)) for (u, v), m in zip(uv, masks)]
    w = rng.integers(1, 17, (n, n)).astype(np.float32)
    w[rng.uniform(size=(n, n)) > max(0.02, min(0.3, 16.0 / n))] = np.inf
    np.fill_diagonal(w, 0.0)
    return w, [(u, v, 1.0) for u, v in uv]


def _check_repair(mesh, cfg: dict) -> dict:
    """Mesh repair == single-device repair == re-solve of the updated graph;
    in a lowered storage on ``lowered_repair_scenario``."""
    dev = mesh.device
    name, n = cfg["semiring"], cfg["n"]
    sr = storage_semiring(cfg)
    if _lowered(cfg):
        w0, upd = lowered_repair_scenario(sr, n, seed=cfg.get("seed", 0),
                                          edges=cfg.get("edges") or 2)
        w1, baseline = _apply_lowered(w0, upd, sr), "fused"
    else:
        w0, upd, baseline = repair_scenario(name, n, seed=cfg.get("seed", 0),
                                            edges=cfg.get("edges"))
        w1 = apply_updates(w0, upd, name)
    kw = dict(semiring=sr, dtype=cfg.get("dtype"), validate=False, device=dev.type)
    single = ApspEngine(method=baseline, **kw)
    dist = ApspEngine(method="distributed", mesh=mesh, **kw)
    d0 = single.solve(w0).dist
    mesh.comm_bytes = 0
    rd = dist.repair(d0, upd).dist
    comm = mesh.comm_bytes
    rs = single.repair(d0, upd).dist
    want = single.solve(w1).dist
    rec = dict(rank=mesh.rank, R=mesh.R, C=mesh.C, n=n, semiring=sr.name, edges=len(upd),
               dtype=str(rd.dtype).removeprefix("torch."), repair=True, comm_bytes=comm,
               ok=same(rd, rs) and same(rs, want))
    del rd, rs, want
    if cfg.get("reps"):
        rec["ms"], rec["times"] = _median_ms(lambda: dist.repair(d0, upd), dev, cfg["reps"])
        rec["single_ms"], _ = _median_ms(lambda: single.repair(d0, upd), dev, cfg["reps"])
    else:
        dist.repair(d0, upd)  # warm: no new runner
    rec["traces"] = sorted(e.traces for e in dist._cache.values())
    rec["ok"] = rec["ok"] and all(t == 1 for t in rec["traces"])
    return rec


def _check_engine(mesh, cfg: dict) -> dict:
    """The mesh engine's ``solve_many`` of ragged graphs == the
    single-device fused solve of each; a warm pass builds no new runner."""
    dev = mesh.device
    sr, s = storage_semiring(cfg), cfg.get("bs")
    eng = ApspEngine(method="distributed", mesh=mesh, semiring=sr, dtype=cfg.get("dtype"),
                     block_size=s, validate=False, device=dev.type)
    sizes = [cfg["n"], max(cfg["n"] // 2, 2 * s), cfg["n"]]
    graphs = [_inputs(dict(cfg, n=nn, batch=1, seed=i), dev, sr) for i, nn in enumerate(sizes)]
    results = eng.solve_many(graphs)
    ok = all(same(r.dist, solve(g, method="fused", block_size=r.block_size, semiring=sr,
                                validate=False, device=dev.type).dist)
             for g, r in zip(graphs, results))
    eng.solve_many(graphs)
    traces = sorted(e.traces for e in eng._cache.values())
    return dict(rank=mesh.rank, R=mesh.R, C=mesh.C, n=cfg["n"], sizes=sizes, semiring=sr.name,
                dtype=str(results[0].dist.dtype).removeprefix("torch."), method="engine",
                cache=eng.cache_size, hits=eng.stats.hits, traces=traces,
                ok=ok and all(t == 1 for t in traces))


def _check_repair_del(mesh, cfg: dict) -> dict:
    """Mesh repair_del == single-device repair_del == re-solve of the
    deleted graph (plus_mul: its fallback == the mesh engine's re-solve),
    from a mesh solve == the single-device one."""
    from repro_torch.launch import fw_serve

    dev = mesh.device
    name, n = cfg["semiring"], cfg["n"]
    sr = SEMIRINGS[name]
    w0, _, baseline = fw_serve.repair_scenario(name, n, seed=cfg.get("seed", 0))
    kw = dict(semiring=sr, validate=False, device=dev.type)
    single = ApspEngine(method=baseline, **kw)
    dist = ApspEngine(method="distributed", mesh=mesh, **kw)
    d0 = single.solve(w0).dist
    ok = name == "plus_mul" or same(dist.solve(w0).dist, d0)  # plus_mul: naive baseline
    dels, w1 = fw_serve.pick_deletions(w0, d0, name)
    if not dels:  # plus_mul: no on-path edge; any deleted edge takes the fallback
        u, v = next((int(u), int(v)) for u, v in np.argwhere(w0 != sr.zero) if u != v)
        dels, w1 = [(u, v, float(w0[u, v]))], np.array(w0, copy=True)
        w1[u, v] = sr.zero
    rd = dist.repair_del(d0, w1, dels, threshold=100.0).dist
    rs = single.repair_del(d0, w1, dels, threshold=100.0).dist
    want = single.solve(w1).dist
    if name == "plus_mul":
        ok = (ok and dist.stats.repair_del_fallbacks >= 1
              and same(rd, dist.solve(w1).dist) and same(rs, want))
    else:
        ok = ok and same(rd, rs) and same(rs, want) and dist.stats.repair_dels >= 1
        dist.repair_del(d0, w1, dels, threshold=100.0)  # warm: no new runner
    traces = sorted(e.traces for e in dist._cache.values()
                    if e.key.method.startswith("repair_del"))
    return dict(rank=mesh.rank, R=mesh.R, C=mesh.C, n=n, semiring=name, edges=len(dels),
                dtype=str(rd.dtype).removeprefix("torch."), repair_del=True,
                sweeps=dist.stats.repair_dels, fallbacks=dist.stats.repair_del_fallbacks,
                traces=traces, ok=ok and all(t == 1 for t in traces))


def _lowered(cfg: dict) -> bool:
    """Does cfg ask for a storage lowering (not f32)?"""
    return (cfg.get("dtype") not in (None, "float32") or bool(cfg.get("packed"))
            or resolve_semiring(cfg["semiring"]).dtype is not None)


def _apply_lowered(w0, upd, sr: Semiring):
    """The updated weights of ``lowered_repair_scenario``: the improved
    weight (min) or the gained lanes (OR)."""
    w1 = w0.clone() if sr.packed else np.array(w0, copy=True)
    for u, v, x in upd:
        if sr.packed:
            w1[..., u, v] |= x
        else:
            w1[u, v] = min(w1[u, v], x)
    return w1


def run_cases(mesh, cases: list[dict]) -> list[dict]:
    """Raw results of each case on this rank, as numpy arrays, for a test to
    hold against the reference.  Kinds: "direct" (``fw_distributed`` of w,
    gathered, with the bytes counted), "solve" (``solve(method=
    "distributed")``), "chunked" (checkpointed run and its restart),
    "repair" / "repair_del" (the mesh engine's ``repair`` / ``repair_del``
    of a closure), "engine" (``ApspEngine.solve_many`` twice, with the plan
    cache's builds), "refusals" (the message of each successor request the
    mesh engine refuses), "imports" (whether the rank has loaded ``jax`` or
    ``repro``), "grid_check" (``grid_check`` of the case's "cfgs"),
    "broadcast" (each of the case's per-rank tensors broadcast over the
    world, the rank's grid row and its grid column, as received), "router"
    (a ``serve.routing.RoutingEngine`` on the grid: the case's graphs
    added and refreshed, its improvements (``update_edge``) applied and
    refreshed, then its link failures (``fail_link``, one direction);
    each graph's published table and weights, the refresh arms and the
    engine's sweep / fallback counts).

    A case's "semiring" may name a lowering; "dtype" casts its float input
    (bf16 travels as f32 numpy, which has no bf16) and pins an engine's
    storage, "packed" runs ``solve`` / the engine on packed or_and words.
    Results come back in their storage dtype, bf16 widened to f32 (exact)
    and named in "dtype"."""
    return [_run_case(mesh, case) for case in cases]


def _broadcasts(mesh, data: dict) -> dict:
    """data: {dtype name: [each rank's numpy array]} (bf16 by its int16
    bits).  Every rank broadcasts its own array from rank 1 over the world,
    from column 0 along its grid row and from row 0 along its grid column;
    returns what it received (bf16 as int16 bits) and the bytes counted."""
    out, mesh.comm_bytes = {}, 0
    for name, per_rank in data.items():
        own = torch.from_numpy(per_rank[mesh.rank])
        if name == "bfloat16":
            own = own.view(torch.bfloat16)
        for label, group, src in (("world", None, 1),
                                  ("row", mesh.row_group, mesh.rank_of(mesh.my_r, 0)),
                                  ("col", mesh.col_group, mesh.rank_of(0, mesh.my_c))):
            t = own.clone().to(mesh.device)
            mesh.broadcast(t, src, group)
            t = t.cpu()
            out[(name, label)] = (src, (t.view(torch.int16) if name == "bfloat16"
                                        else t).numpy())
    return dict(received=out, comm_bytes=mesh.comm_bytes)


def _host(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _router(mesh, case: dict) -> dict:
    from repro_torch.serve.routing import RoutingEngine

    router = RoutingEngine(mesh=mesh, device=mesh.device.type, block_size=case.get("bs"))
    for g, w in case["graphs"].items():
        router.add_graph(g, w)
    router.refresh()
    for g, u, v, x in case.get("updates", ()):
        router.update_edge(g, u, v, x)
    router.refresh()
    for g, u, v in case.get("failures", ()):
        router.fail_link(g, u, v, symmetric=False)
    router.refresh()
    snaps = {g: router.snapshots.active(g) for g in case["graphs"]}
    return dict(dists={g: s.dist for g, s in snaps.items()},
                succ=[s.succ for s in snaps.values()],
                weights={g: router.registry.peek(g) for g in case["graphs"]},
                arms=(router.solve_refreshes, router.repair_refreshes,
                      router.repair_del_refreshes),
                sweeps=router.engine.stats.repair_dels,
                fallbacks=router.engine.stats.repair_del_fallbacks)


def _run_case(mesh, case: dict) -> dict:
    dev = mesh.device
    kind = case["kind"]
    sr = resolve_semiring(case.get("semiring", "min_plus"))
    dtype, packed = case.get("dtype"), case.get("packed", False)
    host = _host
    if kind == "imports":
        return {name: name in sys.modules for name in ("jax", "repro")}
    if kind == "grid_check":
        return dict(recs=grid_check(mesh, case["cfgs"]))
    if kind == "broadcast":
        return _broadcasts(mesh, case["data"])
    if kind == "router":
        return _router(mesh, case)
    if kind == "engine":
        eng = ApspEngine(method="distributed", mesh=mesh, semiring=sr, dtype=dtype,
                         packed=packed, block_size=case.get("bs"), validate=False,
                         device=dev.type)
        first = eng.solve_many(case["graphs"])
        misses = eng.stats.misses
        eng.solve_many(case["graphs"])
        return dict(dists=[host(r.dist) for r in first], misses=misses,
                    hits=eng.stats.hits, cache_size=eng.cache_size,
                    dtype=str(first[0].dist.dtype).removeprefix("torch."),
                    traces=[e.traces for e in eng._cache.values()])
    if kind in ("repair", "repair_del", "refusals"):
        eng = ApspEngine(method="distributed", mesh=mesh, semiring=sr, dtype=dtype,
                         packed=packed, validate=False, device=dev.type)
        if kind == "repair":
            res = eng.repair(case["dist"], case["updates"])
            return dict(dist=host(res.dist), padded_n=res.padded_n,
                        dtype=str(res.dist.dtype).removeprefix("torch."))
        if kind == "repair_del":
            res = eng.repair_del(case["dist"], case["w1"], case["deletions"],
                                 threshold=case.get("threshold", 0.5))
            return dict(dist=host(res.dist), sweeps=eng.stats.repair_dels,
                        fallbacks=eng.stats.repair_del_fallbacks,
                        dtype=str(res.dist.dtype).removeprefix("torch."))
        w = case["w"]
        d = eng.solve(w).dist
        calls = dict(solve=lambda: eng.solve(w, successors=True),
                     repair=lambda: eng.repair(d, [(0, 1, 1.0)], succ=d.int()),
                     repair_del=lambda: eng.repair_del(d, w, [(0, 1, 1.0)], succ=d.int()))
        out = {}
        for name, call in calls.items():
            try:
                call()
                out[name] = None
            except ValueError as e:
                out[name] = str(e)
        return out
    w = torch.as_tensor(case["w"]).to(dev)
    s = case.get("bs")
    if kind == "solve":
        res = solve(w, method="distributed", mesh=mesh, semiring=sr, dtype=dtype,
                    packed=packed, block_size=s, validate=False, device=dev.type)
        return dict(dist=host(res.dist), block_size=res.block_size, padded_n=res.padded_n,
                    dtype=str(res.dist.dtype).removeprefix("torch."))
    if dtype is not None:
        w = w.to(getattr(torch, dtype))
    kw = dict(block_size=s, semiring=sr, backend=case.get("backend", "fused"))
    if kind == "direct":
        mesh.comm_bytes = 0
        local = fw_distributed(w, mesh, **kw)
        comm = mesh.comm_bytes
        return dict(dist=host(gather(local, mesh)), comm_bytes=comm)
    if kind == "chunked":
        first, again, ckpts = _chunked(mesh, w, case["rounds_per_call"], case["restart_at"],
                                       **kw)
        return dict(dist=host(gather(first, mesh)), restarted=host(gather(again, mesh)),
                    ckpts=ckpts)
    raise ValueError(f"unknown case kind {kind!r}")


# --------------------------------------------------------------------- CLI
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=4, help="ranks of the grid")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--bs", type=int, default=32)
    ap.add_argument("--semiring", default="min_plus",
                    choices=sorted(SEMIRINGS) + sorted(LOWERED_SEMIRINGS))
    ap.add_argument("--dtype", default="float32", choices=STORAGES,
                    help="the storage (int16: the semiring's saturating lowering)")
    ap.add_argument("--packed", action="store_true",
                    help="or_and on packed words, 32 graphs a word")
    ap.add_argument("--backend", default="fused", choices=["fused", "jnp", "pallas"])
    ap.add_argument("--method", default="direct", choices=["direct", "solve", "engine"])
    ap.add_argument("--batch", type=int, default=1,
                    help="solve mode: close B graphs through one batched solve")
    ap.add_argument("--bitwise", action="store_true",
                    help="hold against the single-device fused solve, bitwise")
    ap.add_argument("--chunked", action="store_true",
                    help="direct mode in chunks, restarted from a checkpoint")
    ap.add_argument("--repair", action="store_true",
                    help="mesh repair == single-device repair == re-solve")
    ap.add_argument("--repair-del", action="store_true", dest="repair_del",
                    help="mesh repair_del == single-device repair_del == re-solve")
    ap.add_argument("--pods", type=int, default=1,
                    help="the grid of plan.mesh_factorization(--devices, --pods)")
    ap.add_argument("--bench", action="store_true",
                    help="print METRICS json: per-round ms and collective bytes")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.batch > 1 and not (args.method == "solve" and args.bitwise):
        ap.error("--batch needs --method solve --bitwise")
    if args.repair_del and (args.dtype != "float32" or args.packed
                            or args.semiring not in SEMIRINGS):
        ap.error("--repair-del runs the f32 semirings")
    R, C = plan.mesh_factorization(args.devices, args.pods)
    cfg = dict(n=args.n, bs=args.bs, semiring=args.semiring, backend=args.backend,
               method=args.method, batch=args.batch, bitwise=args.bitwise,
               chunked=args.chunked, repair=args.repair, repair_del=args.repair_del,
               reps=3 if args.bench else 0, dtype=args.dtype, packed=args.packed)
    try:
        sr = storage_semiring(cfg)
    except ValueError as err:
        ap.error(str(err))
    if _lowered(cfg) and not (args.bitwise or args.repair or args.method == "engine"):
        ap.error("a lowered storage needs --bitwise (or --repair, --method engine): it "
                 "holds against the lowered single-device fused solve")
    if args.device == "cuda":
        from repro_torch.kernels import _build

        # once, before the ranks load them: the round (and the matmul of the
        # "pallas" backend) in f32 and the lowerings; the repair's for --repair
        _build.build_all(("fw_round", "fw_round_lowered", "minplus_matmul",
                          "minplus_matmul_lowered")
                         + (("fw_repair", "fw_repair_lowered") if args.repair else ())
                         + (("fw_repair_del",) if args.repair_del else ()))
    recs = [r[0] for r in run_grid(grid_check, R, C, device=args.device, args=([cfg],))]
    bad = [r["rank"] for r in recs if not (r["ok"] and r.get("chunked_ok", True))]
    mode = ("repair" if args.repair else "repair_del" if args.repair_del else
            "engine" if args.method == "engine" else
            f"{'bitwise' if args.bitwise else 'allclose'} method={args.method}")
    bs = recs[0].get("block_size", args.bs)
    where = (f"devices={args.devices} grid={R}x{C} n={args.n} bs={bs} "
             f"semiring={sr.name} dtype={recs[0]['dtype']} backend={args.backend} "
             f"device={args.device}")
    if bad:
        print(f"FAIL {mode} on ranks {bad}: {where}", file=sys.stderr)
        return 1
    if args.bench:
        r0 = recs[0]
        rounds = r0["rounds"]
        dp = plan.distributed_plan(args.n, args.devices, grid=(R, C), block_size=args.bs,
                                   word=plan.word_for(recs[0]["dtype"]))
        metrics = dict(
            ndev=args.devices, R=R, C=C, n=args.n, bs=args.bs, backend=args.backend,
            device=args.device, rounds=rounds, solve_ms=r0["ms"],
            round_ms=r0["ms"] / rounds,
            comm_counted_bytes=[r["comm_bytes"] / rounds for r in recs],
            comm_model_bytes=dp["comm_bytes_per_round"],
            summa_bound_bytes_per_round=dp["summa_bound_bytes"] / rounds,
            comm_model_efficiency=dp["comm_model_efficiency"],
        )
        if not all(r["comm_bytes"] == r["model_bytes"] for r in recs):
            print(f"FAIL counted collective bytes != model: {metrics}", file=sys.stderr)
            return 1
        print("METRICS " + json.dumps(metrics))
    extra = (f" padded={recs[0]['padded_n']}" if "padded_n" in recs[0] else
             f" sizes={recs[0]['sizes']} cache={recs[0]['cache']} hits={recs[0]['hits']}"
             if "sizes" in recs[0] else
             f" edges={recs[0]['edges']} sweeps={recs[0]['sweeps']}" if args.repair_del else "")
    print(f"OK {mode}{' chunked' if args.chunked else ''} {where} batch={args.batch}{extra}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
