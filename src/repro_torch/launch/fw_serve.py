"""Serving load generator + smoke guard for the port's APSP serving stack.

Counterpart of ``repro.launch.fw_serve`` on the port.

Usage: PYTHONPATH=src python -m repro_torch.launch.fw_serve [--graphs 8]
           [--n 256] [--queries 2000] [--update-every 50] [--device cuda]
       PYTHONPATH=src python -m repro_torch.launch.fw_serve --smoke
           [--device cpu]

Default mode drives a mixed query/update load through
``serve.routing.RoutingEngine``: G registered graphs, mostly path queries
(some through the micro-batching scheduler), an ⊕-improving
``update_edge`` every ``--update-every`` queries so refreshes alternate
between the rank-1 repair fast path and full re-solves.  Reports
per-query p50/p99 latency and QPS, and prints a ``METRICS {json}`` line.

``--smoke`` checks, on ``--device`` (default the card):

  * bitwise repair-vs-resolve across all five semirings + the int16 and
    bit-packed lowerings (``repair_scenario`` below builds per-semiring
    inputs satisfying the repair kernel's exactness conditions);
  * bitwise repair_del-vs-resolve (decremental: deletions/worsenings) on
    the same semiring × lowering grid, sweep and fallback arms both,
    plus the serving-side ``fail_link`` → ``repair_del`` refresh route;
  * successor-table repair == re-solve on tie-free weights;
  * snapshot consistency mid-refresh (a reader's snapshot is immutable
    across a racing publish);
  * a mini load-gen pass through the scheduler.

The reference's smoke also diffs the keys of its benchmark file; the
port's benchmark file is a later piece of work (ROADMAP A.2), so that
step is left out here.

``repair_scenario``, ``pick_deletions`` and ``_apply_updates`` are this
module's own copies of the reference's (numpy in, numpy out), so the same
seed gives the same matrices in both packages.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def repair_scenario(semiring: str, n: int, seed: int = 0):
    """Per-semiring (W, updates, baseline_method) satisfying repair exactness.

    The constructions mirror the repair kernel's documented conditions
    (kernels/fw_repair.py): updates are ⊕-improvements, and for the
    non-idempotent plus_mul the graph is a DAG (strict upper triangle) with
    additive deltas and path counts far below f32's 2^24 integer range.
    ``baseline_method`` is the solve method whose closure the repair must
    reproduce bitwise — "naive" for plus_mul because the blocked/fused
    pivot-block re-relaxation over-counts under a non-idempotent ⊕ (only
    plain FW equals the true path-sum closure there).
    """
    rng = np.random.default_rng(seed)
    if semiring == "min_plus":
        # Tie-free: large random integer weights make shortest paths unique
        # with overwhelming probability → successor tables compare bitwise.
        w = rng.integers(1, 10**6, (n, n)).astype(np.float32)
        w[rng.uniform(size=(n, n)) > 0.4] = np.inf
        np.fill_diagonal(w, 0.0)
        upd = [(3, 7, 5.0), (n // 2, 2, 3.0), (1, n - 2, 17.0)]
        return w, upd, "fused"
    if semiring == "max_plus":
        # Longest path needs a DAG; improvements increase edge weights.
        w = np.full((n, n), -np.inf, np.float32)
        iu = np.triu_indices(n, 1)
        mask = rng.uniform(size=len(iu[0])) < 0.3
        w[iu[0][mask], iu[1][mask]] = rng.integers(1, 100, mask.sum()).astype(
            np.float32
        )
        np.fill_diagonal(w, 0.0)
        upd = [(3, n // 2, 500.0), (1, n - 2, 400.0)]
        return w, upd, "fused"
    if semiring == "max_min":
        # Widest path: diagonal is the ⊗-identity +inf; capacity increases.
        w = rng.integers(1, 100, (n, n)).astype(np.float32)
        w[rng.uniform(size=(n, n)) > 0.4] = -np.inf
        np.fill_diagonal(w, np.inf)
        upd = [(3, 7, 1000.0), (n // 2, 2, 900.0)]
        return w, upd, "fused"
    if semiring == "or_and":
        w = (rng.uniform(size=(n, n)) < 0.05).astype(np.float32)
        np.fill_diagonal(w, 1.0)
        upd = [(3, 7, 1.0), (n - 2, 9, 1.0)]
        return w, upd, "fused"
    if semiring == "plus_mul":
        # Sparse strict-upper DAG with unit weights: the closure counts
        # paths (small integers); updates are additive edge deltas.
        w = np.zeros((n, n), np.float32)
        iu = np.triu_indices(n, 1)
        mask = rng.uniform(size=len(iu[0])) < 0.08
        w[iu[0][mask], iu[1][mask]] = 1.0
        np.fill_diagonal(w, 0.0)
        upd = [(3, n // 2, 1.0), (1, n - 2, 1.0)]
        return w, upd, "naive"
    raise ValueError(f"no repair scenario for semiring {semiring!r}")


def _host(a) -> np.ndarray:
    """A table (tensor on any device, or array) as a host numpy array."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def pick_deletions(w, dist, semiring: str, count: int = 3):
    """Deleted-edge batch for the decremental smoke: edges lying ON
    shortest paths (``w[u,v] == dist[u,v] ≠ 0̄``), so the affected set is
    non-empty and ``repair_del`` actually dispatches its restricted sweep
    (an off-path deletion is the cheap no-op exit, tested separately).

    Returns (deletions, w1): the ``(u, v, w_old)`` triples
    ``ApspEngine.repair_del`` takes, and the updated weight matrix with
    those edges removed (set to the ⊕-identity).
    """
    from repro_torch.core.semiring import SEMIRINGS

    sr = SEMIRINGS[semiring]
    w = _host(w)
    d = _host(dist)
    dels: list[tuple[int, int, float]] = []
    w1 = np.array(w, copy=True)
    for u, v in np.argwhere((w == d) & (w != sr.zero)):
        if u == v:
            continue
        dels.append((int(u), int(v), float(w[u, v])))
        w1[u, v] = sr.zero
        if len(dels) == count:
            break
    return dels, w1


def _apply_updates(w, updates, semiring: str):
    """The updated weight matrix a full re-solve should close: each update
    merged into its edge under the semiring's ⊕ (the port's, which follows
    the reference's on NaN and signed zeros)."""
    from repro_torch.core.semiring import SEMIRINGS

    sr = SEMIRINGS[semiring]
    w1 = np.array(w, copy=True)
    for u, v, d in updates:
        old = torch.from_numpy(np.array(w1[u, v]))
        w1[u, v] = sr.add(old, torch.from_numpy(np.asarray(d, w1.dtype))).numpy()
    return w1


def smoke(*, device="cuda") -> int:
    """The checks of the module docstring on ``device``; 0 when all pass,
    1 (with a FAIL line on stderr) at the first that does not."""
    from repro_torch.apsp import ApspEngine, pack_reachability
    from repro_torch.core.semiring import I16_INF
    from repro_torch.serve.snapshot import host_tensor
    from repro_torch.utils.bits import bits_equal

    def engine(**kw):
        return ApspEngine(validate=False, device=device, **kw)

    n = 48
    # 1) bitwise repair == re-solve, all five semirings (f32).
    for name in ("min_plus", "max_plus", "max_min", "or_and", "plus_mul"):
        w, upd, baseline = repair_scenario(name, n)
        eng = engine(method=baseline, semiring=name)
        r0 = eng.solve(w)
        rep = eng.repair(r0.dist, upd)
        r1 = eng.solve(_apply_updates(w, upd, name))
        if not bits_equal(rep.dist, r1.dist):
            print(f"FAIL repair != resolve for {name}", file=sys.stderr)
            return 1
    print("smoke: repair == re-solve bitwise (5 semirings, f32)")

    # 1b) decremental: repair_del == re-solve bitwise, all five semirings.
    # Deletions are on-shortest-path edges and the threshold is forced high
    # (at n=48 a deletion touches most rows, so the byte model would
    # correctly prefer re-solve) so the restricted sweep actually
    # dispatches; plus_mul routes through its documented full-solve
    # fallback (non-idempotent ⊕) and must still be bitwise.
    sweeps = 0
    for name in ("min_plus", "max_plus", "max_min", "or_and", "plus_mul"):
        w, _, baseline = repair_scenario(name, n)
        eng = engine(method=baseline, semiring=name)
        r0 = eng.solve(w)
        dels, w1 = pick_deletions(w, r0.dist, name)
        rep = eng.repair_del(r0.dist, w1, dels, threshold=100.0)
        r1 = eng.solve(w1)
        if not bits_equal(rep.dist, r1.dist):
            print(f"FAIL repair_del != resolve for {name}", file=sys.stderr)
            return 1
        sweeps += eng.stats.repair_dels
        if name == "plus_mul" and eng.stats.repair_del_fallbacks != 1:
            print("FAIL plus_mul repair_del did not fall back",
                  file=sys.stderr)
            return 1
    if sweeps < 3:
        print(f"FAIL only {sweeps} repair_del sweeps dispatched",
              file=sys.stderr)
        return 1
    print("smoke: repair_del == re-solve bitwise (5 semirings, f32, "
          f"{sweeps} sweeps)")

    # 2) int16 storage lowering (dtype pins it — else ints promote to f32).
    rng = np.random.default_rng(1)
    wi = rng.integers(1, 997, (n, n)).astype(np.int16)
    wi[rng.uniform(size=(n, n)) > 0.4] = I16_INF
    np.fill_diagonal(wi, 0)
    eng = engine(method="fused", semiring="min_plus", dtype=torch.int16)
    r0 = eng.solve(wi)
    upd = [(3, 7, 1), (10, 2, 2)]
    rep = eng.repair(r0.dist, upd)
    w1 = wi.copy()
    for u, v, d in upd:
        w1[u, v] = min(int(w1[u, v]), d)
    r1 = eng.solve(w1)
    if not bits_equal(rep.dist, r1.dist):
        print("FAIL int16 repair != resolve", file=sys.stderr)
        return 1
    print("smoke: repair == re-solve bitwise (min_plus int16)")

    # 2b) decremental on the storage lowerings: int16 and bf16.
    for dt in (torch.int16, torch.bfloat16):
        wlow = rng.integers(1, 120, (n, n)).astype(np.float32)
        wlow[rng.uniform(size=(n, n)) > 0.4] = np.inf
        np.fill_diagonal(wlow, 0.0)
        leng = engine(method="fused", semiring="min_plus", dtype=dt)
        r0 = leng.solve(wlow)
        df = r0.dist.double().cpu().numpy()
        dels, w1 = [], wlow.copy()
        for u, v in np.argwhere(
            np.isclose(wlow, df) & np.isfinite(wlow)
        ):
            if u != v:
                dels.append((int(u), int(v), float(wlow[u, v])))
                w1[u, v] = np.inf
            if len(dels) == 3:
                break
        rep = leng.repair_del(r0.dist, w1, dels, threshold=100.0)
        r1 = leng.solve(w1)
        if not (leng.stats.repair_dels == 1 and bits_equal(rep.dist, r1.dist)):
            print(f"FAIL {str(dt).removeprefix('torch.')} repair_del != resolve",
                  file=sys.stderr)
            return 1
    print("smoke: repair_del == re-solve bitwise (min_plus int16 + bf16)")

    # 3) bit-packed or_and: an update (u, v, mask) adds edge u→v in the
    # graphs whose int32 bit lanes are set in ``mask``.
    rng = np.random.default_rng(9)
    Bs = rng.uniform(size=(2, n, n)) < 0.05
    Bs[:, np.arange(n), np.arange(n)] = True
    peng = engine(method="fused", semiring="or_and", packed=True)
    p0 = peng.solve(pack_reachability(Bs.astype(np.float32)))
    # edge 3→7 in lane 0 only; edge 40→9 in both lanes
    rep = peng.repair(p0.dist, [(3, 7, 1 << 0), (40, 9, 0b11)])
    B1 = Bs.copy()
    B1[0, 3, 7] = True
    B1[:, 40, 9] = True
    p1 = peng.solve(pack_reachability(B1.astype(np.float32)))
    if not bits_equal(rep.dist, p1.dist):
        print("FAIL packed repair != resolve", file=sys.stderr)
        return 1
    print("smoke: repair == re-solve bitwise (packed or_and)")

    # 3b) packed word-plane deletion: clear edge 3→7 in lane 0 and edge
    # 40→9 in every lane; the old word bits are the witness weights.
    r0 = peng.solve(pack_reachability(B1.astype(np.float32)))
    B2 = B1.copy()
    B2[0, 3, 7] = False
    B2[:, 40, 9] = False
    words2 = pack_reachability(B2.astype(np.float32))
    dels = [(3, 7, 1 << 0), (40, 9, 0b11)]
    rep = peng.repair_del(r0.dist, words2, dels, threshold=100.0)
    p2 = peng.solve(words2)
    if not bits_equal(rep.dist, p2.dist):
        print("FAIL packed repair_del != resolve", file=sys.stderr)
        return 1
    print("smoke: repair_del == re-solve bitwise (packed or_and lanes)")

    # 4) successor-table repair (tie-free weights → bitwise).
    w, upd, _ = repair_scenario("min_plus", n, seed=2)
    eng = engine(method="fused")
    r0 = eng.solve(w, successors=True)
    rep = eng.repair(r0.dist, upd, succ=r0.succ)
    r1 = eng.solve(_apply_updates(w, upd, "min_plus"), successors=True)
    if not (bits_equal(rep.dist, r1.dist) and bits_equal(rep.succ, r1.succ)):
        print("FAIL successor repair != resolve", file=sys.stderr)
        return 1
    print("smoke: successor repair == re-solve bitwise (dist AND succ)")

    # 4b) successor-table decremental repair, both policy arms: a forced
    # sweep (threshold=100.0) and a forced fallback (threshold=0.0) must
    # each equal the re-solve bitwise — dist AND succ.
    for thr, arm in ((100.0, "sweep"), (0.0, "fallback")):
        w, _, _ = repair_scenario("min_plus", n, seed=4)
        eng = engine(method="fused")
        r0 = eng.solve(w, successors=True)
        dels, w1 = pick_deletions(w, r0.dist, "min_plus")
        rep = eng.repair_del(r0.dist, w1, dels, succ=r0.succ, threshold=thr)
        r1 = eng.solve(w1, successors=True)
        if not (bits_equal(rep.dist, r1.dist) and bits_equal(rep.succ, r1.succ)):
            print(f"FAIL successor repair_del != resolve ({arm})",
                  file=sys.stderr)
            return 1
        took_sweep = eng.stats.repair_dels == 1
        if took_sweep != (arm == "sweep"):
            print(f"FAIL successor repair_del wrong arm ({arm})",
                  file=sys.stderr)
            return 1
    print("smoke: successor repair_del == re-solve bitwise (both arms)")

    # 5) snapshot consistency mid-refresh + a mini scheduler pass.
    from repro_torch.serve.routing import RoutingEngine

    w, upd, _ = repair_scenario("min_plus", 32, seed=3)
    router = RoutingEngine(method="naive", device=device)
    router.add_graph("g", w)
    router.refresh()
    held = router.snapshots.active("g")
    held_dist = held.dist.copy()
    router.update_edge("g", *upd[0])
    router.query("g", 0, 5)  # auto_refresh publishes a new snapshot
    if not (held.version == 1
            and np.array_equal(held.dist, held_dist)
            and router.snapshots.active("g").version == 2):
        print("FAIL mid-refresh snapshot mutated", file=sys.stderr)
        return 1
    tickets = [router.submit("g", 0, d) for d in range(1, 6)]
    replies = [t.result() for t in tickets]
    if router.batcher.flushes != 1 or len(replies) != 5:
        print("FAIL scheduler flush", file=sys.stderr)
        return 1
    print("smoke: snapshots consistent mid-refresh; scheduler flushed 5-in-1")

    # 5b) serving-side decremental: fail_link records the deletion and the
    # refresh routes through repair_del (counted), published table equal to
    # a from-scratch solve.
    d_act = router.snapshots.active("g").dist
    wg = router.registry.peek("g")
    cand = np.argwhere(
        np.isfinite(wg) & (wg == d_act) & ~np.eye(wg.shape[0], dtype=bool)
    )
    router.fail_link("g", int(cand[0][0]), int(cand[0][1]), symmetric=False)
    if not router.registry.pending_deletions("g"):
        print("FAIL fail_link did not record a deletion", file=sys.stderr)
        return 1
    router.refresh()
    full = router.engine.solve(router.registry.peek("g"), successors=True)
    snap = router.snapshots.active("g")
    if not (router.repair_del_refreshes == 1
            and bits_equal(host_tensor(snap.dist, snap.dtype), full.dist.cpu())
            and bits_equal(snap.succ_tensor(), full.succ.cpu())):
        print("FAIL fail_link refresh != resolve via repair_del",
              file=sys.stderr)
        return 1
    print("smoke: fail_link → repair_del refresh == re-solve (dist AND succ)")
    return 0


def run_load(
    *,
    graphs: int = 8,
    n: int = 256,
    queries: int = 2000,
    update_every: int = 50,
    scheduler_share: float = 0.25,
    max_batch: int = 16,
    method: str = "auto",
    seed: int = 0,
    device="cuda",
    router=None,
) -> dict:
    """Drive a mixed query/update load; returns the metrics dict.

    Every ``update_every``-th operation merges an ⊕-improving edge update
    into a random graph, so the next query of that graph pays a refresh —
    a rank-1 repair while the backlog is small (``should_repair``), a full
    re-solve otherwise.  ``scheduler_share`` of queries go through the
    micro-batcher (``submit`` + ``poll``); the rest are inline ``query``
    calls, individually timed for the latency percentiles.  ``router``: a
    prepared ``RoutingEngine`` that already holds the graphs g0 .. g{G-1}
    (then ``method`` / ``max_batch`` / ``device`` are its own, and no
    graph is added or refreshed here).
    """
    from repro_torch.serve.routing import RoutingEngine

    rng = np.random.default_rng(seed)
    if router is None:
        router = RoutingEngine(method=method, max_batch=max_batch, device=device)
        for i in range(graphs):
            w, _, _ = repair_scenario("min_plus", n, seed=seed + i)
            router.add_graph(f"g{i}", w)
        router.refresh()  # one bucketed batched solve; load runs warm

    lat_us: list[float] = []
    updates = 0
    t_start = time.perf_counter()
    for op in range(queries):
        gid = f"g{rng.integers(graphs)}"
        if update_every and op and op % update_every == 0:
            u, v = rng.integers(n, size=2)
            router.update_edge(gid, int(u), int(v), float(rng.integers(1, 100)))
            updates += 1
            continue
        src, dst = rng.integers(n, size=2)
        if rng.uniform() < scheduler_share:
            router.submit(gid, int(src), int(dst))
            router.poll()
            continue
        t0 = time.perf_counter()
        router.query(gid, int(src), int(dst))
        lat_us.append((time.perf_counter() - t0) * 1e6)
    router.batcher.flush()
    wall = time.perf_counter() - t_start
    served = queries - updates
    lat = np.asarray(lat_us)
    return dict(
        graphs=graphs, n=n, queries=served, updates=updates,
        wall_s=wall, qps=served / wall,
        p50_us=float(np.percentile(lat, 50)),
        p99_us=float(np.percentile(lat, 99)),
        repair_refreshes=router.repair_refreshes,
        solve_refreshes=router.solve_refreshes,
        batched_flushes=router.batcher.flushes,
        max_seen_batch=router.batcher.max_seen_batch,
        engine_solves=router.engine.stats.solves,
        engine_repairs=router.engine.stats.repairs,
    )


def serve_log(*, graphs: int = 4, n: int = 256, ops: int = 400, seed: int = 0) -> list:
    """A seeded operation log for ``replay``: G tie-free min-plus graphs of
    ``repair_scenario`` (g0 .. g{G-1}, then one refresh), then ``ops``
    router calls — queries, ``submit`` + ``poll``, ⊕-improving
    ``update_edge`` (some symmetric), ``("worsen", g)`` (``set_edge`` of
    an existing edge to a larger weight, drawn at replay time from the
    router's own weights), ``fail_link``, refreshes and flushes."""
    rng = np.random.default_rng(seed)
    log: list = [("add", f"g{i}", repair_scenario("min_plus", n, seed=seed + i)[0])
                 for i in range(graphs)]
    log.append(("refresh",))
    for _ in range(ops):
        r = rng.uniform()
        g = f"g{rng.integers(graphs)}"
        u, v = (int(x) for x in rng.integers(n, size=2))
        if r < 0.5:
            log.append(("query", g, u, v))
        elif r < 0.7:
            log.append(("submit", g, u, v))
        elif r < 0.82:
            log.append(("update_edge", g, u, v, float(rng.integers(1, 100)),
                        bool(rng.uniform() < 0.25)))
        elif r < 0.9:
            log.append(("worsen", g))
        elif r < 0.95:
            log.append(("fail_link", g, u, v))
        elif r < 0.98:
            log.append(("refresh",))
        else:
            log.append(("flush",))
    return log + [("flush",), ("refresh",)]


def ticks(step: float = 0.001):
    """A fake monotonic clock that moves ``step`` seconds a reading: given
    to two routers replaying one log, the batcher's max-wait flushes fall
    on the same calls in both."""
    now = [0.0]

    def clock():
        now[0] += step
        return now[0]

    return clock


def _raise_weight(rng, w, u, v):
    return float(w[u, v]) + float(rng.integers(1, 1000))


def _port_tables(router, g):
    from repro_torch.serve.snapshot import host_values

    snap = router.snapshots.active(g)
    w = host_values(router.registry.peek(g), router.registry.storage_dtype(g))
    return w, None if snap is None else host_values(snap.dist, snap.dtype)


def replay(router, log, *, seed: int = 0, worsen=_raise_weight, tables=_port_tables):
    """Run a log of router calls (``serve_log``'s kinds, and ``("remove",
    g)``) through ``router``; returns (observations, snapshots, replies):
    each call's result (or the name of what it raised) with the
    refresh-arm counters, ``engine.stats`` (cache hits / misses aside),
    the batcher's and the registry's state after it; each published
    ``Snapshot`` with the call index and graph id, the first time it is
    seen; and every ``submit`` ticket's reply.  Two routers given one log
    and one seed make the same calls, so these compare whole.

    ``("worsen", g)`` draws an existing edge (finite, not 0̄, off the
    diagonal) of g, one on a published shortest path (w[u, v] == dist[u,
    v]) where there is one, and assigns it ``worsen(rng, w, u, v)`` with
    ``set_edge``.  ``tables(router, g)`` gives (the weights, the published
    dist or None) as numpy values.
    """
    rng = np.random.default_rng(seed)
    last: dict = {}
    obs, snaps, tickets = [], [], []
    fields = [k for k in vars(router.engine.stats) if k not in ("hits", "misses")]
    for op in log:
        kind, args = op[0], op[1:]
        try:
            if kind == "add":
                out = router.add_graph(*args)
            elif kind == "remove":
                out = router.remove_graph(*args)
            elif kind == "query":
                rep = router.query(*args)
                out = (rep.path, rep.cost)
            elif kind == "submit":
                tickets.append(router.submit(*args))
                out = router.poll()
            elif kind == "update_edge":
                g, u, v, x, sym = args
                out = router.update_edge(g, u, v, x, symmetric=sym)
            elif kind == "worsen":
                (g,) = args
                w, d = tables(router, g)
                edge = (np.isfinite(w) & ~np.eye(w.shape[-1], dtype=bool)
                        & (w != router.engine.semiring.zero))
                if d is not None and (edge & (w == d)).any():
                    edge &= w == d
                edges = np.argwhere(edge)
                u, v = (int(x) for x in edges[rng.integers(len(edges))])
                out = router.set_edge(g, u, v, worsen(rng, w, u, v))
            elif kind == "fail_link":
                out = router.fail_link(*args)
            elif kind == "refresh":
                out = router.refresh()
            else:
                out = router.batcher.flush()
        except Exception as e:  # noqa: BLE001 — a refusal is an observation too
            out = type(e).__name__
        reg = router.registry
        obs.append(dict(
            op=op[:2], out=out,
            arms=(router.solve_refreshes, router.repair_refreshes,
                  router.repair_del_refreshes),
            stats={k: getattr(router.engine.stats, k) for k in fields},
            batcher=(router.batcher.flushes, router.batcher.queries,
                     router.batcher.max_seen_batch, router.batcher.pending),
            bytes=(reg.total_bytes, reg.evictions, router.snapshots.total_bytes),
            dirty={g: (reg.dirty_kind(g), [e.as_tuple() for e in reg.pending_deltas(g)],
                       [(u, v, float(x)) for u, v, x in reg.pending_deletions(g)],
                       reg.structural_count(g)) for g in reg.ids()},
        ))
        for g in reg.ids():
            snap = router.snapshots.active(g)
            if snap is not None and last.get(g) is not snap:
                last[g] = snap
                snaps.append((len(obs), g, snap))
    replies = [(t.result().path, t.result().cost) for t in tickets]
    return obs, snaps, replies


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graphs", type=int, default=8)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--queries", type=int, default=2000)
    ap.add_argument("--update-every", type=int, default=50)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--method", default="auto")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the card; raises without one) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="bitwise repair / repair_del checks and the serving invariants")
    args = ap.parse_args(argv)
    if args.smoke:
        return smoke(device=args.device)
    metrics = run_load(
        graphs=args.graphs, n=args.n, queries=args.queries,
        update_every=args.update_every, max_batch=args.max_batch,
        method=args.method, seed=args.seed, device=args.device,
    )
    print("METRICS " + json.dumps(metrics))
    print(f"OK serve graphs={args.graphs} n={args.n} "
          f"qps={metrics['qps']:.0f} p50={metrics['p50_us']:.0f}us "
          f"p99={metrics['p99_us']:.0f}us "
          f"repairs={metrics['repair_refreshes']} "
          f"solves={metrics['solve_refreshes']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
