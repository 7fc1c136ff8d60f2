"""Decremental repair of the port vs the JAX reference, bit for bit.

  * ``repro_torch.kernels.fw_repair_del.mark_affected`` (and its next-hop
    form) == ``repro.kernels.fw_repair_del.mark_affected`` on all five f32
    semirings, with padding edges past the live count;
  * the plain restricted sweep ``kernels.ref.fw_repair_del_sweep_ref`` and
    its successor twin == the reference's XLA twins, over strips narrower
    than, as tall as and taller than the pivot block, n == m (padding
    strip rows gather a real row); the three per-launch plain phases of
    the CUDA kernels == the reference's own per-round helpers, round by
    round; the wrappers on CPU tensors are the plain versions;
  * ``plan.repair_del_hbm_bytes`` / ``should_repair_del`` == the
    reference's over a grid;
  * ``ApspEngine(device="cpu").repair_del`` == ``repro.apsp.ApspEngine
    .repair_del`` == a re-solve of the updated graph: five semirings
    (plus_mul through its counted fallback), next hops on both policy arms,
    the empty batch, a self-loop deletion, the off-path no-op, plan cache
    and stats, and bad inputs.  Mirrors the single-device tests of
    ``tests/test_fw_repair_del.py``.

The kernels themselves are held against the plain versions on the card by
``tests/test_torch_kernels_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apsp as japsp
from repro.apsp import plan as jplan
from repro.core import semiring as jsr
from repro.kernels import fw_repair_del as jd
from repro.kernels import fw_round as jfr
from repro.launch.fw_serve import pick_deletions, repair_scenario
from repro_torch.apsp import ApspEngine
from repro_torch.apsp import plan as tplan
from repro_torch.core import semiring as tsr
from repro_torch.kernels import fw_repair_del as tfd
from repro_torch.kernels import ref as tref
from repro_torch.utils.bits import bits_equal
from test_torch_semiring import NAMES, assert_same

IDEMPOTENT = ("min_plus", "max_plus", "max_min", "or_and")
# (n, s) and strip heights a_pad below, at and above s.
SWEEP_CASES = [(64, 16, a) for a in (8, 16, 32)] + [(96, 32, a) for a in (8, 32, 64)] + [
    (256, 64, a) for a in (32, 64, 128)]


def _matrix(name, n, seed):
    """Any square matrix in the semiring's value domain: the sweep's
    kernel-vs-twin contract needs no closure structure."""
    rng = np.random.default_rng(seed)
    if name == "or_and":
        return (rng.uniform(size=(n, n)) < 0.3).astype(np.float32)
    return rng.uniform(-10, 10, (n, n)).astype(np.float32)


def _strip_rows(n, a_pad, seed):
    """a_pad rows: most real and distinct, the last ones padding (index n);
    row n - 1 (what a padding row gathers when n == m) is always real."""
    rng = np.random.default_rng(seed)
    a = max(1, a_pad - 3)
    rows = np.full(a_pad, n, np.int32)
    rows[:a] = np.sort(np.append(rng.choice(n - 1, a - 1, replace=False), n - 1))
    return rows


def _deletions(name, n, seed=0):
    """(closure, updated weights, deletions) of a ``repair_scenario`` graph:
    on-path edges where there are any, else any real edges (plus_mul)."""
    w, _, baseline = repair_scenario(name, n, seed=seed)
    d0 = np.array(japsp.solve(w, method=baseline, semiring=name, validate=False).dist)
    dels, w1 = pick_deletions(w, d0, name)
    if not dels:
        w0 = np.asarray(w)
        sr = jsr.SEMIRINGS[name]
        cand = [(u, v) for u, v in np.argwhere(w0 != sr.zero) if u != v][:2]
        dels = [(int(u), int(v), float(w0[u, v])) for u, v in cand]
        w1 = w0.copy()
        for u, v, _ in dels:
            w1[u, v] = sr.zero
    return np.asarray(w), d0, np.asarray(w1, np.float32), dels, baseline


# ------------------------------------------------------------------- mark
@pytest.mark.parametrize("name", NAMES)
def test_mark_affected_matches_reference(name):
    """Padding edges follow the live ones; the last padding edge repeats a
    live deletion, so skipping it is what keeps the mask equal."""
    _, d0, w1, dels, _ = _deletions(name, 48)
    zero = np.float32(jsr.SEMIRINGS[name].zero)
    u = np.array([e[0] for e in dels] + [0, dels[0][0]], np.int32)
    v = np.array([e[1] for e in dels] + [0, dels[0][1]], np.int32)
    wold = np.array([e[2] for e in dels] + [zero, dels[0][2]], np.float32)
    for ecount in (len(dels), 1):
        want = jd.mark_affected(jnp.asarray(d0), jnp.asarray(w1), jnp.asarray(u),
                                jnp.asarray(v), jnp.asarray(wold), ecount,
                                semiring=jsr.SEMIRINGS[name])
        got = tfd.mark_affected(torch.from_numpy(d0), torch.from_numpy(w1), u, v, wold,
                                ecount, semiring=tsr.SEMIRINGS[name])
        for g, x in zip(got, want):
            assert_same(g, x)
    if name != "plus_mul":
        assert int(got[2]) > 0  # on-path deletions are witnessed


def test_mark_affected_with_successors_matches_reference():
    w, _, _ = repair_scenario("min_plus", 48, seed=4)
    r0 = japsp.solve(w, method="fused", successors=True, validate=False)
    d0, s0 = np.array(r0.dist), np.array(r0.succ)
    dels, w1 = pick_deletions(w, d0, "min_plus")
    u, v, wold = (np.array(c + (p,), dt) for c, p, dt in zip(
        zip(*dels), (0, 0, np.inf), (np.int32, np.int32, np.float32)))
    want = jd.mark_affected_with_successors(
        jnp.asarray(d0), jnp.asarray(s0), jnp.asarray(w1), jnp.asarray(u), jnp.asarray(v),
        jnp.asarray(wold), len(dels))
    got = tfd.mark_affected_with_successors(
        torch.from_numpy(d0), torch.from_numpy(s0), torch.from_numpy(np.asarray(w1)),
        u, v, wold, len(dels))
    for g, x in zip(got, want):
        assert_same(g, x)


# ------------------------------------------------------------------ sweep
@pytest.mark.parametrize("name", IDEMPOTENT)
@pytest.mark.parametrize("n,s,a_pad", SWEEP_CASES)
def test_sweep_twin_matches_reference(name, n, s, a_pad):
    d = _matrix(name, n, n + a_pad)
    rows = _strip_rows(n, a_pad, a_pad)
    want = jd.fw_repair_del_sweep_ref(jnp.asarray(d), jnp.asarray(rows), block_size=s,
                                      semiring=jsr.SEMIRINGS[name])
    t = torch.from_numpy(d)
    sr = tsr.SEMIRINGS[name]
    assert_same(tref.fw_repair_del_sweep_ref(t, rows, block_size=s, semiring=sr), want)
    assert_same(tfd.fw_repair_del_sweep(t, rows, block_size=s, semiring=sr), want)
    assert_same(t, d)  # the input is left as it was


@pytest.mark.parametrize("n,s,a_pad", SWEEP_CASES[::2])
def test_successor_sweep_twin_matches_reference(n, s, a_pad):
    rng = np.random.default_rng(n + a_pad)
    d = rng.integers(1, 10**6, (n, n)).astype(np.float32)
    np.fill_diagonal(d, 0.0)
    succ = rng.integers(-1, n, (n, n)).astype(np.int32)
    rows = _strip_rows(n, a_pad, a_pad + 1)
    wd, ws = jd.fw_repair_del_sweep_with_successors_ref(
        jnp.asarray(d), jnp.asarray(succ), jnp.asarray(rows), block_size=s)
    td, ts = torch.from_numpy(d), torch.from_numpy(succ)
    for gd, gs in (tref.fw_repair_del_sweep_with_successors_ref(td, ts, rows, block_size=s),
                   tfd.fw_repair_del_sweep_with_successors(td, ts, rows, block_size=s)):
        assert_same(gd, wd)
        assert_same(gs, ws)


@pytest.mark.parametrize("name", IDEMPOTENT)
def test_sweep_phases_match_reference_rounds(name):
    """The three launches' plain phases, round by round, against the
    reference's own helpers on the same strip."""
    n, s, bk = 96, 32, 8
    d = _matrix(name, n, 5)
    rows = _strip_rows(n, 16, 6)
    jsemi, tsemi = jsr.SEMIRINGS[name], tsr.SEMIRINGS[name]
    dj, rj = jnp.asarray(d), jnp.asarray(rows)
    Aj = jnp.take(dj, rj, axis=0, mode="clip")
    dt = torch.from_numpy(d)
    At = dt[torch.from_numpy(np.minimum(rows, n - 1)).long()]
    for b in range(n // s):
        o = b * s
        band, in_blk, local = jd._band_overlay(dj, Aj, rj, o, s)
        diag = jfr._close_diag(jax.lax.dynamic_slice(band, (0, o), (s, s)), s, jsemi)
        band = jfr._close_row_panel(band, diag, s, jsemi)
        band = jax.lax.dynamic_update_slice(band, diag, (0, o))
        acol = jfr._close_col_panel(jax.lax.dynamic_slice(Aj, (0, o), (len(rows), s)), diag,
                                    s, jsemi)
        Aj = jax.lax.dynamic_update_slice(Aj, acol, (0, o))
        Aj = jfr._relax_tile(Aj, acol, band, s, bk, jsemi, "fori")
        closed = jnp.take(band, jnp.where(in_blk, local, 0), axis=0, mode="clip")
        Aj = jnp.where(in_blk[:, None], closed, Aj)

        tdiag = tref.sweep_diag_ref(dt, At, rows, b, block_size=s, semiring=tsemi)
        assert_same(tdiag, diag)
        tband, tacol = tref.sweep_panels_ref(dt, At, rows, tdiag, b, semiring=tsemi)
        assert_same(tband, band)
        assert_same(tacol, acol)
        At = tref.sweep_relax_ref(At, rows, tband, tacol, b, bk=bk, semiring=tsemi)
        assert_same(At, Aj)


def test_successor_sweep_phases_compose_to_the_twin():
    n, s = 64, 16
    rng = np.random.default_rng(2)
    d = torch.from_numpy(rng.integers(1, 100, (n, n)).astype(np.float32))
    succ = torch.from_numpy(rng.integers(-1, n, (n, n)).astype(np.int32))
    rows = _strip_rows(n, 8, 3)
    idx = torch.from_numpy(np.minimum(rows, n - 1)).long()
    A, As = d[idx], succ[idx]
    for b in range(n // s):
        diag, dsucc = tref.sweep_diag_succ_ref(d, succ, A, As, rows, b, block_size=s)
        bands = tref.sweep_panels_succ_ref(d, succ, A, As, rows, diag, dsucc, b)
        A, As = tref.sweep_relax_succ_ref(A, As, rows, *bands, b)
    wd, ws = jd.fw_repair_del_sweep_with_successors_ref(
        jnp.asarray(d.numpy()), jnp.asarray(succ.numpy()), jnp.asarray(rows), block_size=s)
    keep = torch.from_numpy(rows < n)
    real = torch.from_numpy(rows[rows < n]).long()
    assert_same(A[keep], np.asarray(wd)[real.numpy()])
    assert_same(As[keep], np.asarray(ws)[real.numpy()])


def test_sweep_wrappers_reject_bad_inputs():
    d = torch.zeros(64, 64)
    with pytest.raises(ValueError):
        tfd.fw_repair_del_sweep(d, [3], block_size=24)  # 64 % 24
    with pytest.raises(ValueError):
        tfd.fw_repair_del_sweep(d, [3, 3], block_size=16)  # a repeated real row
    with pytest.raises(ValueError):
        tfd.fw_repair_del_sweep(d, [65], block_size=16)  # beyond the padding index
    with pytest.raises(ValueError):
        tfd.fw_repair_del_sweep(d, [], block_size=16)
    with pytest.raises(TypeError):
        tfd.fw_repair_del_sweep(d.double(), [3], block_size=16)
    with pytest.raises(ValueError):
        tfd.fw_repair_del_sweep(d, [3], block_size=16, variant="broadcast")
    with pytest.raises(ValueError):
        tfd.fw_repair_del_sweep_with_successors(d, torch.zeros(32, 32, dtype=torch.int32),
                                                [3], block_size=16)
    with pytest.raises(ValueError):  # the phases are card-only
        tfd.sweep_phase("diag", tfd.sweep_buffers(d, [3], block_size=16), 0)
    with pytest.raises(ValueError):  # outside [0, n)
        tfd.mark_affected(d, d, [64], [1], [1.0], 1)


def test_sweep_buffers_align_the_hop_buffers():
    """The successor diag and panels move the next hops four at a time:
    ``sweep_buffers`` keeps an aligned s_init as it lies and copies a
    misaligned one (here 4 bytes into its storage) to an aligned buffer of
    the same values; the strip's, band's and acol's hop twins are aligned."""
    n, s = 64, 16
    d = torch.arange(n * n, dtype=torch.float32).reshape(n, n)
    succ = torch.arange(n * n, dtype=torch.int32).reshape(n, n)
    sw = tfd.sweep_buffers(d, [3, 40], block_size=s, s_init=succ)
    assert sw.s_init is succ
    off = torch.empty(n * n + 1, dtype=torch.int32)[1:].view(n, n).copy_(succ)
    assert off.is_contiguous() and off.data_ptr() % 16
    sw = tfd.sweep_buffers(d, [3, 40], block_size=s, s_init=off)
    assert sw.s_init is not off and bool((sw.s_init == succ).all())
    hops = (sw.s_init, sw.strip_s, sw.band_s, sw.acol_s)
    assert all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in hops)
    assert bool((sw.strip_s == succ[[3, 40] + [n - 1] * 6]).all())


# ------------------------------------------------------------------- plan
@pytest.mark.parametrize("n", [48, 1000, 1024, 8192])
@pytest.mark.parametrize("successors", [False, True])
def test_repair_del_policy_decides_like_the_reference(n, successors):
    s = tplan.auto_block_size(n)
    for a in (0, 1, 8, 100, n // 3, n):
        for E in (1, 16):
            kw = dict(affected_rows=a, edges=E, successors=successors)
            assert tplan.repair_del_hbm_bytes(n, s, **kw) == jplan.repair_del_hbm_bytes(n, s, **kw)
            for threshold in (0.0, 0.1, 0.5, 2.0, 100.0):
                kw = dict(edges=E, successors=successors, threshold=threshold)
                assert tplan.should_repair_del(n, a, **kw) == jplan.should_repair_del(n, a, **kw)
    assert tplan.should_repair_del(1024, 8) and not tplan.should_repair_del(1024, 900)


# ------------------------------------------- engine: repair_del == resolve
def _engines(name, method, **kw):
    return (japsp.ApspEngine(method=method, semiring=name, validate=False, **kw),
            ApspEngine(method=method, semiring=name, validate=False, device="cpu", **kw))


def _plan_keys(eng):
    return sorted((k.method, k.n_padded, k.block_size, k.bk, k.edges, k.successors)
                  for k in eng._cache)


def _del_stats(eng):
    return {f: getattr(eng.stats, f) for f in (
        "hits", "misses", "solves", "repair_dels", "repair_del_rows", "repair_del_noops",
        "repair_del_fallbacks", "edges_deleted")}


@pytest.mark.parametrize("name", NAMES)
def test_engine_repair_del_matches_reference_and_resolve(name):
    """threshold is forced high so that the sweep runs (at n = 48 a
    deletion touches most rows); plus_mul takes its counted fallback."""
    w, _, w1, dels, baseline = _deletions(name, 48)
    je, te = _engines(name, baseline)
    j0, t0 = je.solve(w), te.solve(w)
    jr = je.repair_del(j0.dist, w1, dels, threshold=100.0)
    tr = te.repair_del(t0.dist, w1, dels, threshold=100.0)
    assert_same(tr.dist, jr.dist)
    assert_same(tr.dist, te.solve(w1).dist)
    je.solve(w1)
    assert _del_stats(te) == _del_stats(je)
    assert _plan_keys(te) == _plan_keys(je)
    assert (tr.method, tr.block_size, tr.padded_n) == (jr.method, jr.block_size, jr.padded_n)
    sweeps = 0 if name == "plus_mul" else 1
    assert (te.stats.repair_dels, te.stats.repair_del_fallbacks) == (sweeps, 1 - sweeps)


@pytest.mark.parametrize("threshold,arm", [(100.0, "sweep"), (0.0, "fallback")])
def test_engine_successor_repair_del_both_arms(threshold, arm):
    w, _, _ = repair_scenario("min_plus", 48, seed=4)
    je, te = _engines("min_plus", "fused")
    j0, t0 = je.solve(w, successors=True), te.solve(w, successors=True)
    dels, w1 = pick_deletions(w, j0.dist, "min_plus")
    jr = je.repair_del(j0.dist, w1, dels, succ=j0.succ, threshold=threshold)
    tr = te.repair_del(t0.dist, w1, dels, succ=t0.succ, threshold=threshold)
    r1 = te.solve(w1, successors=True)
    assert_same(tr.dist, jr.dist)
    assert_same(tr.succ, jr.succ)
    assert bits_equal(tr.dist, r1.dist) and bits_equal(tr.succ, r1.succ)
    assert te.stats.repair_dels == (arm == "sweep")
    assert te.stats.repair_del_fallbacks == (arm == "fallback")
    assert_same(t0.succ, j0.succ)  # the inputs were not touched


def test_repair_del_empty_batch_is_noop():
    w, _, _ = repair_scenario("min_plus", 32)
    je, te = _engines("min_plus", "fused")
    t0 = te.solve(w)
    rep = te.repair_del(t0.dist, w, [])
    jrep = je.repair_del(je.solve(w).dist, w, [])
    assert bits_equal(rep.dist, t0.dist)
    assert (rep.method, rep.padded_n) == (jrep.method, jrep.padded_n)
    assert te.stats.solves == 1 and te.stats.repair_del_noops == 1
    assert te.stats.repair_dels == te.stats.repair_del_fallbacks == 0
    assert not [k for k in te._cache if k.method.startswith("repair_del")]


def test_repair_del_self_loop_deletion():
    w, _, _ = repair_scenario("min_plus", 32, seed=1)
    w = np.asarray(w).copy()
    w[5, 5] = 0.0  # explicit unit self-loop
    je, te = _engines("min_plus", "fused")
    w1 = w.copy()
    w1[5, 5] = np.inf
    rep = te.repair_del(te.solve(w).dist, w1, [(5, 5, 0.0)], threshold=100.0)
    jrep = je.repair_del(je.solve(w).dist, w1, [(5, 5, 0.0)], threshold=100.0)
    assert_same(rep.dist, jrep.dist)
    assert bits_equal(rep.dist, te.solve(w1).dist)


def test_repair_del_off_path_deletion_is_noop_and_plans_flat():
    """An edge strictly worse than the closure witnesses nothing: no sweep
    plan, a noop in stats, and the repeat builds nothing."""
    w, _, _ = repair_scenario("min_plus", 48, seed=2)
    te = ApspEngine(method="fused", validate=False, device="cpu")
    r0 = te.solve(w)
    w0, d0 = np.asarray(w), r0.dist.numpy()
    u, v = next((int(u), int(v)) for u, v in np.argwhere(np.isfinite(w0) & (w0 > d0))
                if u != v)
    w1 = w0.copy()
    w1[u, v] = np.inf
    for _ in range(2):
        rep = te.repair_del(r0.dist, w1, [(u, v, float(w0[u, v]))], threshold=100.0)
        assert bits_equal(rep.dist, r0.dist)
    assert te.stats.repair_del_noops == 2 and te.stats.repair_dels == 0
    assert not [k for k in te._cache if k.method == "repair_del"]
    marks = [e for k, e in te._cache.items() if k.method == "repair_del_mark"]
    assert len(marks) == 1 and marks[0].traces == 1


def test_repair_del_plan_cache_and_stats():
    """Same (shape, edge bucket, row bucket) deletions share plans built
    once; the keys are the reference's; stats count rows and edges."""
    w, _, _ = repair_scenario("min_plus", 48)
    je, te = _engines("min_plus", "fused")
    j0, t0 = je.solve(w), te.solve(w)
    dels, w1 = pick_deletions(w, j0.dist, "min_plus")
    for _ in range(2):
        je.repair_del(j0.dist, w1, dels, threshold=100.0)
        te.repair_del(t0.dist, w1, dels, threshold=100.0)
    entries = [e for k, e in te._cache.items() if k.method.startswith("repair_del")]
    assert len(entries) == 2 and all(e.traces == 1 for e in entries)
    assert _plan_keys(te) == _plan_keys(je)
    assert _del_stats(te) == _del_stats(je)
    assert te.stats.repair_dels == 2 and te.stats.edges_deleted == 2 * len(dels)
    sweep = next(k for k in te._cache if k.method == "repair_del")
    assert sweep.edges == min(max(8, 1 << (te.stats.repair_del_rows // 2 - 1).bit_length()), 48)
    assert sweep.backend == "cpu"


def test_repair_del_rejects_bad_inputs():
    te = ApspEngine(method="fused", device="cpu")
    w, _, _ = repair_scenario("min_plus", 32)
    r0 = te.solve(w, successors=True)
    with pytest.raises(ValueError):  # dist must be square
        te.repair_del(np.zeros(5, np.float32), np.asarray(w), [(0, 1, 1.0)])
    with pytest.raises(ValueError):  # w must match dist's shape
        te.repair_del(r0.dist, np.zeros((8, 8), np.float32), [(0, 1, 1.0)])
    with pytest.raises(ValueError):  # outside [0, n)
        te.repair_del(r0.dist, w, [(0, 32, 1.0)])
    meng = ApspEngine(method="fused", semiring="max_plus", device="cpu")
    with pytest.raises(ValueError):  # next hops are min-plus only
        meng.repair_del(r0.dist, w, [(0, 1, 1.0)], succ=r0.succ)
