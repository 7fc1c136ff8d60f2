"""Rank-1 repair of the port vs the JAX reference, bit for bit.

  * ``repro_torch.kernels.ref.fw_repair_ref`` == ``repro.kernels.ref
    .fw_repair_ref`` on all five f32 semirings (plus_mul's single-FMA step
    included), and the successor twin likewise; the two launch phases of
    the CUDA kernels (stage, apply) in their plain form compose to the
    same; the wrapper on a CPU tensor is the plain version.
  * ``repro_torch.apsp.ApspEngine.repair`` == ``repro.apsp.ApspEngine
    .repair`` == a re-solve of the updated graph on the five
    ``repair_scenario`` constructions, with next hops on the tie-free
    min-plus case.
  * the policy (``should_repair``) decides as the reference does; edge
    buckets share one plan; bad inputs and unported options raise.

The kernels themselves are held against the plain versions on the card by
``tests/test_torch_kernels_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apsp as japsp
from repro.apsp import plan as jplan
from repro.core import semiring as jsr
from repro.kernels import ref as jref
from repro.launch.fw_serve import _apply_updates, repair_scenario
from repro_torch.apsp import ApspEngine
from repro_torch.apsp import plan as tplan
from repro_torch.core import semiring as tsr
from repro_torch.kernels import fw_repair as tfr
from repro_torch.kernels import ref as tref
from repro_torch.utils.bits import bits_equal
from test_torch_semiring import NAMES, assert_same

SR_NAMES = ("min_plus", "max_plus", "max_min", "or_and", "plus_mul")
CASES = [(16, 1), (48, 5), (96, 8)]  # (n, E)


def _random_closure_like(n, seed):
    """Any square f32 matrix: kernel-vs-twin needs no closure structure."""
    return np.random.default_rng(seed).uniform(-10, 10, (n, n)).astype(np.float32)


def _random_edges(name, n, E, seed):
    """Random edges with a repeated u, a u == v edge and one no-op padding
    edge (u = v = 0, w = 0̄) as the engine appends them."""
    rng = np.random.default_rng(seed + 1)
    u = rng.integers(0, n, E).astype(np.int32)
    v = rng.integers(0, n, E).astype(np.int32)
    w = rng.uniform(-10, 10, E).astype(np.float32)
    if E > 2:
        u[1], v[2] = u[0], u[2]
    zero = np.float32(tsr.SEMIRINGS[name].zero)
    return (np.append(u, np.int32(0)), np.append(v, np.int32(0)), np.append(w, zero))


# ------------------------------------------------------------ plain twins
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("n,E", CASES)
def test_plain_repair_matches_reference(name, n, E):
    d = _random_closure_like(n, n + E)
    u, v, w = _random_edges(name, n, E, n)
    want = jref.fw_repair_ref(jnp.asarray(d), u, v, jnp.asarray(w),
                              semiring=jsr.SEMIRINGS[name])
    sr = tsr.SEMIRINGS[name]
    t = torch.from_numpy(d.copy())
    assert_same(tref.fw_repair_ref(t, u, v, w, semiring=sr), want)
    got = tfr.fw_repair(t, u, v, w, block_size=16, semiring=sr)
    assert_same(got, want)
    assert_same(t, d)  # the input is left as it was
    # The two launch phases of the CUDA kernels, in plain form.
    staged = tref.repair_stage_ref(t, u, v, w, semiring=sr)
    assert staged.shape == (len(u), n)
    assert_same(tref.repair_apply_ref(t, staged, u, w, semiring=sr), want)


@pytest.mark.parametrize("n,E", CASES + [(64, 37)])
def test_plain_successor_repair_matches_reference(n, E):
    rng = np.random.default_rng(3 + n)
    d = rng.integers(1, 10**6, (n, n)).astype(np.float32)
    np.fill_diagonal(d, 0.0)
    succ = rng.integers(-1, n, (n, n)).astype(np.int32)
    u, v, w = _random_edges("min_plus", n, E, n)
    w[:E] = rng.integers(1, 100, E)
    wd, ws = jref.fw_repair_with_successors_ref(jnp.asarray(d), jnp.asarray(succ),
                                                u, v, jnp.asarray(w))
    td, ts = torch.from_numpy(d), torch.from_numpy(succ)
    gd, gs = tfr.fw_repair_with_successors(td, ts, u, v, w, block_size=16)
    assert_same(gd, wd)
    assert_same(gs, ws)
    staged = tref.repair_stage_ref(td, u, v, w, strict=True)
    ad, as_ = tref.repair_apply_succ_ref(td, ts, staged, u, v, w)
    assert_same(ad, wd)
    assert_same(as_, ws)


def test_plain_repair_is_batch_rank_agnostic():
    d = np.stack([_random_closure_like(32, s) for s in range(3)])
    u, v, w = _random_edges("min_plus", 32, 5, 0)
    want = jref.fw_repair_ref(jnp.asarray(d), u, v, jnp.asarray(w))
    assert_same(tref.fw_repair_ref(torch.from_numpy(d), u, v, w), want)


def test_repair_wrappers_reject_bad_inputs():
    d = torch.zeros(32, 32)
    with pytest.raises(ValueError):
        tfr.fw_repair(d, [0], [1], [1.0], block_size=12)  # 32 % 12
    with pytest.raises(ValueError):
        tfr.fw_repair(d, [0, 1], [1], [1.0], block_size=16)
    with pytest.raises(ValueError):
        tfr.fw_repair(d, [], [], [], block_size=16)
    with pytest.raises(ValueError):
        tfr.fw_repair(d, [32], [1], [1.0], block_size=16)  # outside [0, n)
    with pytest.raises(TypeError):
        tfr.fw_repair(d.double(), [0], [1], [1.0], block_size=16)
    with pytest.raises(ValueError):  # the phases are card-only
        tfr.repair_phase("stage", d, *tfr.edge_vectors([0], [1], [1.0], 32, "cpu"),
                         torch.empty(1, 32))
    with pytest.raises(ValueError):
        tfr.fw_repair_with_successors(d, torch.zeros(16, 16, dtype=torch.int32),
                                      [0], [1], [1.0], block_size=16)


# ------------------------------------------------- engine: repair == resolve
def _engines(name, method, **kw):
    return (japsp.ApspEngine(method=method, semiring=name, validate=False, **kw),
            ApspEngine(method=method, semiring=name, validate=False, device="cpu", **kw))


@pytest.mark.parametrize("name", SR_NAMES)
def test_engine_repair_matches_reference_and_resolve(name):
    w, upd, baseline = repair_scenario(name, 48)
    je, te = _engines(name, baseline)
    j0, t0 = je.solve(w), te.solve(w)
    assert_same(t0.dist, j0.dist)
    jr, tr = je.repair(j0.dist, upd), te.repair(t0.dist, upd)
    assert_same(tr.dist, jr.dist)
    resolved = te.solve(_apply_updates(w, upd, name))
    assert_same(tr.dist, resolved.dist.numpy())
    assert (tr.method, tr.block_size, tr.padded_n) == (jr.method, jr.block_size, jr.padded_n)


def test_engine_successor_repair_matches_reference_tie_free():
    w, upd, _ = repair_scenario("min_plus", 70, seed=2)
    je, te = _engines("min_plus", "fused")
    j0, t0 = je.solve(w, successors=True), te.solve(w, successors=True)
    jr = je.repair(j0.dist, upd, succ=j0.succ)
    tr = te.repair(t0.dist, upd, succ=t0.succ)
    assert_same(tr.dist, jr.dist)
    assert_same(tr.succ, jr.succ)
    r1 = te.solve(_apply_updates(w, upd, "min_plus"), successors=True)
    assert bits_equal(tr.dist, r1.dist) and bits_equal(tr.succ, r1.succ)
    assert_same(t0.succ, j0.succ)  # the inputs were not touched


def test_engine_repair_plan_cache_and_stats():
    """Same (shape, edge bucket) repairs share one plan built once; edge
    batches pad to power-of-two buckets; stats count repairs."""
    w, upd, _ = repair_scenario("min_plus", 48)
    eng = ApspEngine(method="fused", validate=False, device="cpu")
    r0 = eng.solve(w)
    eng.repair(r0.dist, upd)           # 3 edges → bucket 4
    misses = eng.stats.misses
    eng.repair(r0.dist, upd[:2])       # 2 edges → same bucket 4: cache hit
    assert eng.stats.misses == misses
    entries = {k: e for k, e in eng._cache.items() if k.method == "repair"}
    assert [k.edges for k in entries] == [4]
    assert all(e.traces == 1 for e in entries.values())
    assert next(iter(entries)).backend == "cpu"
    eng.repair(r0.dist, upd + upd[:2])  # 5 edges → bucket 8: a new plan
    assert sorted(k.edges for k in eng._cache if k.method == "repair") == [4, 8]
    assert eng.stats.repairs == 3 and eng.stats.edges_repaired == 10


@pytest.mark.parametrize("n", [100, 1024, 4096])
@pytest.mark.parametrize("successors", [False, True])
def test_should_repair_decides_like_the_reference(n, successors):
    je = japsp.ApspEngine(method="fused")
    te = ApspEngine(method="fused", device="cpu")
    for pending in (0, 1, 3, 17, 200, 500, 5000, 10**6):
        for threshold in (0.05, 0.5, 1.0):
            kw = dict(successors=successors, threshold=threshold)
            assert te.should_repair(n, pending, **kw) == je.should_repair(n, pending, **kw)
    for E in (1, 16, 64):
        s = tplan.auto_block_size(n)
        assert tplan.repair_hbm_bytes(n, s, edges=E, successors=successors) == \
            jplan.repair_hbm_bytes(n, s, edges=E, successors=successors)


def test_should_repair_crossover_and_worsening_fast_reject():
    te = ApspEngine(method="fused", device="cpu")
    je = japsp.ApspEngine(method="fused")
    assert te.should_repair(1024, 1)
    assert not te.should_repair(1024, 500)
    assert not te.should_repair(1024, 0)
    assert te.stats.repair_rejects == 0
    for eng in (te, je):
        assert not eng.should_repair(1024, 1, worsenings=1)
        assert not eng.should_repair(1024, 3, worsenings=2)
    assert te.stats.repair_rejects == je.stats.repair_rejects == 2


def test_engine_repair_rejects_bad_inputs():
    eng = ApspEngine(method="fused", device="cpu")
    w, upd, _ = repair_scenario("min_plus", 32)
    r0 = eng.solve(w, successors=True)
    with pytest.raises(ValueError):
        eng.repair(r0.dist, [])
    with pytest.raises(ValueError):
        eng.repair(np.zeros(5, np.float32), upd)
    with pytest.raises(ValueError):
        eng.repair(r0.dist, [(0, 32, 1.0)])  # outside [0, n)
    meng = ApspEngine(method="fused", semiring="max_plus", device="cpu")
    with pytest.raises(ValueError):  # next hops are min-plus only
        meng.repair(r0.dist, upd, succ=r0.succ)


@pytest.mark.parametrize("kw,item", [
    (dict(dtype="int16"), "A.4"),
    (dict(dtype="bfloat16"), "A.4"),
    (dict(packed=True, semiring="or_and"), "A.4"),
    (dict(semiring="min_plus_i16"), "A.4"),
    (dict(method="recursive"), "A.10"),
    (dict(hbm_budget=1 << 20), "A.10"),
    (dict(leaf=256), "A.10"),
    (dict(method="distributed"), "A.11"),
    (dict(mesh=object()), "A.11"),
])
def test_engine_unported_options_name_their_roadmap_item(kw, item):
    if item == "A.4":  # ported: the engine pins the lowering and repairs in
        te = ApspEngine(device="cpu", method="fused", block_size=16, **kw)  # it
        je = japsp.ApspEngine(method="fused", block_size=16, **kw)
        assert te.semiring.name == je.semiring.name
        if te.semiring.packed:
            w = np.asarray(japsp.pack_reachability(
                (np.random.default_rng(3).uniform(size=(32, 32)) < 0.1).astype(np.float32)))
            upd = [(1, 2, 5)]
        else:
            w, upd, _ = repair_scenario("min_plus", 32)
            w = np.where(np.isfinite(w), w % 97, w).astype(np.float32)
        t0, j0 = te.solve(w), je.solve(w)
        assert_same(t0.dist, np.asarray(j0.dist))
        assert_same(te.repair(t0.dist, upd).dist, np.asarray(je.repair(j0.dist, upd).dist))
        return
    if item == "A.10":  # ported: the recursive engine solves as the reference's
        w, _, _ = repair_scenario("min_plus", 32)
        t0, j0 = ApspEngine(device="cpu", **kw).solve(w), japsp.ApspEngine(**kw).solve(w)
        assert t0.method == j0.method
        assert_same(t0.dist, np.asarray(j0.dist))
        return
    if item == "A.11":  # ported: the mesh engine needs a mesh, and only
        if "mesh" in kw:  # method="distributed" reads it
            assert ApspEngine(device="cpu", **kw).mesh is kw["mesh"]
        else:
            with pytest.raises(ValueError, match="requires a mesh"):
                ApspEngine(device="cpu", **kw)
        return
    with pytest.raises(NotImplementedError, match=item):
        ApspEngine(device="cpu", **kw)

