"""The distributed solve of the port vs the JAX reference, on the CPU.

* The bordered round: ``repro_torch.kernels.fw_round.fw_round_bordered`` on
  a CPU tensor (its plain twin) == ``repro.kernels.ref.fw_round_bordered_ref``,
  bitwise, on all five semirings, with and without owner echo, and on every
  storage lowering and integer storage (mirrors ``tests/test_fw_round.py:466``).
* The mesh plan: ``repro_torch.apsp.plan.distributed_plan`` ==
  ``repro.apsp.plan.distributed_plan`` on every field they share.
* Real ``torch.distributed`` grids: 2×2 and 4×2 gloo ranks spawned by
  ``launch.mesh.run_grid`` (each rank imports no JAX) run
  ``fw_distributed``, ``solve(method="distributed")``, batched input, the
  "jnp" and "pallas" backends, a checkpointed run and its restart, the mesh
  ``repair`` and the engine's ``solve_many``; every rank's result is held
  against the reference's single-device ``solve(method="fused")`` (or
  ``ApspEngine.repair``) in this process.  Each grid is spawned once, in a
  module-scoped fixture that runs every case; each case is asserted in a
  test of its own.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apsp  # noqa: F401  (imported before repro.kernels: circular import)
from repro.apsp import ApspEngine as JEngine
from repro.apsp import plan as jplan
from repro.apsp import solve as jsolve
from repro.core import distributed as jdist
from repro.core import semiring as jsr
from repro.kernels import ref as jref
from repro.launch.fw_serve import pick_deletions, repair_scenario
from repro_torch.apsp import plan as tplan
from repro_torch.core import semiring as tsr
from repro_torch.kernels import fw_round as tfr
from repro_torch.launch import fw_dist_check as chk
from repro_torch.launch.mesh import run_grid
from test_torch_semiring import (
    NAMES,
    REF_STORAGES,
    assert_same,
    from_port,
    semiring_graph,
    storage_data,
    storage_id,
    storage_semiring,
    to_port,
)

EXACT = ("max_min", "or_and")  # ⊕ and ⊗ select, never round
IDEMPOTENT = ("max_min", "max_plus", "min_plus", "or_and")


# ----------------------------------------------------------- bordered round
def _bordered_input(name, shape, seed):
    m = max(shape[-2:])
    return semiring_graph(name, (*shape[:-2], m, m), seed)[..., :shape[-2], :shape[-1]].copy()


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape", [(64, 48), (48, 80), (3, 64, 48)])
@pytest.mark.parametrize("echo", [(-1, -1), (1, 2), (2, -1)])
def test_bordered_round_matches_reference(name, shape, echo):
    w = _bordered_input(name, shape, seed=sum(shape))
    want = jref.fw_round_bordered_ref(jnp.asarray(w), *echo, block_size=16,
                                      semiring=jsr.SEMIRINGS[name])
    t = torch.from_numpy(w.copy())
    got = tfr.fw_round_bordered(t, *echo, block_size=16, semiring=tsr.SEMIRINGS[name])
    assert got is t  # updated in place
    assert_same(got, want)


@pytest.mark.parametrize("case", REF_STORAGES, ids=storage_id)
@pytest.mark.parametrize("shape", [(96, 64), (2, 48, 80)])
@pytest.mark.parametrize("echo", [(-1, -1), (1, 1), (2, -1)])
def test_bordered_round_lowerings_match_reference(case, shape, echo):
    """The bordered round in every storage, kept: tall, wide and batched
    blocks, the three echo forms (none, both, one)."""
    storage, name = case
    w = storage_data(storage, name, shape, seed=21 + shape[-1])
    want = jref.fw_round_bordered_ref(jnp.asarray(w), *echo, block_size=16, bk=8,
                                      semiring=storage_semiring(storage, name, jsr))
    t, sr, dt = to_port(w, storage_semiring(storage, name))
    got = tfr.fw_round_bordered(t, *echo, block_size=16, bk=8, semiring=sr)
    assert got is t and got.dtype == t.dtype  # in place, in its storage
    assert_same(from_port(got, dt, storage_semiring(storage, name)), np.asarray(want))


def test_bordered_buffers_keep_the_storage():
    for dt in (torch.bfloat16, torch.int16, torch.int32):
        rb, cb = tfr.bordered_round_buffers(torch.zeros(2, 48, 80, dtype=dt), 16)
        assert rb.dtype == cb.dtype == dt and rb.shape == (2, 16, 80) and cb.shape == (2, 48, 16)


@pytest.mark.parametrize("echo", [(4, -1), (-1, 3), (-2, 0)])
def test_bordered_round_rejects_echo_outside_the_grid(echo):
    with pytest.raises(ValueError, match="owner echo"):
        tfr.fw_round_bordered(torch.zeros(64, 48), *echo, block_size=16)


# -------------------------------------------------------------- mesh plan
PLAN_CASES = [  # (n, devices, pods, batch, block_size)
    (96, 8, 1, 1, 32),
    (96, 8, 1, 1, None),  # pads to 128 on the 4x2 grid
    (100, 16, 1, 2, None),  # no tile keeps the waste under a third
    (300, 6, 1, 1, 64),
    (1000, 8, 2, 1, None),
    (2048, 8, 1, 4, None),
    (8192, 4, 1, 1, 128),
    (8192, 1, 1, 1, None),
]


@pytest.mark.parametrize("n,devices,pods,batch,bs", PLAN_CASES)
def test_distributed_plan_matches_reference(n, devices, pods, batch, bs):
    want = jplan.distributed_plan(n, devices, pods=pods, batch=batch, block_size=bs)
    got = tplan.distributed_plan(n, devices, pods=pods, batch=batch, block_size=bs)
    shared = set(want) - {"batch_block", "vmem_bytes"}
    assert set(got) - shared == {"band_bytes"}
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    rows, cols = got["bordered"]
    assert got["band_bytes"] == batch * (got["block_size"] * cols + rows * got["block_size"]) * 4
    assert tplan.mesh_factorization(devices, pods) == jplan.mesh_factorization(devices, pods)


# ------------------------------------------------------------ the grids
GRIDS = {"2x2": (2, 2), "4x2": (4, 2)}
N, S = 128, 16  # 8 rounds; per-rank blocks of whole tiles on both grids
BACKENDS = ("jnp", "pallas")


def _cases():
    """Every case a grid runs, by id; inputs are numpy arrays."""
    cases = {"imports": dict(kind="imports")}
    for name in NAMES:
        cases[f"direct-{name}"] = dict(kind="direct", semiring=name, bs=S,
                                       w=semiring_graph(name, (N, N), seed=1))
        cases[f"solve-{name}"] = dict(kind="solve", semiring=name, bs=S,
                                      w=semiring_graph(name, (96, 96), seed=2))
        for backend in BACKENDS:
            cases[f"{backend}-{name}"] = dict(kind="direct", semiring=name, bs=S,
                                              backend=backend,
                                              w=semiring_graph(name, (N, N), seed=3))
        w0, upd, baseline = repair_scenario(name, 64)
        d0 = np.asarray(JEngine(method=baseline, semiring=name, validate=False).solve(w0).dist)
        cases[f"repair-{name}"] = dict(kind="repair", semiring=name, dist=d0, updates=upd,
                                       baseline=baseline)
    for name in IDEMPOTENT:
        w0, _, baseline = repair_scenario(name, 64)
        d0 = np.asarray(JEngine(method=baseline, semiring=name, validate=False).solve(w0).dist)
        dels, w1 = pick_deletions(w0, d0, name)
        cases[f"repair_del-{name}"] = dict(kind="repair_del", semiring=name, dist=d0, w1=w1,
                                           deletions=dels, threshold=100.0)
    cases["refusals"] = dict(kind="refusals", w=semiring_graph("min_plus", (32, 32), seed=9))
    for name in ("min_plus", "plus_mul"):
        cases[f"batched-{name}"] = dict(kind="solve", semiring=name, bs=S,
                                        w=semiring_graph(name, (3, 96, 96), seed=4))
    cases["chunked"] = dict(kind="chunked", semiring="min_plus", bs=S, rounds_per_call=2,
                            restart_at=4, w=semiring_graph("min_plus", (N, N), seed=5))
    cases["engine"] = dict(kind="engine", semiring="min_plus", bs=S,
                           graphs=[semiring_graph("min_plus", (n, n), seed=6 + i)
                                   for i, n in enumerate((96, 48, 96))])
    cases["router"] = _router_case()
    return cases


def _updated(w, updates, failures):
    w1 = w.copy()
    for u, v, x in updates:
        w1[u, v] = min(w1[u, v], x)
    for u, v in failures:
        w1[u, v] = np.inf
    return w1


def _router_case():
    """Two tie-free graphs on the mesh router: one improvement (the mesh
    repair) and one on-path link failure each (the local sweep)."""
    graphs, updates, failures = {}, [], []
    for i, n in enumerate((64, 48)):
        w, upd, _ = repair_scenario("min_plus", n, seed=20 + i)
        w1 = _updated(w, [upd[0]], [])
        d = np.asarray(JEngine(validate=False).solve(w1).dist)
        (u, v, _), = pick_deletions(w1, d, "min_plus", count=1)[0]
        graphs[f"g{i}"] = w
        updates.append((f"g{i}", *upd[0]))
        failures.append((f"g{i}", u, v))
    return dict(kind="router", bs=S, graphs=graphs, updates=updates, failures=failures)


CASES = _cases()


def _spawn(R, C):
    ids = list(CASES)
    per_rank = run_grid(chk.run_cases, R, C, device="cpu",
                        args=([CASES[i] for i in ids],), timeout=300)
    return {i: [rank[k] for rank in per_rank] for k, i in enumerate(ids)}


@pytest.fixture(scope="module")
def grid_2x2():
    return _spawn(*GRIDS["2x2"])


@pytest.fixture(scope="module")
def grid_4x2():
    return _spawn(*GRIDS["4x2"])


@pytest.fixture(params=list(GRIDS))
def grid(request):
    """(R, C, {case id: [each rank's result]}) of one spawned grid."""
    R, C = GRIDS[request.param]
    return R, C, request.getfixturevalue(f"grid_{request.param}")


_FUSED: dict = {}


def fused(w, name, bs=S):
    """The reference's single-device fused solve (cached across grids)."""
    key = (name, bs, w.tobytes())
    if key not in _FUSED:
        _FUSED[key] = np.asarray(jsolve(w, method="fused", block_size=bs,
                                        semiring=name, validate=False).dist)
    return _FUSED[key]


def test_ranks_import_no_jax(grid):
    _, _, res = grid
    assert all(r == {"jax": False, "repro": False} for r in res["imports"])


@pytest.mark.parametrize("name", NAMES)
def test_fw_distributed_matches_fused(grid, name):
    _, _, res = grid
    want = fused(CASES[f"direct-{name}"]["w"], name)
    for r in res[f"direct-{name}"]:
        assert_same(r["dist"], want)


@pytest.mark.parametrize("name", NAMES)
def test_counted_bytes_equal_model(grid, name):
    R, C, res = grid
    rounds = N // S
    want = rounds * tplan.dist_round_comm_bytes(N, R, C, S)
    assert want == rounds * jplan.dist_round_comm_bytes(N, R, C, S)
    assert [r["comm_bytes"] for r in res[f"direct-{name}"]] == [want] * (R * C)


@pytest.mark.parametrize("name", NAMES)
def test_solve_distributed_matches_fused(grid, name):
    R, C, res = grid
    w = CASES[f"solve-{name}"]["w"]
    want = fused(w, name)
    pad = tplan.distributed_plan(96, R * C, grid=(R, C), block_size=S)["n_padded"]
    for r in res[f"solve-{name}"]:
        assert r["block_size"] == S and r["padded_n"] == pad
        assert_same(r["dist"], want)


@pytest.mark.parametrize("name", ["min_plus", "plus_mul"])
def test_solve_distributed_batched_matches_fused(grid, name):
    _, _, res = grid
    want = fused(CASES[f"batched-{name}"]["w"], name)
    for r in res[f"batched-{name}"]:
        assert_same(r["dist"], want)


def per_phase(w, name, backend, s=S):
    """The reference's per-phase lowering ("jnp" or "pallas" backend of
    ``repro.core.distributed``) run on the whole matrix, as on a 1×1 mesh:
    its phase functions are elementwise in the block, so every grid gives
    this result."""
    key = (name, backend, w.tobytes())
    if key not in _FUSED:
        sr = jsr.SEMIRINGS[name]
        x = jnp.asarray(w)
        for b in range(w.shape[-1] // s):
            o = slice(b * s, (b + 1) * s)
            diag = jdist._phase1(x[o, o], sr)
            rp = jdist._phase2_row(diag, x[o, :], sr)
            cp = jdist._phase2_col(diag, x[:, o], sr)
            x = x.at[o, :].set(rp).at[:, o].set(cp)
            x = (jdist._phase3_pallas(x, cp, rp, sr, True) if backend == "pallas"
                 else jdist._phase3_jnp(x, cp, rp, sr))
        _FUSED[key] = np.asarray(x)
    return _FUSED[key]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_per_phase_backends_match_reference(grid, backend, name):
    """Bitwise the reference's own per-phase lowering.  (It re-closes the
    pivot tile inside the panels and folds phase 3 in chunks, so it equals
    the fused solve only where ⊕ and ⊗ round nothing; for plus_mul it
    counts the pivot tile's paths again.)"""
    _, _, res = grid
    w = CASES[f"{backend}-{name}"]["w"]
    want = per_phase(w, name, backend)
    if name in EXACT:
        assert_same(want, fused(w, name))
    for r in res[f"{backend}-{name}"]:
        assert_same(r["dist"], want)


def test_chunked_restart_matches_fused(grid):
    _, _, res = grid
    want = fused(CASES["chunked"]["w"], "min_plus")
    for r in res["chunked"]:
        assert r["ckpts"] == [2, 4, 6, 8]
        assert_same(r["dist"], want)
        assert_same(r["restarted"], want)


@pytest.mark.parametrize("name", NAMES)
def test_mesh_repair_matches_single_device_repair(grid, name):
    _, _, res = grid
    case = CASES[f"repair-{name}"]
    eng = JEngine(method=case["baseline"], semiring=name, validate=False)
    want = np.asarray(eng.repair(case["dist"], case["updates"]).dist)
    for r in res[f"repair-{name}"]:
        assert_same(r["dist"], want)


@pytest.mark.parametrize("name", IDEMPOTENT)
def test_mesh_repair_del_matches_single_device(grid, name):
    """The mesh engine's repair_del runs the same local mark and sweep."""
    _, _, res = grid
    case = CASES[f"repair_del-{name}"]
    eng = JEngine(semiring=name, validate=False)
    want = np.asarray(eng.repair_del(case["dist"], case["w1"], case["deletions"],
                                     threshold=100.0).dist)
    for r in res[f"repair_del-{name}"]:
        assert r["sweeps"] == 1 and r["fallbacks"] == 0
        assert_same(r["dist"], want)


def test_mesh_engine_refuses_successors(grid):
    _, _, res = grid
    for r in res["refusals"]:
        assert "successors=True supports methods" in r["solve"]
        assert "distance-only" in r["repair"] and "distance-only" in r["repair_del"]


def test_engine_solve_many_one_runner_a_key(grid):
    _, _, res = grid
    graphs = CASES["engine"]["graphs"]
    for r in res["engine"]:
        assert r["cache_size"] == 2 and r["misses"] == 2 and r["hits"] == 2
        assert r["traces"] == [1, 1]
        for g, d in zip(graphs, r["dists"]):
            assert_same(d, fused(g, "min_plus"))


def test_mesh_router_publishes_the_fused_tables(grid):
    """``RoutingEngine(mesh=)``: every rank publishes distance-only tables
    equal to the reference's single-device fused solve of the updated
    weights, after a repair refresh and a repair_del refresh."""
    _, _, res = grid
    case = CASES["router"]
    for r in res["router"]:
        assert r["arms"] == (2, 2, 2) and r["succ"] == [None, None]
        assert r["sweeps"] + r["fallbacks"] == 2
        for g, w in case["graphs"].items():
            w1 = _updated(w, [x[1:] for x in case["updates"] if x[0] == g],
                          [x[1:] for x in case["failures"] if x[0] == g])
            assert_same(r["weights"][g], w1)
            assert_same(r["dists"][g], fused(w1, "min_plus"))
