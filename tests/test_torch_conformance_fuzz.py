"""The port's conformance fuzz: every lane of its solver against the
reference's triple-loop oracle, bit for bit, on the CPU.

The eight seeded cases of the reference's ``tests/test_conformance_fuzz.py``
(dense, sparse, disconnected and odd-n graphs; int16, bf16 and packed
storage; ragged and batched solves), run through the port's
``solve(device="cpu")`` and ``ApspEngine``, with the recursive (R-Kleene)
schedule as one more method lane: ``method="recursive"`` with the leaf
equal to the block size (16, the port's smallest pivot tile; the
reference fuzzes at 8), so that every solve recurses at least two levels.
The oracle is the reference's ``core.fw_naive`` on the same numpy input
(in the lowered semiring for int16).  The two exceptions the reference
encodes hold here too: plus_mul's blocked family is held to itself (and
to the reference's blocked solve), and bf16 lanes to each other and to
the oracle inside the exactness window.  The reference's Triton backend
lane has no counterpart (the port's device is its backend); its "ref"
backend is the one held beside the port's fused and recursive lanes.

``FUZZ_SEED`` overrides the fixed seed, as in the reference.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apsp as japsp  # before repro.core's fw_naive: the import cycle (C.3)
from repro.core import fw_naive
from repro.core.semiring import SEMIRINGS as JSEMIRINGS
from repro.core.semiring import lower_semiring as jlower
from repro_torch.apsp import ApspEngine, solve
from repro_torch.core.semiring import I16_INF, SEMIRINGS
from repro_torch.utils.bits import bits_equal

SEED = int(os.environ.get("FUZZ_SEED", "20260809"))
S = 16  # the reference fuzzes at 8; the port's round kernels take 16, 32, 64, 128
METHODS = ("naive", "blocked", "staged", "fused", "recursive")
IDEMPOTENT = ("min_plus", "max_plus", "max_min", "or_and")
TOPOLOGIES = (
    ("dense", 24, 1.0, False),
    ("sparse", 32, 0.15, False),
    ("disconnected", 24, 0.5, True),
    ("odd_n", 17, 0.6, False),
)


def _lane(method):
    """solve() keywords of one method lane: the recursive lane recurses at
    every pivot round (leaf = block size)."""
    kw = dict(method=method, validate=False, device="cpu")
    if method != "naive":
        kw["block_size"] = S
    if method == "recursive":
        kw["leaf"] = S
    return kw


def _fuzz_graph(sr_name, n, density, disconnected, seed):
    """The reference's integer-valued random graph in the semiring's domain."""
    rng = np.random.default_rng(seed)
    sr = SEMIRINGS[sr_name]
    if sr_name == "or_and":
        w = (rng.uniform(size=(n, n)) < density * 0.3).astype(np.float32)
        np.fill_diagonal(w, 1.0)
    elif sr_name == "plus_mul":
        w = 2.0 ** rng.integers(-6, -2, (n, n)).astype(np.float32)
    else:
        w = rng.integers(1, 100, (n, n)).astype(np.float32)
        w[rng.uniform(size=(n, n)) > density] = sr.zero
        if sr_name == "max_plus":
            w[np.tril_indices(n)] = sr.zero
        np.fill_diagonal(w, sr.one)
    if disconnected:
        h = n // 2
        w[:h, h:] = sr.zero
        w[h:, :h] = sr.zero
        np.fill_diagonal(w, sr.one)
    return w


def _oracle(w, sr_name, semiring=None):
    return np.asarray(fw_naive(jnp.asarray(w), semiring=semiring or JSEMIRINGS[sr_name]))


# ----------------------------------------------- method × semiring × shape
@pytest.mark.parametrize("topo", TOPOLOGIES, ids=[t[0] for t in TOPOLOGIES])
@pytest.mark.parametrize("sr_name", IDEMPOTENT)
def test_fuzz_methods_vs_naive_oracle(sr_name, topo):
    name, n, density, disc = topo
    w = _fuzz_graph(sr_name, n, density, disc, SEED)
    want = _oracle(w, sr_name)
    for method in METHODS:
        got = solve(w, semiring=sr_name, **_lane(method))
        assert got.method == method
        assert bits_equal(got.dist, want), f"{method} diverges from fw_naive on {sr_name}/{name}"


@pytest.mark.parametrize("topo", TOPOLOGIES, ids=[t[0] for t in TOPOLOGIES])
def test_fuzz_plus_mul_lanes(topo):
    """plus_mul: naive == oracle; the blocked family (recursive included)
    agrees with itself and with the reference's blocked solve."""
    name, n, density, disc = topo
    w = _fuzz_graph("plus_mul", n, density, disc, SEED + 1)
    assert bits_equal(solve(w, semiring="plus_mul", **_lane("naive")).dist,
                      _oracle(w, "plus_mul"))
    family = {m: solve(w, semiring="plus_mul", **_lane(m)).dist
              for m in ("blocked", "staged", "fused", "recursive")}
    ref = np.asarray(japsp.solve(w, method="blocked", semiring="plus_mul", block_size=S,
                                 validate=False).dist)
    for m, d in family.items():
        assert bits_equal(d, ref), f"plus_mul {m} != the reference's blocked on {name}"


@pytest.mark.parametrize("lane", ("fused", "recursive"))
@pytest.mark.parametrize("sr_name", IDEMPOTENT)
def test_fuzz_backends_bitwise(sr_name, lane):
    """The port's fused and recursive lanes == the oracle == the reference's
    fused solve on its "ref" backend."""
    w = _fuzz_graph(sr_name, 24, 0.5, False, SEED + 2)
    want = _oracle(w, sr_name)
    got = solve(w, semiring=sr_name, **_lane(lane))
    assert bits_equal(got.dist, want), f"{lane} diverges on {sr_name}"
    ref = japsp.solve(w, method="fused", semiring=sr_name, block_size=S, backend="ref",
                      validate=False)
    assert bits_equal(got.dist, np.asarray(ref.dist))


# -------------------------------------------------------- storage lowerings
def test_fuzz_int16_lowering_vs_lowered_oracle():
    """Saturating int16: the reference's fw_naive in the lowered semiring is
    the oracle; saturation is part of the computation both sides share."""
    rng = np.random.default_rng(SEED + 3)
    n = 24
    w = rng.integers(1, 900, (n, n)).astype(np.int16)
    w[rng.uniform(size=(n, n)) > 0.5] = I16_INF
    np.fill_diagonal(w, 0)
    want = _oracle(w, "min_plus", jlower(JSEMIRINGS["min_plus"], jnp.int16))
    for method in ("blocked", "staged", "fused", "recursive"):
        got = solve(w, semiring="min_plus", dtype=torch.int16, **_lane(method))
        assert bits_equal(got.dist, want), method


def test_fuzz_bf16_lowering_lanes_agree():
    """bf16: every blocked-family lane agrees by bits (rounding must not
    depend on the schedule), and sums of small integers are exact."""
    rng = np.random.default_rng(SEED + 4)
    n = 24
    w = rng.integers(1, 60, (n, n)).astype(np.float32)
    w[rng.uniform(size=(n, n)) > 0.4] = np.inf
    np.fill_diagonal(w, 0.0)
    lanes = {m: solve(w, semiring="min_plus", dtype=torch.bfloat16, **_lane(m)).dist
             for m in ("blocked", "staged", "fused", "recursive")}
    ref = lanes["blocked"]
    for m, d in lanes.items():
        assert bits_equal(d, ref), m
    jref = japsp.solve(w, method="blocked", semiring="min_plus", dtype=jnp.bfloat16,
                       block_size=S, validate=False)
    assert bits_equal(ref, np.asarray(jref.dist))
    want = _oracle(w, "min_plus")
    mask = np.isfinite(want) & (want < 128)
    assert np.array_equal(ref.float().numpy()[mask], want[mask])


@pytest.mark.parametrize("lane", ("fused", "recursive"))
def test_fuzz_packed_closure_vs_per_graph_oracle(lane):
    """Bit-packed or_and: one packed solve == B boolean closures, each
    equal to its per-graph oracle."""
    rng = np.random.default_rng(SEED + 5)
    B, n = 5, 24
    Bs = (rng.uniform(size=(B, n, n)) < 0.08).astype(np.float32)
    Bs[:, np.arange(n), np.arange(n)] = 1.0
    got = solve(Bs, semiring="or_and", packed=True, **_lane(lane))
    want = np.stack([_oracle(Bs[b], "or_and") for b in range(B)])
    assert bits_equal(got.dist, want)


# ------------------------------------------------------------ ragged batches
@pytest.mark.parametrize("lane", ("fused", "recursive"))
def test_fuzz_ragged_batch_vs_per_graph_oracle(lane):
    """``ApspEngine.solve_many`` over ragged sizes == per-graph fw_naive."""
    sizes = (13, 17, 24, 24, 31)
    graphs = [_fuzz_graph("min_plus", n, 0.5, False, SEED + 10 + i)
              for i, n in enumerate(sizes)]
    kw = dict(leaf=S, block_size=S) if lane == "recursive" else {}
    eng = ApspEngine(method=lane, validate=False, device="cpu", **kw)
    for i, (g, r) in enumerate(zip(graphs, eng.solve_many(graphs))):
        assert r.method == lane
        assert bits_equal(r.dist, _oracle(g, "min_plus")), f"graph {i} (n={g.shape[0]})"


@pytest.mark.parametrize("lane", ("fused", "recursive"))
def test_fuzz_batched_solve_vs_per_graph_oracle(lane):
    """A (B, n, n) batch through one solve == B independent oracles."""
    ws = np.stack([_fuzz_graph("min_plus", 24, 0.7, False, s)
                   for s in range(SEED + 20, SEED + 23)])
    got = solve(ws, semiring="min_plus", **_lane(lane)).dist
    for b in range(ws.shape[0]):
        assert bits_equal(got[b], _oracle(ws[b], "min_plus")), f"batch lane {b}"
