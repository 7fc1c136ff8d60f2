"""The port's phase kernels and 4-dispatch round vs the JAX Pallas kernels.

``repro_torch.kernels.fw_phase1`` / ``fw_phase2`` on CPU tensors run their
plain versions; they must equal ``repro.kernels.fw_phase1.fw_phase1`` and
``fw_phase2.fw_phase2_row`` / ``fw_phase2_col`` in interpret mode bit for
bit (``bits_equal``: bits compared, -0.0 told from +0.0, NaN equal to NaN,
tolerance zero) on the same numpy
inputs, on all five semirings, single and batched, at band lengths that are
not multiples of s.  The slice as a whole, ``repro_torch.core.staged.
fw_staged(fused=False)``, must equal ``repro.core.staged.fw_staged(
fused=False, interpret=True)`` and the port's own fused lowering; max_plus
gets DAG inputs (``semiring_graph``).  The same holds on every storage
lowering (int16 ×4, bf16 / f16, packed or_and words) and integer storage
(on the port's int32 carrier), kept in its dtype.  Mirrors the phase sweeps
of ``tests/test_kernels.py``.  The CUDA kernels are held against the plain
versions on the card by ``tests/test_torch_kernels_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apsp  # noqa: F401  (imported before repro.kernels: circular import)
from repro.core import semiring as jsr
from repro.core import staged as jstaged
from repro.kernels import fw_phase1 as jp1
from repro.kernels import fw_phase2 as jp2
from repro_torch.core import semiring as tsr
from repro_torch.core import staged as tstaged
from repro_torch.kernels import fw_phase1 as tp1
from repro_torch.kernels import fw_phase2 as tp2
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
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


def _diag(name, lead, s, seed):
    """A closed (…, s, s) diagonal tile: the reference's phase 1 of a graph."""
    t = semiring_graph(name, (*lead, s, s), seed)
    return np.array(jp1.fw_phase1(t, semiring=jsr.SEMIRINGS[name], interpret=True))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape", [(16, 16), (32, 32), (128, 128), (3, 32, 32)])
def test_phase1_matches_pallas(name, shape):
    t = semiring_graph(name, shape, seed=shape[-1])
    want = jp1.fw_phase1(t, semiring=jsr.SEMIRINGS[name], interpret=True)
    tt = torch.from_numpy(t.copy())
    got = tp1.fw_phase1(tt, semiring=tsr.SEMIRINGS[name])
    assert_same(got, want)
    assert_same(tt, t)  # the tile is left as it was


BAND_CASES = [  # (batch dims, s, band length n, the reference's bt)
    ((), 32, 128, 64),
    ((), 16, 40, 512),
    ((), 64, 96, 512),
    ((2,), 32, 160, 32),
]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("lead,s,n,bt", BAND_CASES)
def test_phase2_row_matches_pallas(name, lead, s, n, bt):
    diag = _diag(name, lead, s, seed=20 + s)
    band = semiring_graph(name, (*lead, n, n), seed=21 + n)[..., :s, :].copy()
    want = jp2.fw_phase2_row(diag, band, bt=bt, semiring=jsr.SEMIRINGS[name], interpret=True)
    got = tp2.fw_phase2_row(torch.from_numpy(diag), torch.from_numpy(band), bt=bt,
                            semiring=tsr.SEMIRINGS[name])
    assert_same(got, want)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("lead,s,n,bt", BAND_CASES)
def test_phase2_col_matches_pallas(name, lead, s, n, bt):
    diag = _diag(name, lead, s, seed=22 + s)
    band = semiring_graph(name, (*lead, n, n), seed=23 + n)[..., :, :s].copy()
    want = jp2.fw_phase2_col(diag, band, bt=bt, semiring=jsr.SEMIRINGS[name], interpret=True)
    got = tp2.fw_phase2_col(torch.from_numpy(diag), torch.from_numpy(band), bt=bt,
                            semiring=tsr.SEMIRINGS[name])
    assert_same(got, want)


FOUR_CASES = [  # (shape, block_size, bm, bn, bk)
    ((128, 128), 32, 256, 256, 8),
    ((96, 96), 16, 32, 48, 32),
    ((2, 128, 128), 64, 64, 64, 16),
]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape,s,bm,bn,bk", FOUR_CASES)
def test_four_dispatch_matches_pallas(name, shape, s, bm, bn, bk):
    w = semiring_graph(name, shape, seed=s + shape[-1])
    kw = dict(block_size=s, bm=bm, bn=bn, bk=bk)
    want = jstaged.fw_staged(jnp.asarray(w), semiring=jsr.SEMIRINGS[name], fused=False,
                             interpret=True, **kw)
    t = torch.from_numpy(w.copy())
    got = tstaged.fw_staged(t, semiring=tsr.SEMIRINGS[name], fused=False, **kw)
    assert_same(got, want)
    assert_same(t, w)  # the input is left as it was
    assert_same(tstaged.fw_staged(t, block_size=s, semiring=tsr.SEMIRINGS[name]), want)
    plain = t
    for b in range(shape[-1] // s):
        plain = tref.fw_round4_ref(plain, b, block_size=s, bk=bk, semiring=tsr.SEMIRINGS[name])
    assert_same(plain, want)


# ------------------------------------------------------ storage lowerings
@pytest.mark.parametrize("case", REF_STORAGES, ids=storage_id)
@pytest.mark.parametrize("shape", [(32, 32), (3, 16, 16)])
def test_lowered_phase1_matches_pallas(case, shape):
    storage, name = case
    t = storage_data(storage, name, shape, seed=shape[-1])
    want = jp1.fw_phase1(t, semiring=storage_semiring(storage, name, jsr), interpret=True)
    tt, sr, dt = to_port(t, storage_semiring(storage, name))
    got = tp1.fw_phase1(tt, semiring=sr)
    assert got.dtype == tt.dtype
    assert_same(from_port(got, dt, storage_semiring(storage, name)), np.asarray(want))


@pytest.mark.parametrize("case", REF_STORAGES, ids=storage_id)
@pytest.mark.parametrize("lead,s,n", [((), 16, 40), ((2,), 32, 64)])
def test_lowered_phase2_matches_pallas(case, lead, s, n):
    """Both bands of every storage against a closed diagonal, ragged and
    batched."""
    storage, name = case
    jsr_, tsr_ = storage_semiring(storage, name, jsr), storage_semiring(storage, name)
    diag = np.asarray(jp1.fw_phase1(storage_data(storage, name, (*lead, s, s), 20 + s),
                                    semiring=jsr_, interpret=True))
    full = storage_data(storage, name, (*lead, n, n), 21 + n)
    row, col = full[..., :s, :].copy(), full[..., :, :s].copy()
    td, sr, dt = to_port(diag, tsr_)
    for fn, jfn, band in ((tp2.fw_phase2_row, jp2.fw_phase2_row, row),
                          (tp2.fw_phase2_col, jp2.fw_phase2_col, col)):
        want = jfn(diag, band, bt=32, semiring=jsr_, interpret=True)
        got = fn(td, to_port(band, tsr_)[0], semiring=sr)
        assert_same(from_port(got, dt, tsr_), np.asarray(want))


@pytest.mark.parametrize("case", REF_STORAGES, ids=storage_id)
@pytest.mark.parametrize("shape,s", [((64, 64), 16), ((2, 64, 64), 32)])
def test_lowered_four_dispatch_matches_pallas(case, shape, s):
    """``fw_staged(fused=False)`` in every storage == the reference's
    4-dispatch round in interpret mode == the port's fused round."""
    storage, name = case
    tsr_ = storage_semiring(storage, name)
    w = storage_data(storage, name, shape, seed=s + shape[-1])
    want = jstaged.fw_staged(jnp.asarray(w), block_size=s, bk=8,
                             semiring=storage_semiring(storage, name, jsr), fused=False,
                             interpret=True)
    t, sr, dt = to_port(w, tsr_)
    got = tstaged.fw_staged(t, block_size=s, bk=8, semiring=sr, fused=False)
    assert got.dtype == t.dtype
    assert_same(from_port(got, dt, tsr_), np.asarray(want))
    assert_same(from_port(tstaged.fw_staged(t, block_size=s, semiring=sr), dt, tsr_),
                np.asarray(want))


def test_transitive_closure_matches_pallas_and_the_oracle():
    rng = np.random.default_rng(0)
    n = 128
    adj = (rng.uniform(size=(n, n)) < 0.02).astype(np.float32)
    np.fill_diagonal(adj, 1.0)
    got = tops.transitive_closure(torch.from_numpy(adj))
    want = jstaged.fw_staged(jnp.asarray(adj), semiring=jsr.OR_AND, fused=False, interpret=True)
    assert_same(got, want)
    reach = adj.astype(bool)  # boolean matrix powers to a fixed point
    for _ in range(n):
        new = reach | ((reach.astype(np.int64) @ reach.astype(np.int64)) > 0)
        if (new == reach).all():
            break
        reach = new
    assert np.array_equal(got.numpy() > 0.5, reach)


def test_phase_wrappers_refuse_what_they_do_not_take():
    d, band = torch.zeros(16, 16), torch.zeros(16, 40)
    with pytest.raises(TypeError):
        tp1.fw_phase1(d.double())
    with pytest.raises(ValueError):
        tp1.fw_phase1(torch.zeros(16, 8))
    with pytest.raises(ValueError):  # a col band handed to the row phase
        tp2.fw_phase2_row(d, band.t().contiguous())
    with pytest.raises(ValueError):  # batched diag with an unbatched band
        tp2.fw_phase2_col(d[None], band.t().contiguous())
    with pytest.raises(ValueError, match="fused"):
        tstaged.fw_staged(torch.zeros(32, 32), block_size=16, fused="ref")
    with pytest.raises(ValueError, match="broadcast"):
        tstaged.fw_staged(torch.zeros(32, 32), block_size=16, fused=False, variant="broadcast")
