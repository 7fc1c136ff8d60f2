"""The repair's stage and apply kernels, emulated in plain torch, vs the JAX reference.

A repair of E edges is two launches (``csrc/fw_repair.cuh``):

  * the stage (``stage_kernel``): every CTA solves the E x E restriction M
    of the stage to the columns u_b in shared memory (a wavefront), each
    thread evolves one column of the E staged rows against M's scalars,
    then one row i of the matrix against M's upper triangle (M[e][b], b >
    e, is the staged P[e][u_b]), writing the row scalars scal[i][e] = (row
    i at u_e before step e) ⊗ w_e and, with next hops, hop[i][e]; both 16
    values at a time, a block taking the steps before it from what the
    thread wrote, then its own triangle;
  * the apply (``apply_kernel``): out = d ⊕ scal ⊗ P, a rank-E update
    with e ascending, on 2-D tiles of 128 rows by one warp's 16-byte
    vectors (128 columns of a 4-byte storage, 256 of a 2-byte one).  Each
    tile stages its P slice (E x columns, in the lanes' interleaved order)
    and its scalar slice (128 x E) once, zero past n, lifted
    (``semiring.cuh:Lifted``: bf16 / f16 min-plus / max-plus rounded at
    the store, int16's sentinels lifted and its clamp deferred to the
    store, ``Streamed<Op>``); every other step rounds after each op.  Rows
    move as 16-byte vectors where every row starts aligned, else one
    element at a time;
  * the successor apply (``succ_apply_kernel``): nothing lifted, each
    candidate rounded to the storage before its strict compare, each
    element keeping the e of its last strict improvement and gathering
    hop[i][e] once after the fold.

The emulations follow the launches tile by tile (the tiles batched), and
are held by bits to the reference's ``fw_repair_ref`` /
``fw_repair_with_successors_ref`` on every repair storage (f32 ×5, int16
×4, bf16 / f16 ×5, packed words, the int32 carrier of the integer
storages), E in {1, 8, 16, 37, 64, 100} (past a launch pair's 64 edges
the wrapper's loop), n in {96, 100, 1000, 1024}, padding edges, u = v and
repeated edges, ±0- and NaN-salted inputs (none subnormal) and tie-heavy
successor graphs.  A hop gathered from the first tying e, and a put
skipped at the store, are shown to differ.  The kernels themselves are
held to the plain twins on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apsp  # noqa: F401  (imported before repro.kernels: circular import)
from repro.core import semiring as jsr
from repro.kernels import ref as jref
from repro_torch.core import semiring as tsr
from repro_torch.kernels import fw_repair as tfr
from repro_torch.kernels import ref as tref
from repro_torch.utils.interop import from_numpy
from test_torch_semiring import (
    HALF_DTYPES,
    NAMES,
    STORAGES,
    assert_same,
    from_port,
    storage_data,
    storage_id,
    storage_semiring,
    to_port,
)
from test_torch_succ_chain_design import (  # noqa: F401  (one_thread: the autouse fixture)
    differs,
    one_thread,
    tie_graph,
)

ROWS = 128  # kApplyRows
BLOCK = 16  # kStageBlock
KEPT = -1  # kKeptHop
REPAIR_CASES = [("float32", n) for n in NAMES] + list(STORAGES)
HALF = ("bfloat16", "float16")


# ------------------------------------------------------------- the steps
class Streamed:
    """``Streamed<Op>`` of a storage's step: acc (storage → accumulator),
    lift (accumulator → operand), relax, finish and out (accumulator →
    storage).  skip_put: the lifted accumulator stored without its put
    (int16: the deferred clamp left out; bf16 / f16: truncated, not
    rounded), the variant shown to differ."""

    def __init__(self, sr, dtype: torch.dtype, *, skip_put: bool = False):
        self.acc = self.lift = self.finish = self.out = lambda v: v
        self.relax = sr.relax
        self.lifted = True
        name = sr.name
        if name in ("min_plus_i16", "max_plus_i16"):
            inf, ninf = tsr.I16_INF, tsr.I16_NINF
            lo = name == "min_plus_i16"
            dom, other = (inf, ninf) if lo else (ninf, inf)
            self.acc = lambda v: v.to(torch.int64)
            self.lift = lambda v: torch.where(
                v == dom, (1 << 20) if lo else -(1 << 20),
                torch.where(v == other, -(1 << 17) if lo else 1 << 17, v))
            self.relax = (lambda acc, a, b: torch.minimum(acc, a + b)) if lo else \
                (lambda acc, a, b: torch.maximum(acc, a + b))
            if not skip_put:
                self.finish = (lambda v: torch.clamp(v, min=ninf)) if lo else \
                    (lambda v: torch.clamp(v, max=inf))
            self.out = lambda v: v.to(torch.int16)
        elif name in ("min_plus", "max_plus") and dtype in (torch.bfloat16, torch.float16):
            pick = tsr.minimum if name == "min_plus" else tsr.maximum
            self.acc = lambda v: v.float()
            self.lift = lambda v: v.to(dtype).float()  # R::round: exact on storage values
            self.relax = lambda acc, a, b: pick(acc, a + b)
            self.out = (lambda v: _truncate(v, dtype)) if skip_put else (lambda v: v.to(dtype))
        else:
            self.lifted = False


def _truncate(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """f32 → 16-bit rounded toward zero (the put's round to nearest
    skipped): a value the round moved away from zero steps back one ulp."""
    x = v.to(dtype)
    away = x.float().abs() > v.abs()
    return torch.where(away, x.view(torch.int16) - 1, x.view(torch.int16)).view(dtype)


def strict(sr):
    """``Strict<Op>``: the successor repair's distance step."""
    def step(acc, a, b):
        cand = sr.mul(a, b)
        return torch.where(cand < acc, cand, acc)
    return step


# ----------------------------------------------------------------- stage
def stage(d, u, v, w, sr, *, succ=None):
    """``stage_kernel``: (staged (E, n), scal (n, E), hops (n, E) or None).
    The restriction M is solved first; the row phase reads its upper
    triangle, which is checked to be the staged rows at the u_b."""
    E = len(u)
    u, v = torch.as_tensor(u, dtype=torch.long), torch.as_tensor(v, dtype=torch.long)
    step = sr.relax if succ is None else strict(sr)
    M = d[v][:, u]  # M[g][b] = d[v_g, u_b]
    A = torch.zeros_like(M)
    for t in range(E):
        A[t + 1:, t] = sr.mul(M[t + 1:, t], w[t])
        M[t + 1:, t + 1:] = step(M[t + 1:, t + 1:], A[t + 1:, t, None], M[t, None, t + 1:])
    x = d[v, :]  # the column threads: x[g] = row v_g, BLOCK rows at a time
    for g0 in range(0, E, BLOCK):
        blk = slice(g0, min(g0 + BLOCK, E))
        for t in range(g0):  # the staged rows before the block, final
            x[blk] = step(x[blk], A[blk, t, None], x[t, None, :])
        for t in range(blk.start, blk.stop):  # the block's own triangle
            x[t + 1:blk.stop] = step(x[t + 1:blk.stop], A[t + 1:blk.stop, t, None],
                                     x[t, None, :])
    for e in range(E - 1):
        assert_same(M[e, e + 1:], x[e, u[e + 1:]])
    y = d[:, u]  # the row threads: y[:, b] = row i at u_b, BLOCK at a time
    scal = torch.empty_like(y)
    ys = hops = None
    if succ is not None:
        ys, hops = succ[:, u], torch.empty_like(succ[:, u])
        rows = torch.arange(d.shape[0])

    def take(b, a, h):  # columns b (a slice) take step e's scalar a (hop h)
        if succ is None:
            y[:, b] = sr.relax(y[:, b], a[:, None], M[e, None, b])
            return
        cand = sr.mul(a[:, None], M[e, None, b])
        better = cand < y[:, b]
        y[:, b] = torch.where(better, cand, y[:, b])
        ys[:, b] = torch.where(better, h[:, None], ys[:, b])

    for b0 in range(0, E, BLOCK):
        blk = slice(b0, min(b0 + BLOCK, E))
        for e in range(b0):  # the scalars (hops) written before the block
            take(blk, scal[:, e], None if succ is None else hops[:, e])
        for e in range(blk.start, blk.stop):
            a = sr.mul(y[:, e], w[e])
            scal[:, e] = a
            h = None
            if succ is not None:
                h = torch.where(rows == u[e], v[e].to(torch.int32), ys[:, e])
                hops[:, e] = h
            take(slice(e + 1, blk.stop), a, h)
    return x, scal, hops


# ----------------------------------------------------------------- apply
def vec_of(dtype: torch.dtype) -> int:
    return 16 // torch.empty((), dtype=dtype).element_size()


def lane_words(VW: int) -> torch.Tensor:
    """Where column c of a tile sits in its staged slice row: lane l = c //
    VW, group q = c % VW // 4 at words (32q + l)·4 + c % 4; a permutation."""
    c = torch.arange(32 * VW)
    pos = ((c % VW // 4) * 32 + c // VW) * 4 + c % 4
    assert sorted(pos.tolist()) == list(range(32 * VW))
    return pos


def group_rows(RT: int) -> torch.Tensor:
    """The tile rows in the order the threads fold them: group g, warp w,
    row m at g·8·RT + w·RT + m; a permutation of the 128 rows."""
    order = torch.tensor([g * 8 * RT + w * RT + m for g in range(ROWS // (8 * RT))
                          for w in range(8) for m in range(RT)])
    assert sorted(order.tolist()) == list(range(ROWS))
    return order


def tiles(x, rows: int, cols: int, *, vec: bool, VW: int):
    """x (m, k) loaded as a (TR, rows, TC, cols) grid of tiles: 16-byte
    vectors (vec; a vector lies wholly before k or past it) or one element
    at a time, the pad 0 past m and k."""
    TR, TC = -(-x.shape[0] // rows), -(-x.shape[1] // cols)
    if vec:
        assert x.shape[1] % VW == 0, "vectors only where every row stays aligned"
    live = torch.zeros((TR * rows, TC * cols), dtype=torch.bool)
    live[:x.shape[0], :x.shape[1]] = True
    if vec:  # whole vectors: a vector is live iff its first column is
        live = live.view(TR * rows, -1, VW)[..., :1].expand(-1, -1, VW).reshape(live.shape)
    out = torch.zeros(live.shape, dtype=x.dtype)
    out[:x.shape[0], :x.shape[1]] = x
    out = torch.where(live, out, torch.zeros((), dtype=x.dtype))
    return out.view(TR, rows, TC, cols)


def slices(staged, scal, n: int, C: int, ar: Streamed, VW: int, *, vec: bool):
    """Each tile's P slice (TC, E, C), through the lanes' word order, and
    scalar slice (TR, 64, E): widened, lifted, zero past n."""
    E = staged.shape[0]
    P = ar.lift(ar.acc(tiles(staged, E, C, vec=vec, VW=VW)[0].permute(1, 0, 2)))
    words = torch.zeros_like(P)
    pos = lane_words(VW)
    words[..., pos] = P  # stored at the lanes' words, read back through them
    A = tiles(scal, ROWS, E, vec=False, VW=VW)[:, :, 0, :]
    return words[..., pos], ar.lift(ar.acc(A))


def apply(d, staged, scal, sr, *, vec: bool, skip_put: bool = False):
    """``apply_kernel``: every tile from d, e ascending on the lifted
    slices, finished and put at the store, the live part stored."""
    n, E = d.shape[-1], staged.shape[0]
    ar = Streamed(sr, d.dtype, skip_put=skip_put)
    VW = vec_of(d.dtype)
    C = 32 * VW
    group_rows(4)
    P, A = slices(staged, scal, n, C, ar, VW, vec=vec)
    acc = ar.acc(tiles(d, ROWS, C, vec=vec, VW=VW))
    for e in range(E):
        acc = ar.relax(acc, A[:, :, None, None, e], P[None, None, :, e, :])
    out = ar.out(ar.finish(acc)).reshape(acc.shape[0] * ROWS, -1)
    return out[:n, :n].contiguous()


def succ_apply(d, succ, staged, scal, hops, *, vec: bool, gather: str = "last_strict"):
    """``succ_apply_kernel``: distances in the storage, every candidate
    rounded before its strict compare, the e of each element's last strict
    improvement kept and its hop gathered after the fold.  gather:
    "first_tie" / "last_tie" take the hop of the first / last e whose
    candidate equals the final distance instead (the variants shown to
    differ)."""
    n, E = d.shape[-1], staged.shape[0]
    VW = vec_of(d.dtype)
    C = 32 * VW
    group_rows(2 if VW == 8 else 4)
    ar = Streamed(tsr.MIN_PLUS, torch.float32)  # nothing lifted
    P, A = slices(staged, scal, n, C, ar, VW, vec=vec)
    H = tiles(hops, ROWS, E, vec=False, VW=VW)[:, :, 0, :]
    acc = tiles(d, ROWS, C, vec=vec, VW=VW)
    s = tiles(succ, ROWS, C, vec=vec, VW=VW)
    ks = torch.full(acc.shape, KEPT)
    cands = []
    for e in range(E):
        cand = A[:, :, None, None, e] + P[None, None, :, e, :]  # rounded to the storage
        better = cand < acc
        acc = torch.where(better, cand, acc)
        ks = torch.where(better, e, ks)
        cands.append(cand)
    if gather != "last_strict":
        tie = torch.stack(cands) == acc
        idx = torch.arange(E)[:, None, None, None, None].expand(tie.shape)
        picked = torch.where(tie, idx, E if gather == "first_tie" else -1)
        ks = picked.amin(0) if gather == "first_tie" else picked.amax(0)
        ks = torch.where((ks >= E) | (ks < 0), KEPT, ks)
    Hx = H[:, :, None, None, :].expand(*acc.shape, E)
    hop = torch.gather(Hx, -1, ks.clamp(min=0)[..., None])[..., 0]
    s = torch.where(ks != KEPT, hop, s)
    cut = lambda t: t.reshape(t.shape[0] * ROWS, -1)[:n, :n].contiguous()  # noqa: E731
    return cut(acc), cut(s)


# ------------------------------------------------------- the launch pairs
def repair(d, u, v, w, sr, *, vec=None, **kw):
    """``fw_repair``'s loop of launch pairs on the emulated kernels."""
    cap = tfr.MAX_EDGES
    n = d.shape[-1]
    vec = n % vec_of(d.dtype) == 0 if vec is None else vec
    for c in range(0, len(u), cap):
        ue, ve, we = u[c:c + cap], v[c:c + cap], w[c:c + cap]
        staged, scal, _ = stage(d, ue, ve, we, sr)
        st_ref = tref.repair_stage_ref(d, ue, ve, we, semiring=sr)
        sc_ref, _ = tref.repair_scalars_ref(d, st_ref, ue, ve, we, semiring=sr)
        assert_same(staged, st_ref)
        assert_same(scal, sc_ref)
        d = apply(d, staged, scal, sr, vec=vec, **kw)
    return d


def repair_succ(d, succ, u, v, w, *, vec=None, **kw):
    cap = tfr.MAX_EDGES
    n = d.shape[-1]
    vec = n % vec_of(d.dtype) == 0 if vec is None else vec
    for c in range(0, len(u), cap):
        ue, ve, we = u[c:c + cap], v[c:c + cap], w[c:c + cap]
        staged, scal, hops = stage(d, ue, ve, we, tsr.MIN_PLUS, succ=succ)
        st_ref = tref.repair_stage_ref(d, ue, ve, we, strict=True)
        sc_ref, h_ref = tref.repair_scalars_ref(d, st_ref, ue, ve, we, succ=succ)
        for got, want in ((staged, st_ref), (scal, sc_ref), (hops, h_ref)):
            assert_same(got, want)
        d, succ = succ_apply(d, succ, staged, scal, hops, vec=vec, **kw)
    return d, succ


# ---------------------------------------------------------------- inputs
def edges(storage: str, name: str, n: int, E: int, seed: int):
    """E edges as numpy (u, v, w in the storage): a repeated u and a u == v
    edge (E > 2), and from E = 4 on the last one the engine's padding edge
    (u = v = 0, w = 0̄)."""
    rng = np.random.default_rng(seed)
    u, v = rng.integers(0, n, E).astype(np.int32), rng.integers(0, n, E).astype(np.int32)
    if E > 2:
        u[1], v[2] = u[0], u[2]
    if storage in ("float32", *HALF):
        lo, hi = ((-10.0, -1.0) if name in ("max_plus", "max_min") else (1.0, 10.0))
        x = rng.uniform(lo, hi, E).astype(np.float32)
        if name == "or_and":
            x[:] = 1.0
        if name == "plus_mul":
            x = rng.uniform(0.5, 1.0, E).astype(np.float32) / n
        w = np.array(jnp.asarray(x, HALF_DTYPES.get(storage, jnp.float32)))
    else:
        w = storage_data(storage, name, (E,), seed + 1)
    if E >= 4:
        u[-1] = v[-1] = 0
        zero = storage_semiring(storage, name, jsr).zero
        w[-1] = 0 if storage == "packed" else np.asarray(jnp.asarray(zero, w.dtype))
    return u, v, w


def matrix(storage: str, name: str, n: int, seed: int, salt: str, u, v):
    """The input in the storage: ``storage_data``, f32 as its
    ``semiring_graph``; salt "zero": 3 % +0 and 3 % -0 planted; "nan": 4
    NaNs off the edges' rows v_e and columns u_e (there a NaN floods whole
    rows and columns)."""
    if storage == "float32":
        from test_torch_semiring import semiring_graph

        x = semiring_graph(name, (n, n), seed)
    else:
        x = storage_data(storage, name, (n, n), seed)
    if salt == "plain":
        return x
    rng = np.random.default_rng(seed + 7)
    x = x.astype(np.float32)
    if salt == "zero":
        r = rng.uniform(size=x.shape)
        x[r < 0.03], x[(r >= 0.03) & (r < 0.06)] = 0.0, -0.0
    else:
        rows, cols, placed = set(v.tolist()), set(u.tolist()), 0
        while placed < 4:
            i, j = (int(t) for t in rng.integers(0, n, 2))
            if i != j and i not in rows and j not in cols:
                x[i, j], placed = np.nan, placed + 1
    return np.asarray(jnp.asarray(x, HALF_DTYPES.get(storage, jnp.float32)))


def reference(x, u, v, w, storage, name):
    jsr_ = storage_semiring(storage, name, jsr)
    return np.asarray(jref.fw_repair_ref(jnp.asarray(x), u, v, jnp.asarray(w), semiring=jsr_))


def port(x, w, storage, name):
    """(d, w, semiring, dtype) on the port: the int32 carrier of an integer
    storage."""
    sr = storage_semiring(storage, name)
    d, sr_c, dt = to_port(x, sr)
    wt = from_numpy(w, device="cpu")
    if tsr.int_storage(wt.dtype, sr):
        wt = tsr.to_carrier(wt, sr)
    return d, wt, sr_c, dt, sr


# ----------------------------------------------------------------- cases
SIZES = [(96, 1), (96, 8), (96, 16), (96, 37), (96, 64), (96, 100), (100, 16), (1000, 37),
         (1024, 16)]


@pytest.mark.parametrize("case", REPAIR_CASES, ids=storage_id)
@pytest.mark.parametrize("n,E", SIZES)
def test_emulated_repair_matches_reference(case, n, E):
    storage, name = case
    u, v, w = edges(storage, name, n, E, seed=n + E)
    x = matrix(storage, name, n, n * 3 + E, "plain", u, v)
    want = reference(x, u, v, w, storage, name)
    d, wt, sr, dt, sr0 = port(x, w, storage, name)
    got = from_port(repair(d, u, v, wt, sr), dt, sr0)
    assert_same(got, want)
    assert tfr.apply_vectors(d) == (n % vec_of(d.dtype) == 0)
    if n % vec_of(d.dtype) == 0 and E == 16:  # the element path on the same input
        assert_same(from_port(repair(d, u, v, wt, sr, vec=False), dt, sr0), want)


FLOAT_CASES = [c for c in REPAIR_CASES if c[0] in ("float32", *HALF)]


@pytest.mark.parametrize("case", FLOAT_CASES, ids=storage_id)
@pytest.mark.parametrize("salt", ["zero", "nan"])
@pytest.mark.parametrize("n,E", [(96, 16), (1000, 37)])
def test_emulated_repair_on_salted_inputs(case, salt, n, E):
    storage, name = case
    u, v, w = edges(storage, name, n, E, seed=n + E + 1)
    x = matrix(storage, name, n, n + E, salt, u, v)
    want = reference(x, u, v, w, storage, name)
    d, wt, sr, _, _ = port(x, w, storage, name)
    got = repair(d, u, v, wt, sr)
    assert_same(got, want)
    if salt == "nan":  # off the edges' rows and columns a NaN stays
        assert torch.isnan(got.float()).any()


SUCC_SIZES = [(96, 1), (96, 16), (96, 37), (96, 64), (96, 100), (100, 16), (1000, 16)]


def succ_case(dtype: str, n: int, seed: int, salt: str):
    if salt == "ties":
        x = tie_graph((n, n), seed)
    else:
        rng = np.random.default_rng(seed)
        x = rng.uniform(1.0, 10.0, (n, n)).astype(np.float32)
        x[rng.uniform(size=x.shape) < 0.3] = np.inf
        np.fill_diagonal(x, 0.0)
    x = np.asarray(jnp.asarray(x, HALF_DTYPES.get(dtype, jnp.float32)))
    succ = np.random.default_rng(seed + 1).integers(-1, n, (n, n)).astype(np.int32)
    return x, succ


def succ_edges(dtype, n, E, seed, ties: bool):
    u, v, w = edges(dtype, "min_plus", n, E, seed)
    if ties:  # integer weights: candidates tie the distances they meet
        w[:E] = np.asarray(jnp.asarray(np.random.default_rng(seed).integers(1, 4, E)
                                       .astype(np.float32), w.dtype))
    return u, v, w


def succ_reference(x, succ, u, v, w):
    wd, ws = jref.fw_repair_with_successors_ref(jnp.asarray(x), jnp.asarray(succ), u, v,
                                                jnp.asarray(w))
    return np.asarray(wd), np.asarray(ws)


@pytest.mark.parametrize("dtype", ["float32", *HALF])
@pytest.mark.parametrize("salt", ["ties", "random"])
@pytest.mark.parametrize("n,E", SUCC_SIZES)
def test_emulated_successor_repair_matches_reference(dtype, salt, n, E):
    x, succ = succ_case(dtype, n, n + E, salt)
    u, v, w = succ_edges(dtype, n, E, n + E + 2, salt == "ties")
    wd, ws = succ_reference(x, succ, u, v, w)
    d, s, wt = from_numpy(x, device="cpu"), torch.from_numpy(succ), from_numpy(w, device="cpu")
    gd, gs = repair_succ(d, s, u, v, wt)
    assert_same(gd, wd)
    assert_same(gs, ws)
    if n % vec_of(d.dtype) == 0 and E == 16:
        gd, gs = repair_succ(d, s, u, v, wt, vec=False)
        assert_same(gd, wd)
        assert_same(gs, ws)


@pytest.mark.parametrize("dtype", ["float32", *HALF])
def test_successor_repair_on_nan_and_zero_salts(dtype):
    n, E = 96, 16
    x, succ = succ_case(dtype, n, 5, "random")
    u, v, w = succ_edges(dtype, n, E, 6, False)
    x = x.astype(np.float32)
    rng = np.random.default_rng(8)
    r = rng.uniform(size=x.shape)
    x[r < 0.03], x[(r >= 0.03) & (r < 0.06)] = 0.0, -0.0
    rows, cols, placed = set(v.tolist()), set(u.tolist()), 0
    while placed < 4:
        i, j = (int(t) for t in rng.integers(0, n, 2))
        if i != j and i not in rows and j not in cols:
            x[i, j], placed = np.nan, placed + 1
    x = np.asarray(jnp.asarray(x, HALF_DTYPES.get(dtype, jnp.float32)))
    wd, ws = succ_reference(x, succ, u, v, w)
    gd, gs = repair_succ(from_numpy(x, device="cpu"), torch.from_numpy(succ), u, v,
                         from_numpy(w, device="cpu"))
    assert_same(gd, wd)
    assert_same(gs, ws)
    assert np.isnan(np.asarray(wd, np.float32)).any()


# ------------------------------------------------- what would go wrong
@pytest.mark.parametrize("dtype", ["float32", *HALF])
@pytest.mark.parametrize("gather", ["first_tie", "last_tie"])
def test_a_hop_from_a_tying_e_differs(dtype, gather):
    """Only the e of the last strict improvement gathers the right hop: the
    first e whose candidate ties the final distance may tie the start (no
    improvement), the last may come after it."""
    n, E = 96, 16
    x, succ = succ_case(dtype, n, 11, "ties")
    u, v, w = succ_edges(dtype, n, E, 12, True)
    wd, ws = succ_reference(x, succ, u, v, w)
    d, s, wt = from_numpy(x, device="cpu"), torch.from_numpy(succ), from_numpy(w, device="cpu")
    gd, gs = repair_succ(d, s, u, v, wt)
    assert_same(gs, ws)
    _, bad = repair_succ(d, s, u, v, wt, gather=gather)
    assert differs(bad, ws)


@pytest.mark.parametrize("case", [("int16", "min_plus"), ("int16", "max_plus"),
                                  ("bfloat16", "min_plus"), ("float16", "max_plus")],
                         ids=storage_id)
def test_a_put_skipped_at_the_store_differs(case):
    """The lifted accumulators need their put: int16's deferred clamp
    against the other sentinel, bf16 / f16's round to nearest."""
    storage, name = case
    n, E = 96, 16
    u, v, w = edges(storage, name, n, E, seed=3)
    x = matrix(storage, name, n, 4, "plain", u, v)
    want = reference(x, u, v, w, storage, name)
    d, wt, sr, _, _ = port(x, w, storage, name)
    assert Streamed(sr, d.dtype).lifted
    assert_same(repair(d, u, v, wt, sr), want)
    bad = repair(d, u, v, wt, sr, skip_put=True)
    assert differs(bad, want)


def test_lane_words_and_row_groups_are_permutations():
    for VW in (4, 8):
        pos = lane_words(VW)
        # lane l's q-th group of 4 columns is one 16-byte word run
        for l in range(32):
            for q in range(VW // 4):
                cols = [l * VW + 4 * q + j for j in range(4)]
                assert pos[cols].tolist() == [(32 * q + l) * 4 + j for j in range(4)]
    for RT in (2, 4):
        group_rows(RT)


def test_apply_vectors_follows_row_alignment():
    d = torch.zeros(96, 96)
    assert tfr.apply_vectors(d)
    assert not tfr.apply_vectors(torch.zeros(100, 100, dtype=torch.bfloat16))
    assert tfr.apply_vectors(torch.zeros(104, 104, dtype=torch.bfloat16))
    flat = torch.zeros(97 * 96)
    assert not tfr.apply_vectors(flat[1:1 + 96 * 96].view(96, 96))  # base 4 bytes off


@pytest.mark.parametrize("case", REPAIR_CASES, ids=storage_id)
def test_stream_twins_on_the_stage_buffers_equal_the_apply_twins(case):
    """The plain twins of the two launches on their own buffers:
    ``repair_scalars_ref`` and ``repair_stream_ref`` (with next hops
    ``repair_stream_succ_ref``) compose to ``repair_apply_ref`` (and its
    successor twin) and to the reference."""
    storage, name = case
    n, E = 96, 16
    u, v, w = edges(storage, name, n, E, seed=21)
    x = matrix(storage, name, n, 22, "plain", u, v)
    d, wt, sr, dt, sr0 = port(x, w, storage, name)
    staged = tref.repair_stage_ref(d, u, v, wt, semiring=sr)
    scal, hops = tref.repair_scalars_ref(d, staged, u, v, wt, semiring=sr)
    assert hops is None and scal.shape == (n, E) and scal.dtype == d.dtype
    got = tref.repair_stream_ref(d, scal, staged, semiring=sr)
    assert_same(got, tref.repair_apply_ref(d, staged, u, wt, semiring=sr))
    assert_same(from_port(got, dt, sr0), reference(x, u, v, w, storage, name))
    if storage in ("float32", *HALF) and name == "min_plus":
        xs, succ = succ_case(storage, n, 23, "ties")
        u, v, w = succ_edges(storage, n, E, 24, True)
        d, s = from_numpy(xs, device="cpu"), torch.from_numpy(succ)
        wt = from_numpy(w, device="cpu")
        staged = tref.repair_stage_ref(d, u, v, wt, strict=True)
        scal, hops = tref.repair_scalars_ref(d, staged, u, v, wt, succ=s)
        gd, gs = tref.repair_stream_succ_ref(d, s, scal, hops, staged)
        wd, ws = tref.repair_apply_succ_ref(d, s, staged, u, v, wt)
        assert_same(gd, wd)
        assert_same(gs, ws)
        jd, js = succ_reference(xs, succ, u, v, w)
        assert_same(gd, jd)
        assert_same(gs, js)
