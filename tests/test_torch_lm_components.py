"""The port's MoE, SSD and MLA layers (``repro_torch.models.moe``,
``moe_a2a``, ``ssm``, ``attention.mla_attention``) on the CPU.

The port's versions of ``tests/test_components.py``: the SSD chunked scan
against a sequential scan, mamba prefill-then-decode == the full
sequence, unique within-expert slots (with the hypothesis property),
dropless MoE == a per-token dense gather, bounded capacity drops, shared
experts adding the dense branch, and MLA's absorbed decode == its plain
form in f32; and of ``tests/test_moe_a2a.py``: ``moe_ffn_a2a`` is
``moe_ffn`` without a mesh.

Then each function against the reference's on the same numpy-seeded inputs
and the reference's own ``init_*`` parameters, crossed bit for bit:
``_positions_in_expert`` and the MoE routing (experts, slots, keep mask)
exactly, ``moe_ffn`` at capacity factor 8 (dropless) and 1.25 (dropping),
``mamba_block`` prefill (two chunks, and the one-chunk fallback) and
decode, ``mla_attention`` prefill and decode with and without q_lora.
Tolerances: f32 at rtol = atol = 1e-5; bf16 at rtol 2e-2 plus two bf16
ulps of the largest |value| (``test_torch_lm_layers.assert_matches``),
against the reference compiled without XLA's excess precision (``exact``),
so that each bf16 op rounds as its code says.  Top-k is held on planted
ties (jax puts the lower index first; ``torch.topk`` does not promise it).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st
from test_torch_lm_layers import DTYPES, assert_matches, cast_tree, normal, port
from test_torch_lm_model import exact

from repro.configs.base import get_smoke_config as ref_config
from repro.models import attention as ja
from repro.models import layers as jl
from repro.models import moe as jmoe
from repro.models import moe_a2a as jmoe_a2a
from repro.models import ssm as jssm
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig, SSMConfig
from repro_torch.configs.base import get_smoke_config
from repro_torch.models import attention as ta
from repro_torch.models import moe as tmoe
from repro_torch.models import moe_a2a as tmoe_a2a
from repro_torch.models import ssm as tssm
from repro_torch.models.layers import Params, rms_norm


def run_exact(fn, *args):
    """fn(*args) as the reference runs it under ``jit``, compiled without
    XLA's excess precision."""
    jitted = jax.jit(fn)
    return exact(jitted, *args)(*args)


def as_numpy(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------- SSD/mamba
def _ssd_sequential(x, dt, a, b, c, d):
    """O(S·N·P) sequential state recurrence: the SSD oracle (f64)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    state = np.zeros((bsz, h, n, p), np.float64)
    ys = np.zeros((bsz, s, h, p), np.float64)
    for t in range(s):
        decay = np.exp(np.asarray(dt[:, t] * a, np.float64))  # (B,H)
        upd = np.einsum("bhn,bhp->bhnp", b[:, t], x[:, t] * dt[:, t][..., None])
        state = decay[:, :, None, None] * state + upd
        ys[:, t] = np.einsum("bhn,bhnp->bhp", c[:, t], state)
    return ys + np.asarray(d)[None, None, :, None] * np.asarray(x, np.float64), state


@pytest.mark.parametrize("seq", [64, 40])  # four chunks of 16; 40 falls back to one chunk
def test_ssd_chunked_matches_sequential(seq):
    """The chunk loop (block decomposition) equals the naive scan, and so
    does the state it hands on."""
    rng = np.random.default_rng(0)
    bsz, h, p, n = 2, 4, 8, 16
    cfg = ModelConfig(
        name="ssd-test", family="ssm", n_layers=1, d_model=h * p // 2,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=128,
        ssm=SSMConfig(d_state=n, d_conv=4, expand=2, head_dim=p, n_groups=h, chunk_size=16),
        layer_pattern=(LayerSpec(kind="mamba", ffn="none"),),
    )
    x = rng.standard_normal((bsz, seq, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (bsz, seq, h)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, (h,)).astype(np.float32)
    b = rng.standard_normal((bsz, seq, h, n)).astype(np.float32) * 0.3
    c = rng.standard_normal((bsz, seq, h, n)).astype(np.float32) * 0.3
    d = rng.standard_normal((h,)).astype(np.float32)
    want, want_state = _ssd_sequential(x, dt, a, b, c, d)

    t = torch.from_numpy
    y, state = tssm._chunk_scan(t(dt * a), t(x), t(b), t(c), t(dt),
                                torch.zeros((bsz, h, n, p)), cfg)
    got = y.numpy() + d[None, None, :, None] * x
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(state.numpy(), want_state, rtol=2e-4, atol=2e-4)


def test_mamba_prefill_then_decode_matches_full():
    """Prefill state handoff: decode continuation == full-sequence forward
    (the reference's tolerance, 0.05), each decode step moving the state
    in place."""
    cfg = get_smoke_config("mamba2-780m")
    p = port(jssm.init_mamba(ref_config("mamba2-780m"), jax.random.key(0)))
    x = torch.from_numpy(normal((2, 24, cfg.d_model), 1, 0.1)).to(torch.bfloat16)
    full, _ = tssm.mamba_block(x, p, cfg, None)
    state = tssm.init_mamba_state(cfg, 2, device="cpu")
    pre, state = tssm.mamba_block(x[:, :16], p, cfg, state)
    outs = [pre]
    for t in range(16, 24):
        conv, ssm = state["conv"], state["ssm"]
        o, state = tssm.mamba_block(x[:, t:t + 1], p, cfg, state)
        assert state["conv"] is conv and state["ssm"] is ssm  # written in place
        outs.append(o)
    torch.testing.assert_close(torch.cat(outs, 1).float(), full.float(), rtol=0.05, atol=0.05)


# --------------------------------------------------------------------- MoE
def test_positions_in_expert_are_unique_slots():
    e = torch.tensor([2, 0, 2, 2, 1, 0, 2])
    pos = tmoe._positions_in_expert(e, 4)
    got = {}
    for ee, pp in zip(e.tolist(), pos.tolist()):
        got.setdefault(ee, []).append(pp)
    assert got[2] == [0, 1, 2, 3]  # order-preserving ranks
    assert got[0] == [0, 1]
    assert got[1] == [0]
    assert pos.dtype == torch.int32


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), t=st.integers(1, 64), e=st.integers(1, 8))
def test_property_positions_valid(seed, t, e):
    rng = np.random.default_rng(seed)
    ef = rng.integers(0, e, t).astype(np.int32)
    pos = tmoe._positions_in_expert(torch.from_numpy(ef), e).numpy()
    for ex in range(e):
        sel = np.sort(pos[ef == ex])
        np.testing.assert_array_equal(sel, np.arange(len(sel)))
    np.testing.assert_array_equal(pos, np.asarray(jmoe._positions_in_expert(jnp.asarray(ef), e)))


@pytest.mark.parametrize("seed", range(4))
def test_positions_in_expert_match_reference(seed):
    rng = np.random.default_rng(seed)
    e = [1, 8, 64, 384][seed]
    ef = rng.integers(0, e, 4096).astype(np.int32)
    np.testing.assert_array_equal(tmoe._positions_in_expert(torch.from_numpy(ef), e).numpy(),
                                  np.asarray(jmoe._positions_in_expert(jnp.asarray(ef), e)))


def _tiny_moe_cfg(cf=8.0, top_k=2, n_shared=0, n_experts=4, base=None):
    """A one-layer MoE config of the port's ``configs.base`` (or of the
    module ``base``: the reference's)."""
    cls, moe, spec = ((ModelConfig, MoEConfig, LayerSpec) if base is None
                      else (base.ModelConfig, base.MoEConfig, base.LayerSpec))
    return cls(
        name="moe-test", family="moe", n_layers=1, d_model=32, n_heads=2,
        n_kv_heads=2, d_ff=64, vocab_size=128,
        moe=moe(n_experts=n_experts, top_k=top_k, d_ff_expert=16, n_shared=n_shared,
                capacity_factor=cf),
        layer_pattern=(spec(kind="attn", ffn="moe"),),
    )


def _ref_moe_cfg(**kw):
    from repro.configs import base as rb

    return _tiny_moe_cfg(base=rb, **kw)


def _ref_moe_params(cfg, dtype=None):
    p = jmoe.init_moe(cfg, jax.random.key(0))
    return p if dtype is None else jax.tree.map(lambda a: a.astype(dtype), p)


def test_moe_dropless_matches_dense_gather():
    """With cf high enough for zero drops, MoE == per-token evaluation of
    the chosen experts (f32)."""
    cfg = _tiny_moe_cfg(cf=16.0, top_k=2)
    p = port(_ref_moe_params(_ref_moe_cfg(cf=16.0), jnp.float32))
    x = torch.from_numpy(normal((2, 8, 32), 1, 0.3))
    y, aux = tmoe.moe_ffn(x, p, cfg)
    h = rms_norm(x, p["norm"]["scale"], cfg.norm_eps)
    gates, idx = torch.topk(torch.softmax(h @ p["router"], -1), 2)
    gates = gates / gates.sum(-1, keepdim=True)
    want = torch.zeros_like(x)
    for b in range(2):
        for s in range(8):
            for j in range(2):
                e = int(idx[b, s, j])
                a, g3 = h[b, s] @ p["w1"][e], h[b, s] @ p["w3"][e]
                want[b, s] += gates[b, s, j] * ((torch.nn.functional.silu(a) * g3) @ p["w2"][e])
    torch.testing.assert_close(y, want, rtol=2e-4, atol=2e-4)
    assert bool(torch.isfinite(aux)) and float(aux) > 0


def test_moe_capacity_drops_are_bounded():
    """With cf = 1.0 every expert takes at most C assignments a row, some
    are dropped, and the output stays finite; a dropped assignment adds
    nothing (the residual carries its token)."""
    cfg = _tiny_moe_cfg(cf=1.0, top_k=2)
    p = port(_ref_moe_params(_ref_moe_cfg(cf=1.0)))
    x = torch.from_numpy(normal((2, 16, 32), 1, 0.3)).to(torch.bfloat16)
    y, aux = tmoe.moe_ffn(x, p, cfg)
    assert bool(torch.isfinite(y.float()).all()) and float(aux) >= 0
    r = tmoe.route(rms_norm(x, p["norm"]["scale"], cfg.norm_eps), p, cfg)
    assert r["cap"] == tmoe.capacity(cfg, 16) == 8
    for b in range(2):
        kept = r["e"][b][r["keep"][b]]
        assert int(torch.bincount(kept, minlength=4).max()) <= r["cap"]
    assert not bool(r["keep"].all())
    # Tokens whose every assignment was dropped get a zero delta.
    k = cfg.moe.top_k
    none_kept = ~r["keep"].reshape(2, 16, k).any(-1)
    assert bool(none_kept.any()) and bool((y[none_kept] == 0).all())


def test_moe_shared_experts_add_dense_branch():
    cfg = _tiny_moe_cfg(n_shared=1)
    p = port(_ref_moe_params(_ref_moe_cfg(n_shared=1)))
    assert "ws1" in p and p["ws1"].shape == (32, 16)
    assert tmoe.moe_shapes(cfg)["ws1"][0] == (32, 16)
    x = torch.from_numpy(normal((1, 4, 32), 1, 0.3)).to(torch.bfloat16)
    y, _ = tmoe.moe_ffn(x, p, cfg)
    assert y.shape == x.shape
    routed, _ = tmoe.moe_ffn(x, {k: v for k, v in p.items() if not k.startswith("ws")},
                             dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                                              n_shared=0)))
    h = rms_norm(x, p["norm"]["scale"], cfg.norm_eps)
    shared = (torch.nn.functional.silu((h @ p["ws1"]).float()).to(h.dtype)
              * (h @ p["ws3"])) @ p["ws2"]
    assert torch.equal(y, routed + shared)


def test_moe_a2a_is_moe_ffn_on_one_card():
    """No mesh, no exchange: ``moe_ffn_a2a`` is ``moe_ffn`` (the
    reference's fallback), and equals the reference's ``moe_ffn_a2a``."""
    cfg, rcfg = _tiny_moe_cfg(n_shared=1), _ref_moe_cfg(n_shared=1)
    rp = _ref_moe_params(rcfg)
    x = jnp.asarray(normal((2, 8, 32), 2, 0.5), jnp.bfloat16)
    y, aux = tmoe_a2a.moe_ffn_a2a(port(x), port(rp), cfg)
    y0, aux0 = tmoe.moe_ffn(port(x), port(rp), cfg)
    assert torch.equal(y, y0) and torch.equal(aux, aux0)
    want, want_aux = run_exact(lambda x, p: jmoe_a2a.moe_ffn_a2a(x, p, rcfg), x, rp)
    assert_matches(y, want, "bfloat16")
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-5)


def test_routes_record_and_replay():
    """``moe.routes`` records each call's experts; replaying a log of the
    same input reproduces the output bit for bit with no route moved, and
    replaying another input's routes forces them (``replay_gap`` counts
    the tokens moved off their own top-k and how far below it they are)."""
    cfg = _tiny_moe_cfg(cf=1.25, top_k=2, n_experts=8)
    p = port(_ref_moe_params(_ref_moe_cfg(cf=1.25, top_k=2, n_experts=8)))
    x = torch.from_numpy(normal((2, 16, 32), 6, 0.7)).to(torch.bfloat16)
    other = torch.from_numpy(normal((2, 16, 32), 7, 0.7)).to(torch.bfloat16)
    with tmoe.routes() as log:
        y, _ = tmoe.moe_ffn(x, p, cfg)
        tmoe.moe_ffn(other, p, cfg)
    assert len(log) == 2 and log[0]["e"].shape == (2, 32) and log[0]["keep"].shape == (2, 32)
    with tmoe.routes(log) as replayed:
        again, _ = tmoe.moe_ffn(x, p, cfg)
    assert torch.equal(again, y) and tmoe.replay_gap(replayed) == (0, 32, 0.0)
    with tmoe.routes(log[1:]) as forced:
        moved_y, _ = tmoe.moe_ffn(x, p, cfg)
    moved, tokens, gap = tmoe.replay_gap(forced)
    assert torch.equal(forced[0]["forced"], log[1]["e"])
    assert 0 < moved <= tokens == 32 and 0 < gap < 1 and not torch.equal(moved_y, y)
    assert not tmoe._WATCHES.open  # every block closed


def _ref_routing(x, p, cfg):
    """The reference's routing steps (``moe.py:72-85``) on its own
    functions: experts, gates, slots, keep."""
    m = cfg.moe
    b, s, _ = x.shape
    cap = max(int(s * m.top_k / m.n_experts * m.capacity_factor + 0.999), m.top_k)
    h = jl.apply_norm(x, p["norm"], cfg)
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", h.astype(jnp.float32), p["router"]), -1)
    gates, idx = jax.lax.top_k(probs, m.top_k)
    gates = gates / (gates.sum(-1, keepdims=True) + 1e-9)
    e_flat = idx.reshape(b, s * m.top_k).astype(jnp.int32)
    pos = jax.vmap(lambda ef: jmoe._positions_in_expert(ef, m.n_experts))(e_flat)
    return dict(e=e_flat, gate=gates.reshape(b, -1), pos=pos, keep=pos < cap, cap=cap)


@pytest.mark.parametrize("cf", [8.0, 1.25])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 16, 8, 2, 1), (2, 24, 8, 3, 0), (1, 64, 16, 2, 0)])
def test_moe_ffn_matches_reference(shape, dtype, cf):
    """``moe_ffn`` (output, aux) and its routing against the reference's:
    experts, slots and keep mask exactly, gates in f32 at 1e-6."""
    b, s, e, k, shared = shape
    cfg = _tiny_moe_cfg(cf=cf, top_k=k, n_shared=shared, n_experts=e)
    rcfg = _ref_moe_cfg(cf=cf, top_k=k, n_shared=shared, n_experts=e)
    rp = cast_tree(_ref_moe_params(rcfg), dtype)
    rp["router"] = rp["router"].astype(jnp.float32)
    x = jnp.asarray(normal((b, s, 32), 3, 0.7), getattr(jnp, dtype))
    want, want_aux = run_exact(lambda x, p: jmoe.moe_ffn(x, p, rcfg), x, rp)
    y, aux = tmoe.moe_ffn(port(x), port(rp), cfg)
    assert_matches(y, want, dtype)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-5)

    tp = port(rp)
    r = tmoe.route(rms_norm(port(x), tp["norm"]["scale"], cfg.norm_eps), tp, cfg)
    w = as_numpy(_ref_routing(x, rp, rcfg))
    assert r["cap"] == w["cap"]
    np.testing.assert_array_equal(r["e"].numpy(), w["e"])
    np.testing.assert_array_equal(r["pos"].numpy(), w["pos"])
    np.testing.assert_array_equal(r["keep"].numpy(), w["keep"])
    np.testing.assert_allclose(r["gate"].numpy(), w["gate"], rtol=1e-6, atol=1e-7)
    if cf == 1.25 and s >= 24:
        assert not w["keep"].all()  # the dropping path runs


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_top_k_breaks_ties_to_the_lower_index(k):
    """Planted ties: equal probabilities in a row come out lower index
    first, as ``jax.lax.top_k`` orders them."""
    rng = np.random.default_rng(k)
    probs = rng.integers(0, 4, (64, 8)).astype(np.float32) / 4  # many ties
    vals, idx = tmoe._top_k(torch.from_numpy(probs), k)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def test_moe_ffn_matches_reference_on_planted_router_ties():
    """Two experts with the same router column tie on every token: the
    port routes each token as the reference does (the lower expert first,
    and so the same slots and drops)."""
    cfg, rcfg = _tiny_moe_cfg(cf=1.25, top_k=2, n_experts=8), _ref_moe_cfg(
        cf=1.25, top_k=2, n_experts=8)
    rp = _ref_moe_params(rcfg)
    router = np.asarray(rp["router"]).copy()
    router[:, 5] = router[:, 2]
    router[:, 6] = router[:, 1]
    rp["router"] = jnp.asarray(router)
    x = jnp.asarray(normal((2, 32, 32), 4, 0.7), jnp.bfloat16)
    tp = port(rp)
    r = tmoe.route(rms_norm(port(x), tp["norm"]["scale"], cfg.norm_eps), tp, cfg)
    assert bool((r["probs"][..., 5] == r["probs"][..., 2]).all())
    w = as_numpy(_ref_routing(x, rp, rcfg))
    tied = np.isin(w["e"], [1, 2, 5, 6]).sum()
    assert tied > 0
    np.testing.assert_array_equal(r["e"].numpy(), w["e"])
    np.testing.assert_array_equal(r["pos"].numpy(), w["pos"])
    want, _ = run_exact(lambda x, p: jmoe.moe_ffn(x, p, rcfg), x, rp)
    assert_matches(tmoe.moe_ffn(port(x), tp, cfg)[0], want, "bfloat16")


# ----------------------------------------------------------- mamba vs reference
def _mamba_case(dtype: str):
    rcfg, cfg = ref_config("mamba2-780m"), get_smoke_config("mamba2-780m")
    p = jssm.init_mamba(rcfg, jax.random.key(0))
    if dtype == "float32":
        p = cast_tree(p, "float32")
    return rcfg, cfg, p


def _mamba_state(cfg, b: int, dtype: str, seed: int):
    """A decode state: conv of the activations' dtype, ssm f32, random."""
    _, nh, conv_dim = jssm._dims(cfg)
    s = cfg.ssm
    return {"conv": jnp.asarray(normal((b, s.d_conv - 1, conv_dim), seed, 0.5),
                                getattr(jnp, dtype)),
            "ssm": jnp.asarray(normal((b, nh, s.d_state, s.head_dim), seed + 1, 0.2))}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seq", [32, 24, 2])  # two chunks; one-chunk fallback; a tiny prefill
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_block_prefill_matches_reference(seq, dtype, with_state):
    rcfg, cfg, p = _mamba_case(dtype)
    x = jnp.asarray(normal((2, seq, rcfg.d_model), 5, 0.5), getattr(jnp, dtype))
    state = _mamba_state(rcfg, 2, dtype, 6) if with_state else None
    want, want_state = run_exact(lambda x, p, st: jssm.mamba_block(x, p, rcfg, st), x, p,
                                 state)
    got, got_state = tssm.mamba_block(port(x), port(p), cfg,
                                      port(state) if with_state else None)
    assert_matches(got, want, dtype)
    if with_state:
        assert_matches(got_state["conv"], want_state["conv"], dtype)
        assert_matches(got_state["ssm"], want_state["ssm"], "float32" if dtype == "float32"
                       else "bfloat16")
    else:
        assert got_state is None and want_state is None


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_block_decode_matches_reference(dtype):
    """Three decode steps from a random state; each writes the new state
    into the given tensors in place."""
    rcfg, cfg, p = _mamba_case(dtype)
    state = _mamba_state(rcfg, 2, dtype, 7)
    tstate = port(state)
    tp = port(p)
    decode = jax.jit(lambda x, p, st: jssm.mamba_block(x, p, rcfg, st))
    for t in range(3):
        x = jnp.asarray(normal((2, 1, rcfg.d_model), 8 + t, 0.5), getattr(jnp, dtype))
        want, state = exact(decode, x, p, state)(x, p, state)
        conv, ssm = tstate["conv"], tstate["ssm"]
        got, tstate = tssm.mamba_block(port(x), tp, cfg, tstate)
        assert tstate["conv"] is conv and tstate["ssm"] is ssm
        assert_matches(got, want, dtype)
        assert_matches(tstate["conv"], state["conv"], dtype)
        assert_matches(tstate["ssm"], state["ssm"], "float32" if dtype == "float32"
                       else "bfloat16")


def test_mamba_state_and_shapes_match_reference():
    rcfg, cfg = ref_config("jamba-v0.1-52b"), get_smoke_config("jamba-v0.1-52b")
    want = jssm.init_mamba_state(rcfg, 3)
    got = tssm.init_mamba_state(cfg, 3, device="cpu")
    for name in ("conv", "ssm"):
        assert tuple(got[name].shape) == want[name].shape
        assert str(got[name].dtype).removeprefix("torch.") == str(want[name].dtype)
    ref_p = jssm.init_mamba(rcfg, jax.random.key(0))
    built = Params(tssm.mamba_shapes(cfg), "meta")
    for name, t in built.named_parameters():
        leaf = ref_p
        for key in name.split("."):
            leaf = leaf[key]
        assert tuple(t.shape) == leaf.shape and str(t.dtype).endswith(str(leaf.dtype)), name


def test_softplus_is_logaddexp_above_twenty():
    """The port's ``_softplus`` (``logaddexp(x, 0)``, no linear branch above
    20 as ``F.softplus`` has) agrees with ``jax.nn.softplus`` over
    [-40, 40]."""
    x = np.linspace(-40.0, 40.0, 4001, dtype=np.float32)
    np.testing.assert_allclose(tssm._softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-7)


# -------------------------------------------------------------------- MLA
MLA_ARCHS = ["deepseek-v2-lite-16b", "kimi-k2-1t-a32b"]  # without / with q_lora


def _mla_case(arch: str, dtype: str):
    rcfg, cfg = ref_config(arch), get_smoke_config(arch)
    p = ja.init_mla(rcfg, jax.random.key(0))
    if dtype == "float32":
        p = cast_tree(p, "float32")
    return rcfg, cfg, p


def _positions(b, s, start=0):
    return np.broadcast_to(np.arange(start, start + s, dtype=np.int32)[None], (b, s)).copy()


@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_mla_shapes_match_reference(arch):
    rcfg, cfg = ref_config(arch), get_smoke_config(arch)
    ref_p = ja.init_mla(rcfg, jax.random.key(0))
    built = ta.init_mla(cfg, device="meta")
    names = set()
    for name, t in built.named_parameters():
        leaf = ref_p
        for key in name.split("."):
            leaf = leaf[key]
        assert tuple(t.shape) == leaf.shape and str(t.dtype).endswith(str(leaf.dtype)), name
        names.add(name)
    assert ("w_uq" in names) == bool(cfg.mla.q_lora_rank)


@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_mla_absorbed_equals_plain_f32(arch):
    """The absorbed decode form matches the decompressed (train) form at
    f32: the algebra behind the MLA cache (the reference's 2e-5)."""
    rcfg, cfg, p = _mla_case(arch, "float32")
    p = port(p)
    b, s = 2, 12
    x = torch.from_numpy(normal((b, s, cfg.d_model), 1, 0.3))
    pos = torch.from_numpy(_positions(b, s))
    full, _ = ta.mla_attention(x, p, cfg, pos, None)
    m = cfg.mla
    cache = {"c_kv": torch.zeros((b, s - 1, m.kv_lora_rank)),
             "k_pe": torch.zeros((b, s - 1, m.qk_rope_head_dim))}
    _, cache1 = ta.mla_attention(x[:, :s - 1], p, cfg, pos[:, :s - 1], cache)
    cache_full = {n: torch.nn.functional.pad(t, (0, 0, 0, 1)) for n, t in cache1.items()}
    last, _ = ta.mla_attention(x[:, s - 1:], p, cfg, pos[:, s - 1:], cache_full)
    torch.testing.assert_close(last[:, 0], full[:, -1], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("arch", MLA_ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cached", [False, True])
def test_mla_prefill_matches_reference(arch, dtype, cached):
    """The decompressed form (train, or a prefill that fills its cache)
    and the cache it returns."""
    rcfg, cfg, p = _mla_case(arch, dtype)
    b, s = 2, 10
    x = jnp.asarray(normal((b, s, rcfg.d_model), 2, 0.5), getattr(jnp, dtype))
    pos = _positions(b, s)
    m = rcfg.mla
    cache = ({"c_kv": jnp.zeros((b, s, m.kv_lora_rank), getattr(jnp, dtype)),
              "k_pe": jnp.zeros((b, s, m.qk_rope_head_dim), getattr(jnp, dtype))}
             if cached else None)
    want, want_cache = run_exact(lambda x, p, c: ja.mla_attention(x, p, rcfg, jnp.asarray(pos),
                                                                  c), x, p, cache)
    got, got_cache = ta.mla_attention(port(x), port(p), cfg, torch.from_numpy(pos),
                                      port(cache) if cached else None)
    assert_matches(got, want, dtype)
    if cached:
        for name in ("c_kv", "k_pe"):
            assert_matches(got_cache[name], want_cache[name], dtype)


@pytest.mark.parametrize("arch", MLA_ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_decode_matches_reference(arch, dtype):
    """The absorbed form over a random cache of 16 rows, at position 9:
    the output, and the cache with row 9 written in place."""
    rcfg, cfg, p = _mla_case(arch, dtype)
    b, smax, at = 2, 16, 9
    m = rcfg.mla
    dt = getattr(jnp, dtype)
    cache = {"c_kv": jnp.asarray(normal((b, smax, m.kv_lora_rank), 3, 0.5), dt),
             "k_pe": jnp.asarray(normal((b, smax, m.qk_rope_head_dim), 4, 0.5), dt)}
    x = jnp.asarray(normal((b, 1, rcfg.d_model), 5, 0.5), dt)
    pos = _positions(b, 1, at)
    want, want_cache = run_exact(lambda x, p, c: ja.mla_attention(x, p, rcfg, jnp.asarray(pos),
                                                                  c), x, p, cache)
    tcache = port(cache)
    c_kv = tcache["c_kv"]
    got, got_cache = ta.mla_attention(port(x), port(p), cfg, torch.from_numpy(pos), tcache)
    assert got_cache["c_kv"] is c_kv  # written in place
    assert_matches(got, want, dtype)
    for name in ("c_kv", "k_pe"):
        assert_matches(got_cache[name], want_cache[name], dtype)
        rows = [r for r in range(smax) if r != at]
        np.testing.assert_array_equal(got_cache[name][:, rows].float().numpy(),
                                      np.asarray(cache[name])[:, rows].astype(np.float32))
