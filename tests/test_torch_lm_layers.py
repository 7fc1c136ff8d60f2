"""The port's LM layers (``repro_torch.models.layers`` / ``attention``) vs the
JAX reference (``repro.models.layers`` / ``attention``), on the CPU.

Each function takes the same seeded numpy inputs and parameters (the
reference's ``init_*`` dicts, crossed as tensors; biases and gates
perturbed where the reference initialises them to zero, so that their
adds show).  Tolerances: f32 inputs at rtol = atol = 1e-5, the reference's
own component tolerance (``tests/test_components.py``); bf16 at rtol 2e-2
with an atol of two bf16 ulps of the largest |output|, the rule of
``chip_smoke.py:decode_tolerance``: the two sides round the same
f32-accumulated products to bf16, and a product whose sum the two
libraries order differently can round one ulp apart.

The port's versions of ``tests/test_components.py:202-243`` (GQA == MHA
with repeated KV heads, chunked == unchunked, the causal mask) close it.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as ref_config
from repro.models import attention as ja
from repro.models import layers as jl
from repro_torch.configs.base import get_smoke_config
from repro_torch.models import attention as ta
from repro_torch.models import layers as tl
from repro_torch.utils.interop import host_tensor

DTYPES = ["float32", "bfloat16"]


def bf16_tolerance(want: np.ndarray) -> tuple[float, float]:
    """rtol 2e-2 and two bf16 ulps of the largest |want|."""
    top = float(np.abs(want).max())
    return 2e-2, (2.0 * 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0)


def assert_matches(got: torch.Tensor, want, dtype: str) -> None:
    """got (a port tensor) == want (a reference array) in dtype's
    tolerance, with the same shape and dtype."""
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    got, want = got.float().numpy(), want.astype(np.float32)
    rtol, atol = (1e-5, 1e-5) if dtype == "float32" else bf16_tolerance(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def ref_array(x: np.ndarray, dtype: str):
    return jnp.asarray(x, getattr(jnp, dtype))


def port(x) -> torch.Tensor:
    """A reference array (or a tree of them) as the port's tensors, bit for
    bit (bf16 through its uint16 view)."""
    if isinstance(x, dict):
        return {k: port(v) for k, v in x.items()}
    a = np.asarray(x)
    return host_tensor(a).reshape(a.shape)


def cast_tree(tree, dtype: str):
    return jax.tree.map(lambda a: jnp.asarray(a, getattr(jnp, dtype)), tree)


def perturb(tree: dict, names, seed: int) -> dict:
    """The tree with the named (zero-initialised) leaves drawn at random."""
    rng = np.random.default_rng(seed)
    out = dict(tree)
    for name in names:
        if name in out:
            leaf = out[name]
            out[name] = jnp.asarray(rng.standard_normal(leaf.shape) * 0.5, leaf.dtype)
    return out


def normal(shape, seed: int, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------------------------------------- norms
@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm_matches_reference(dtype):
    x, scale = ref_array(normal((2, 16, 56), 0), dtype), ref_array(normal((56,), 1), dtype)
    assert_matches(tl.rms_norm(port(x), port(scale), 1e-6), jl.rms_norm(x, scale, 1e-6), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_layer_norm_matches_reference(dtype):
    x = ref_array(normal((2, 16, 64), 2, 3.0) + 1.5, dtype)
    scale, bias = ref_array(normal((64,), 3), dtype), ref_array(normal((64,), 4), dtype)
    assert_matches(tl.layer_norm(port(x), port(scale), port(bias), 1e-5),
                   jl.layer_norm(x, scale, bias, 1e-5), dtype)


@pytest.mark.parametrize("arch", ["qwen2-7b", "whisper-small"])  # rmsnorm / layernorm
@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_norm_matches_reference(arch, dtype):
    cfg, tcfg = ref_config(arch), get_smoke_config(arch)
    p = perturb(cast_tree(jl.init_norm(cfg, cfg.d_model), dtype), ["scale", "bias"], 5)
    x = ref_array(normal((2, 8, cfg.d_model), 6), dtype)
    assert_matches(tl.apply_norm(port(x), port(p), tcfg), jl.apply_norm(x, p, cfg), dtype)


# ------------------------------------------------------------------ rotary
@pytest.mark.parametrize("theta", [10000.0, 1e6])
@pytest.mark.parametrize("dim", [8, 128])
def test_rope_cos_sin_matches_reference(theta, dim):
    pos = np.broadcast_to(np.arange(4096, dtype=np.int32)[None], (2, 4096)).copy()
    pos[1] += 3
    jc, js = jl.rope_cos_sin(jnp.asarray(pos), dim, theta)
    tc, ts = tl.rope_cos_sin(torch.from_numpy(pos), dim, theta)
    assert_matches(tc, jc, "float32")
    assert_matches(ts, js, "float32")


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_rope_matches_reference(dtype):
    pos = jnp.asarray(np.arange(24, dtype=np.int32)[None].repeat(2, 0) + 500)
    cos, sin = jl.rope_cos_sin(pos, 16, 10000.0)
    x = ref_array(normal((2, 24, 3, 16), 7), dtype)
    assert_matches(tl.apply_rope(port(x), port(cos), port(sin)),
                   jl.apply_rope(x, cos, sin), dtype)


# -------------------------------------------------------------------- FFN
@pytest.mark.parametrize("arch", ["qwen2-7b", "whisper-small"])  # swiglu / gelu + biases
@pytest.mark.parametrize("dtype", DTYPES)
def test_dense_ffn_matches_reference(arch, dtype):
    cfg, tcfg = ref_config(arch), get_smoke_config(arch)
    p = jl.init_dense_ffn(cfg, jax.random.key(1), cfg.d_model, cfg.d_ff)
    p = perturb(cast_tree(p, dtype), ["b1", "b2"], 8)
    p["norm"] = perturb(p["norm"], ["bias"], 9)
    x = ref_array(normal((2, 8, cfg.d_model), 10), dtype)
    assert_matches(tl.dense_ffn(port(x), port(p), tcfg), jl.dense_ffn(x, p, cfg), dtype)


def test_dense_ffn_shapes_match_reference_init():
    for arch in ("qwen2-7b", "whisper-small"):
        cfg = ref_config(arch)
        want = jax.tree.map(lambda a: a.shape, jl.init_dense_ffn(cfg, jax.random.key(0),
                                                                 cfg.d_model, cfg.d_ff))
        spec = tl.dense_ffn_shapes(get_smoke_config(arch), cfg.d_model, cfg.d_ff)
        assert jax.tree.map(lambda e: e[0], spec, is_leaf=lambda e: isinstance(e, tuple)) == want


# -------------------------------------------------------------- embeddings
@pytest.mark.parametrize("arch", ["qwen2-7b", "minicpm-2b"])  # emb_scale 1 / 12
def test_embed_tokens_matches_reference(arch):
    cfg, tcfg = ref_config(arch), get_smoke_config(arch)
    table = jl.init_embed(cfg, jax.random.key(2))
    tokens = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 9), dtype=np.int32)
    got = tl.embed_tokens(port(table), torch.from_numpy(tokens), tcfg)
    want = jl.embed_tokens(table, jnp.asarray(tokens), cfg)
    assert torch.equal(got, port(want))


@pytest.mark.parametrize("arch", ["qwen2-7b", "minicpm-2b"])  # untied / tied with divisor
@pytest.mark.parametrize("dtype", DTYPES)
def test_lm_logits_matches_reference(arch, dtype):
    cfg, tcfg = ref_config(arch), get_smoke_config(arch)
    params = {"embed": jl.init_embed(cfg, jax.random.key(3)),
              "final_norm": jl.init_norm(cfg, cfg.d_model),
              "lm_head": jnp.asarray(normal((cfg.d_model, cfg.vocab_padded), 12, 0.02),
                                     jnp.bfloat16)}
    params = cast_tree(params, dtype)
    x = ref_array(normal((2, 5, cfg.d_model), 13), dtype)
    got, want = tl.lm_logits(port(x), port(params), tcfg), jl.lm_logits(x, params, cfg)
    assert got.dtype == torch.float32
    assert_matches(got, want, "float32" if dtype == "float32" else "bfloat16")


# --------------------------------------------------------------- attention
def qkv(b, s, hq, hkv, hd, dtype, seed, skv=None):
    skv = skv or s
    return (ref_array(normal((b, s, hq, hd), seed), dtype),
            ref_array(normal((b, skv, hkv, hd), seed + 1), dtype),
            ref_array(normal((b, skv, hkv, hd), seed + 2), dtype))


def positions(b, s, start=0):
    return np.broadcast_to(np.arange(start, start + s, dtype=np.int32)[None], (b, s)).copy()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("chunk_q", [16, 512])  # chunked / whole
def test_grouped_attention_matches_reference(dtype, causal, chunk_q):
    q, k, v = qkv(2, 64, 8, 2, 16, dtype, 20)
    pos = positions(2, 64)
    want = ja.grouped_attention(q, k, v, q_pos=jnp.asarray(pos), causal=causal, chunk_q=chunk_q)
    got = ta.grouped_attention(port(q), port(k), port(v), q_pos=torch.from_numpy(pos),
                               causal=causal, chunk_q=chunk_q)
    assert_matches(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_over_padded_cache_matches_reference(dtype):
    """One query at position 20 over a cache of 32 rows whose rows 21..31
    are zeros: the -1e30 logits leave the padding out."""
    q, k, v = qkv(2, 1, 4, 2, 16, dtype, 30, skv=32)
    k, v = k.at[:, 21:].set(0), v.at[:, 21:].set(0)
    pos = np.full((2, 1), 20, np.int32)
    want = ja.grouped_attention(q, k, v, q_pos=jnp.asarray(pos))
    got = ta.grouped_attention(port(q), port(k), port(v), q_pos=torch.from_numpy(pos))
    assert_matches(got, want, dtype)
    short = ta.grouped_attention(port(q), port(k)[:, :21], port(v)[:, :21],
                                 q_pos=torch.from_numpy(pos))
    assert torch.equal(got, short)


@pytest.mark.parametrize("arch", ["qwen2-7b", "llama-3.2-vision-11b", "whisper-small"])
@pytest.mark.parametrize("cross", [False, True])
def test_init_attention_shapes_match_reference(arch, cross):
    cfg = ref_config(arch)
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        ja.init_attention(cfg, jax.random.key(0), cross=cross))
    p = ta.init_attention(get_smoke_config(arch), cross=cross, device="meta")
    got = {name: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for name, t in p.named_parameters()}
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda x: isinstance(x, tuple))[0]}
    assert got == {k.replace("/", "."): v for k, v in flat.items()}


def attention_params(cfg, dtype, seed, *, cross=False):
    p = ja.init_attention(cfg, jax.random.key(seed), cross=cross)
    p = perturb(cast_tree(p, dtype), ["bq", "bk", "bv"], seed)
    if cross:
        p["gate"] = jnp.asarray(0.7, jnp.float32)
    return p


@pytest.mark.parametrize("dtype", DTYPES)
def test_project_qkv_matches_reference(dtype):
    cfg, tcfg = ref_config("qwen2-7b"), get_smoke_config("qwen2-7b")
    p = attention_params(cfg, dtype, 40)
    h = ref_array(normal((2, 6, cfg.d_model), 41), dtype)
    ctx = ref_array(normal((2, 9, cfg.d_model), 42), dtype)
    for c in (None, ctx):
        want = ja._project_qkv(h, p, cfg, ctx=c)
        got = ta._project_qkv(port(h), port(p), tcfg, ctx=None if c is None else port(c))
        for g, w in zip(got, want):
            assert_matches(g, w, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_self_attention_prefill_then_decode_matches_reference(dtype):
    """Prefill fills a cache of its own length; then a decode step at
    position 8 writes row 8 of a cache extended to 12 rows (the rest stay)
    and attends over all 12 under the mask."""
    cfg, tcfg = ref_config("qwen2-7b"), get_smoke_config("qwen2-7b")
    p = attention_params(cfg, dtype, 50)
    hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    x = ref_array(normal((2, 8, cfg.d_model), 51), dtype)
    cache = {"k": jnp.zeros((2, 8, hkv, hd), x.dtype), "v": jnp.zeros((2, 8, hkv, hd), x.dtype)}
    want, wc = ja.self_attention(x, p, cfg, jnp.asarray(positions(2, 8)), cache)
    got, gc = ta.self_attention(port(x), port(p), tcfg, torch.from_numpy(positions(2, 8)),
                                port(cache))
    assert_matches(got, want, dtype)
    for name in ("k", "v"):
        assert_matches(gc[name], wc[name], dtype)

    wc = {n: jnp.pad(a, ((0, 0), (0, 4), (0, 0), (0, 0))) for n, a in wc.items()}
    gc = {n: torch.cat([t, t.new_zeros((2, 4, hkv, hd))], dim=1) for n, t in gc.items()}
    before = {n: t.clone() for n, t in gc.items()}
    xd = ref_array(normal((2, 1, cfg.d_model), 52), dtype)
    pos = np.full((2, 1), 8, np.int32)
    want, wc = ja.self_attention(xd, p, cfg, jnp.asarray(pos), wc)
    got, gc = ta.self_attention(port(xd), port(p), tcfg, torch.from_numpy(pos), gc)
    assert_matches(got, want, dtype)
    for name in ("k", "v"):
        assert_matches(gc[name], wc[name], dtype)
        rows = [r for r in range(12) if r != 8]
        assert torch.equal(gc[name][:, rows], before[name][:, rows])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("gated", [False, True])
def test_cross_attention_prefill_then_decode_matches_reference(dtype, gated):
    """Prefill projects and caches the context's K / V; decode reuses them
    (ctx None) with a query of its own."""
    cfg, tcfg = ref_config("llama-3.2-vision-11b"), get_smoke_config("llama-3.2-vision-11b")
    p = attention_params(cfg, dtype, 60, cross=gated)
    hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    x = ref_array(normal((2, 5, cfg.d_model), 61), dtype)
    ctx = ref_array(normal((2, cfg.n_image_tokens, cfg.d_model), 62), dtype)
    empty = {"ck": jnp.zeros((2, cfg.n_image_tokens, hkv, hd), x.dtype),
             "cv": jnp.zeros((2, cfg.n_image_tokens, hkv, hd), x.dtype)}
    want, wc = ja.cross_attention(x, p, cfg, ctx, empty, gated=gated)
    got, gc = ta.cross_attention(port(x), port(p), tcfg, port(ctx), port(empty), gated=gated)
    assert_matches(got, want, dtype)
    for name in ("ck", "cv"):
        assert_matches(gc[name], wc[name], dtype)
    xd = ref_array(normal((2, 1, cfg.d_model), 63), dtype)
    want, _ = ja.cross_attention(xd, p, cfg, None, wc, gated=gated)
    got, _ = ta.cross_attention(port(xd), port(p), tcfg, None, gc, gated=gated)
    assert_matches(got, want, dtype)
    no_cache, _ = ja.cross_attention(x, p, cfg, ctx, None, gated=gated)
    got, none = ta.cross_attention(port(x), port(p), tcfg, port(ctx), None, gated=gated)
    assert none is None
    assert_matches(got, no_cache, dtype)


# ---------------------------------------- tests/test_components.py:202-243
def test_gqa_equals_repeated_mha():
    """GQA(kv=2) == MHA with KV heads explicitly repeated."""
    rng = np.random.default_rng(0)
    b, s, hq, hkv, hd = 2, 16, 8, 2, 16
    q = torch.from_numpy(rng.standard_normal((b, s, hq, hd)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, s, hkv, hd)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, s, hkv, hd)).astype(np.float32))
    pos = torch.from_numpy(positions(b, s))
    got = ta.grouped_attention(q, k, v, q_pos=pos)
    krep = torch.repeat_interleave(k, hq // hkv, dim=2)
    vrep = torch.repeat_interleave(v, hq // hkv, dim=2)
    want = ta.grouped_attention(q, krep, vrep, q_pos=pos)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_chunked_attention_matches_unchunked():
    rng = np.random.default_rng(1)
    b, s, h, hd = 1, 64, 2, 8
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, hd)).astype(np.float32))
               for _ in range(3))
    pos = torch.from_numpy(positions(b, s))
    a1 = ta.grouped_attention(q, k, v, q_pos=pos, chunk_q=16)
    a2 = ta.grouped_attention(q, k, v, q_pos=pos, chunk_q=1024)
    torch.testing.assert_close(a1, a2, rtol=1e-5, atol=1e-5)


def test_causal_mask_blocks_future():
    """Perturbing future tokens must not change past outputs."""
    rng = np.random.default_rng(2)
    b, s, h, hd = 1, 12, 2, 8
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, hd)).astype(np.float32))
               for _ in range(3))
    pos = torch.from_numpy(positions(b, s))
    base = ta.grouped_attention(q, k, v, q_pos=pos)
    k2, v2 = k.clone(), v.clone()
    k2[:, 8:] = 99.0
    v2[:, 8:] = -99.0
    pert = ta.grouped_attention(q, k2, v2, q_pos=pos)
    torch.testing.assert_close(base[:, :8], pert[:, :8], rtol=1e-5, atol=1e-5)
