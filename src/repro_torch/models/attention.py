"""Attention: GQA/MHA (+QKV bias), MLA (DeepSeek latent attention), cross.

Counterpart of ``repro.models.attention``.  Queries are processed in
chunks of ``chunk_q`` where the reference chunks them, bounding the
transient score matrix to (B, Hkv, g, cq, Skv).  Logits and softmax in f32
(the operands of the QK product widened to f32, the reference's
``preferred_element_type=f32``), P cast to v's dtype for the PV product.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Params, apply_norm, apply_rope, norm_shapes, rope_cos_sin

NEG_INF = -1e30


def _attn_core(q, k, v, *, q_pos, causal: bool, scale: float) -> torch.Tensor:
    """q (B,Sq,Hkv,g,hd), k/v (B,Skv,Hkv,hd), q_pos (B,Sq) → (B,Sq,Hkv,g,hd)."""
    logits = torch.einsum("bqhgd,bshd->bhgqs", q.float(), k.float())
    logits = logits * scale
    if causal:
        kv_pos = torch.arange(k.shape[1], dtype=torch.int32, device=k.device)
        mask = kv_pos[None, None, None, None, :] <= q_pos[:, None, None, :, None]
        logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhgqs,bshd->bqhgd", p.to(v.dtype), v)


def grouped_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_pos: torch.Tensor,
    causal: bool = True,
    chunk_q: int = 512,
    scale: float | None = None,
) -> torch.Tensor:
    """q (B,Sq,Hq,hd), k/v (B,Skv,Hkv,hd) → (B,Sq,Hq,hd)."""
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else hd ** -0.5
    qg = q.reshape(b, sq, hkv, g, hd)

    vd = v.shape[-1]
    if sq <= chunk_q or sq % chunk_q:
        out = _attn_core(qg, k, v, q_pos=q_pos, causal=causal, scale=scale)
        return out.reshape(b, sq, hq, vd)
    out = torch.cat([
        _attn_core(qg[:, i:i + chunk_q], k, v, q_pos=q_pos[:, i:i + chunk_q],
                   causal=causal, scale=scale)
        for i in range(0, sq, chunk_q)
    ], dim=1)
    return out.reshape(b, sq, hq, vd)


# ----------------------------------------------------------------- GQA/MHA
def attention_shapes(cfg: ModelConfig, *, cross: bool = False) -> dict:
    """The spec of an attention block's parameters (``layers.Params``), with
    the reference's ``init_attention`` scales."""
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    sc = d ** -0.5
    spec = {
        "norm": norm_shapes(cfg, d),
        "wq": ((d, hq * hd), sc),
        "wk": ((d, hkv * hd), sc),
        "wv": ((d, hkv * hd), sc),
        "wo": ((hq * hd, d), (hq * hd) ** -0.5),
    }
    if cfg.qkv_bias:
        spec["bq"] = ((hq * hd,), "zeros")
        spec["bk"] = ((hkv * hd,), "zeros")
        spec["bv"] = ((hkv * hd,), "zeros")
    if cross:
        # Zero-init tanh gate (llama-3.2-vision cross-attn injection).
        spec["gate"] = ((), "zeros", torch.float32)
    return spec


def init_attention(cfg: ModelConfig, *, cross: bool = False, device="cuda") -> Params:
    """An attention block's parameters on ``device``, not yet drawn
    (``Params.draw_``)."""
    return Params(attention_shapes(cfg, cross=cross), device)


def _project_qkv(h, p, cfg, ctx=None):
    b, s, _ = h.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    src = h if ctx is None else ctx
    q = h @ p["wq"]
    k = src @ p["wk"]
    v = src @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(*src.shape[:2], hkv, hd)
    v = v.reshape(*src.shape[:2], hkv, hd)
    return q, k, v


def self_attention(
    x: torch.Tensor,
    p,
    cfg: ModelConfig,
    positions: torch.Tensor,
    cache: dict | None = None,
    *,
    causal: bool = True,
) -> tuple[torch.Tensor, dict | None]:
    """Returns (residual_delta, new_cache).

    cache = {"k": (B,Smax,Hkv,hd), "v": ...}: a prefill whose length is the
    cache's fills it with this call's k / v; a decode writes its rows into
    the cache in place at positions[0, 0] (lockstep batch decode) and
    attends over the whole cache under the ``kv_pos <= q_pos`` mask.
    """
    h = apply_norm(x, p["norm"], cfg)
    q, k, v = _project_qkv(h, p, cfg)
    cos, sin = rope_cos_sin(positions, cfg.head_dim_, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    new_cache = None
    if cache is not None:
        if x.shape[1] == cache["k"].shape[1]:  # prefill fills the whole cache
            new_cache = {"k": k, "v": v}
        else:  # decode: write the new rows at the current position
            rows = positions[0, :1].long() + torch.arange(x.shape[1], device=x.device)
            cache["k"].index_copy_(1, rows, k)
            cache["v"].index_copy_(1, rows, v)
            new_cache = {"k": cache["k"], "v": cache["v"]}
        k, v = new_cache["k"], new_cache["v"]

    out = grouped_attention(q, k, v, q_pos=positions, causal=causal)
    b, s = x.shape[:2]
    return out.reshape(b, s, -1) @ p["wo"], new_cache


def cross_attention(
    x: torch.Tensor,
    p,
    cfg: ModelConfig,
    ctx_embeds: torch.Tensor | None,
    cache: dict | None = None,
    *,
    gated: bool = False,
) -> tuple[torch.Tensor, dict | None]:
    """Attention over context embeddings (image patches / encoder output).

    At prefill the projected context K/V are cached; decode reuses them.
    """
    h = apply_norm(x, p["norm"], cfg)
    if cache is not None and ctx_embeds is None:
        b, s, _ = h.shape
        hq, hd = cfg.n_heads, cfg.head_dim_
        q = (h @ p["wq"]).reshape(b, s, hq, hd)
        if cfg.qkv_bias:
            q = q + p["bq"].reshape(hq, hd)
        k, v = cache["ck"], cache["cv"]
        new_cache = cache
    else:
        q, k, v = _project_qkv(h, p, cfg, ctx=ctx_embeds)
        new_cache = {"ck": k, "cv": v} if cache is not None else None
    qp = torch.zeros(q.shape[:2], dtype=torch.int32, device=q.device)  # no mask
    out = grouped_attention(q, k, v, q_pos=qp, causal=False)
    b, s = x.shape[:2]
    out = out.reshape(b, s, -1) @ p["wo"]
    if gated:
        out = out * torch.tanh(p["gate"]).to(out.dtype)
    return out, new_cache


# --------------------------------------------------------------------- MLA
def mla_shapes(cfg: ModelConfig) -> dict:
    """The spec of an MLA block's parameters (``layers.Params``), with the
    reference's ``init_mla`` scales: a low-rank q projection (``w_dq``,
    ``q_norm``, ``w_uq``) when ``q_lora_rank`` is set, else ``wq``."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    nd, rd, vd, rkv, rq = (m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim,
                           m.kv_lora_rank, m.q_lora_rank)
    sc = d ** -0.5
    spec = {
        "norm": norm_shapes(cfg, d),
        "w_dkv": ((d, rkv), sc),
        "kv_norm": norm_shapes(cfg, rkv),
        "w_kpe": ((d, rd), sc),
        "w_uk": ((rkv, h * nd), rkv ** -0.5),
        "w_uv": ((rkv, h * vd), rkv ** -0.5),
        "wo": ((h * vd, d), (h * vd) ** -0.5),
    }
    if rq:
        spec["w_dq"] = ((d, rq), sc)
        spec["q_norm"] = norm_shapes(cfg, rq)
        spec["w_uq"] = ((rq, h * (nd + rd)), rq ** -0.5)
    else:
        spec["wq"] = ((d, h * (nd + rd)), sc)
    return spec


def init_mla(cfg: ModelConfig, *, device="cuda") -> Params:
    """An MLA block's parameters on ``device``, not yet drawn."""
    return Params(mla_shapes(cfg), device)


def _mla_q(h, p, cfg, cos, sin):
    m = cfg.mla
    b, s, _ = h.shape
    nh, nd, rd = cfg.n_heads, m.qk_nope_head_dim, m.qk_rope_head_dim
    if m.q_lora_rank:
        cq = apply_norm(h @ p["w_dq"], p["q_norm"], cfg)
        q = cq @ p["w_uq"]
    else:
        q = h @ p["wq"]
    q = q.reshape(b, s, nh, nd + rd)
    q_nope, q_pe = q[..., :nd], q[..., nd:]
    q_pe = apply_rope(q_pe, cos, sin)
    return q_nope, q_pe


def mla_attention(
    x: torch.Tensor,
    p,
    cfg: ModelConfig,
    positions: torch.Tensor,
    cache: dict | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """MLA forward.  Returns (residual_delta, new_cache).

    Train and prefill decompress K/V per head and attend with
    ``grouped_attention`` at scale (nd + rd)^-0.5; decode uses the absorbed
    form (score and context computed in the kv_lora latent space, the
    reason the cache is only (B, S, rkv + rd) a layer).  The branch is the
    reference's: a call is a decode when it has a cache whose length is
    not its own; it writes its ``c_kv`` / ``k_pe`` rows into the cache in
    place at positions[0, 0] and attends over the whole cache under the
    ``kv_pos <= q_pos`` mask.  The two forms round differently in bf16."""
    m = cfg.mla
    b, s, _ = x.shape
    nh = cfg.n_heads
    nd, rd, vd, rkv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim, m.kv_lora_rank
    scale = (nd + rd) ** -0.5

    h = apply_norm(x, p["norm"], cfg)
    cos, sin = rope_cos_sin(positions, rd, cfg.rope_theta)
    q_nope, q_pe = _mla_q(h, p, cfg, cos, sin)

    c_kv = apply_norm(h @ p["w_dkv"], p["kv_norm"], cfg)  # (B,S,rkv)
    k_pe = apply_rope((h @ p["w_kpe"]).reshape(b, s, 1, rd), cos, sin)[:, :, 0]

    decode = cache is not None and s != cache["c_kv"].shape[1]
    new_cache = None
    if cache is not None:
        if not decode:
            new_cache = {"c_kv": c_kv, "k_pe": k_pe}
        else:
            rows = positions[0, :1].long() + torch.arange(s, device=x.device)
            cache["c_kv"].index_copy_(1, rows, c_kv)
            cache["k_pe"].index_copy_(1, rows, k_pe)
            new_cache = {"c_kv": cache["c_kv"], "k_pe": cache["k_pe"]}
        c_kv, k_pe = new_cache["c_kv"], new_cache["k_pe"]

    skv = c_kv.shape[1]
    if decode:
        kv_pos = torch.arange(skv, dtype=torch.int32, device=x.device)
        mask = kv_pos[None, None, None, :] <= positions[:, None, :, None]  # (B,1,Sq,Skv)
        # Absorbed: q_lat = q_nope · W_uk → score in latent space.
        w_uk = p["w_uk"].reshape(rkv, nh, nd)
        q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope, w_uk)
        logits = torch.einsum("bqhr,bsr->bhqs", q_lat.float(), c_kv.float())
        logits = logits + torch.einsum("bqhr,bsr->bhqs", q_pe.float(), k_pe.float())
        logits = torch.where(mask, logits * scale, NEG_INF)
        prob = torch.softmax(logits, dim=-1)
        ctx = torch.einsum("bhqs,bsr->bqhr", prob.to(c_kv.dtype), c_kv)
        w_uv = p["w_uv"].reshape(rkv, nh, vd)
        out = torch.einsum("bqhr,rhv->bqhv", ctx, w_uv)
    else:
        k_nope = (c_kv @ p["w_uk"]).reshape(b, skv, nh, nd)
        v = (c_kv @ p["w_uv"]).reshape(b, skv, nh, vd)
        k_full = torch.cat([k_nope, k_pe[:, :, None, :].expand(b, skv, nh, rd)], dim=-1)
        q_full = torch.cat([q_nope, q_pe], dim=-1)
        out = grouped_attention(q_full, k_full, v, q_pos=positions, causal=True, scale=scale)

    return out.reshape(b, s, nh * vd) @ p["wo"], new_cache
