"""Shared layer primitives: norms, rotary embedding, FFNs, embeddings.

Counterpart of ``repro.models.layers``, as plain functions on tensors.  A
parameter group ``p`` is any mapping of names to tensors (the port's
``Params`` modules, the reference's dicts).

Numerics policy, cast for cast as the reference: parameters and
activations in bf16; norms and the FFN's activation in f32 (upcast at the
op, downcast after); rotary cos / sin computed in f32 and cast to x's
dtype before the products; the LM head's product on f32 operands
(the reference's ``preferred_element_type=f32``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig


DRAW_SLICE = 2 ** 30  # the most elements ``Params.draw_`` draws at once


def _draw(shape, init, generator: torch.Generator, device) -> torch.Tensor:
    """One f32 draw of ``init`` (a normal's scale, "a_log" or "dt_bias")."""
    if init in ("a_log", "dt_bias"):
        u = torch.rand(shape, generator=generator, dtype=torch.float32, device=device)
        if init == "a_log":
            return torch.log(u * 15.0 + 1.0)
        lo, hi = math.log(0.001), math.log(0.1)
        dt = torch.exp(u * (hi - lo) + lo)
        return dt + torch.log(-torch.expm1(-dt))  # inverse softplus
    return torch.randn(shape, generator=generator, dtype=torch.float32, device=device) * init


class Params(nn.Module):
    """A node of the parameter tree, read as ``p["name"]`` like the
    reference's dicts: tensors (bf16; f32 where the reference keeps f32:
    the tanh gate, the MoE router, the SSD block's ``A_log``, ``D`` and
    ``dt_bias``) and nested nodes.

    Built from a spec of name → (shape, init[, dtype]) or name → a nested
    spec; init is the scale of a normal draw (the reference's ``init_*``
    scales), "ones", "zeros", or one of the SSD block's draws "a_log" /
    "dt_bias" (``ssm.mamba_shapes``).  The tensors start uninitialised (on
    the meta device they hold no memory); ``draw_`` fills them.  They take
    no gradient: the port runs forward passes only."""

    def __init__(self, spec: dict, device):
        super().__init__()
        self.inits: dict[str, object] = {}
        for name, entry in spec.items():
            if isinstance(entry, dict):
                self.add_module(name, Params(entry, device))
                continue
            shape, init, *dtype = entry
            t = torch.empty(shape, dtype=dtype[0] if dtype else torch.bfloat16, device=device)
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))
            self.inits[name] = init

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    @torch.no_grad()
    def draw_(self, generator: torch.Generator) -> None:
        """Fill this node's own tensors: ``normal × scale`` drawn in f32 and
        cast, as the reference's ``(jax.random.normal(k, shape) *
        scale).astype(bf16)``; ones; zeros; the SSD block's ``A_log =
        log(U(1, 16))`` and ``dt_bias``, the inverse softplus of ``dt =
        exp(U·(log 0.1 − log 0.001) + log 0.001)`` (``ssm.py:38-58`` of the
        reference).  A tensor of more than ``DRAW_SLICE`` elements is drawn
        in slices along its first axis, so that the f32 temporary stays
        small beside the model (Kimi K2's (384, 7168, 2048) experts)."""
        for name, init in self.inits.items():
            t = self._parameters[name]
            if init == "ones":
                t.fill_(1)
            elif init == "zeros":
                t.zero_()
            else:
                rows = max(1, DRAW_SLICE // max(1, t[0].numel())) if t.dim() else 1
                for part in (t.split(rows) if t.dim() else (t,)):
                    part.copy_(_draw(part.shape, init, generator, part.device).to(t.dtype))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def apply_norm(x: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm_kind == "layernorm":
        return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rms_norm(x, p["scale"], cfg.norm_eps)


def norm_shapes(cfg: ModelConfig, d: int) -> dict:
    """Name → (shape, init) of a norm's parameters."""
    shapes = {"scale": ((d,), "ones")}
    if cfg.norm_kind == "layernorm":
        shapes["bias"] = ((d,), "zeros")
    return shapes


# ------------------------------------------------------------------ rotary
def rope_cos_sin(positions: torch.Tensor, dim: int,
                 theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) int → cos/sin (..., dim/2) f32."""
    exponent = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    base = torch.full((), theta, dtype=torch.float32, device=positions.device)
    inv_freq = 1.0 / torch.pow(base, exponent)
    ang = positions.float()[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, hd); cos/sin (B, S, hd/2).  Pairs are (even, odd) halves
    (llama convention: rotate_half)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# -------------------------------------------------------------------- FFN
def dense_ffn_shapes(cfg: ModelConfig, d_in: int, d_ff: int) -> dict:
    """Name → (shape, init) of a dense FFN's parameters: init is a normal
    draw's scale (the reference's ``init_dense_ffn``), "ones" or "zeros";
    ``norm`` is a nested group."""
    shapes = {
        "norm": norm_shapes(cfg, d_in),
        "w1": ((d_in, d_ff), d_in ** -0.5),
        "w2": ((d_ff, d_in), d_ff ** -0.5),
    }
    if cfg.act == "swiglu":
        shapes["w3"] = ((d_in, d_ff), d_in ** -0.5)
    else:  # gelu MLPs (whisper) carry biases
        shapes["b1"] = ((d_ff,), "zeros")
        shapes["b2"] = ((d_in,), "zeros")
    return shapes


def dense_ffn(x: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    """Post-norm-input FFN body (caller adds the residual)."""
    h = apply_norm(x, p["norm"], cfg)
    if cfg.act == "swiglu":
        a = h @ p["w1"]
        g = h @ p["w3"]
        return (F.silu(a.float()).to(x.dtype) * g) @ p["w2"]
    a = h @ p["w1"] + p["b1"]
    a = F.gelu(a.float(), approximate="tanh").to(x.dtype)  # jax.nn.gelu's default
    return a @ p["w2"] + p["b2"]


# -------------------------------------------------------------- embeddings
def scalar_like(x: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` as a 0-d tensor of x's dtype: a product with it rounds the
    constant to that dtype first, as ``jnp.asarray(value, x.dtype)``."""
    return torch.full((), value, dtype=x.dtype, device=x.device)


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = table[tokens.long()]
    if cfg.emb_scale != 1.0:
        x = x * scalar_like(x, cfg.emb_scale)
    return x


def lm_logits(x: torch.Tensor, params, cfg: ModelConfig) -> torch.Tensor:
    """Final-norm → LM head; f32 logits."""
    x = apply_norm(x, params["final_norm"], cfg)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = torch.matmul(x.float(), head.float())
    if cfg.logits_divisor != 1.0:
        logits = logits / cfg.logits_divisor
    return logits
