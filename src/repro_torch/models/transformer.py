"""The layer stack: ``n_layers`` layers in pattern order, each dispatching
on its kind.

Counterpart of ``repro.models.transformer``.  The reference stacks each
pattern slot's parameters over the ``n_periods`` repetitions and scans
them; the port holds layer ``p·len(pattern) + i`` (pattern slot i of
repetition p) as entry ``p·len(pattern) + i`` of an ``nn.ModuleList`` and
runs the layers in a Python loop.  Caches are a list with one dict a layer.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import Params, dense_ffn, dense_ffn_shapes, scalar_like
from repro_torch.models.moe_a2a import moe_ffn_a2a

SELF_CACHE = ("k", "v", "c_kv", "k_pe")  # a self-attention layer's cache entries


class Layer(nn.Module):
    """One pattern layer: ``mixer`` (an SSD block for "mamba", gated
    cross-attention for "cross_attn", else self-attention: MLA when the
    config has ``mla``, GQA / MHA otherwise), for "attn_cross" a ``cross``
    attention after it, and a dense or MoE ``ffn`` or none; each adds its
    delta to the residual, scaled by ``cfg.residual_scale`` in x's dtype.
    The MoE FFN runs ``moe_ffn_a2a`` when ``cfg.moe_impl`` is "a2a", else
    ``moe_ffn``, as the reference's ``apply_layer``."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, *, device="cuda"):
        super().__init__()
        self.cfg, self.spec = cfg, spec
        if spec.kind == "mamba":
            self.mixer = ssm_mod.init_mamba(cfg, device=device)
        elif spec.kind == "cross_attn":
            self.mixer = attn.init_attention(cfg, cross=True, device=device)
        else:  # attn | attn_cross
            if cfg.mla is not None:
                self.mixer = attn.init_mla(cfg, device=device)
            else:
                self.mixer = attn.init_attention(cfg, device=device)
            if spec.kind == "attn_cross":
                self.cross = attn.init_attention(cfg, device=device)
        if spec.ffn == "dense":
            self.ffn = Params(dense_ffn_shapes(cfg, cfg.d_model, cfg.d_ff), device)
        elif spec.ffn == "moe":
            self.ffn = moe_mod.init_moe(cfg, device=device)

    def forward(
        self,
        x: torch.Tensor,
        positions: torch.Tensor,
        cache: dict | None = None,
        ctx_embeds: torch.Tensor | None = None,
        causal: bool = True,
    ) -> tuple[torch.Tensor, dict | None, torch.Tensor | None]:
        """Returns (x, new_cache, aux_loss: f32, None without a MoE FFN)."""
        cfg, spec = self.cfg, self.spec
        aux = None
        rs = scalar_like(x, cfg.residual_scale) if cfg.residual_scale != 1.0 else None

        def add_resid(x, delta):
            return x + (delta * rs if rs is not None else delta)

        new_cache: dict = {}
        if spec.kind == "mamba":
            delta, st = ssm_mod.mamba_block(x, self.mixer, cfg, cache)
            if st is not None:
                new_cache.update(st)
            x = add_resid(x, delta)
        elif spec.kind == "cross_attn":
            delta, cc = attn.cross_attention(x, self.mixer, cfg, ctx_embeds, cache, gated=True)
            if cc is not None:
                new_cache.update(cc)
            x = add_resid(x, delta)
        else:
            self_cache = (
                {k: v for k, v in cache.items() if k in SELF_CACHE} if cache is not None
                else None
            )
            if cfg.mla is not None:
                delta, sc = attn.mla_attention(x, self.mixer, cfg, positions, self_cache)
            else:
                delta, sc = attn.self_attention(x, self.mixer, cfg, positions, self_cache,
                                                causal=causal)
            if sc is not None:
                new_cache.update(sc)
            x = add_resid(x, delta)
            if spec.kind == "attn_cross":
                cross_cache = (
                    {k: v for k, v in cache.items() if k in ("ck", "cv")}
                    if cache is not None else None
                )
                delta, cc = attn.cross_attention(x, self.cross, cfg, ctx_embeds, cross_cache)
                if cc is not None:
                    new_cache.update(cc)
                x = add_resid(x, delta)

        if spec.ffn == "dense":
            x = add_resid(x, dense_ffn(x, self.ffn, cfg))
        elif spec.ffn == "moe":
            moe_fn = moe_ffn_a2a if cfg.moe_impl == "a2a" else moe_mod.moe_ffn
            delta, aux = moe_fn(x, self.ffn, cfg)
            x = add_resid(x, delta)
        return x, (new_cache or None), aux


def init_stack(cfg: ModelConfig, pattern=None, n_layers=None, *, device="cuda") -> nn.ModuleList:
    """The ``n_layers`` layers (default ``cfg.n_layers``) in pattern order,
    parameters not yet drawn."""
    pattern = pattern or cfg.layer_pattern
    n = n_layers or cfg.n_layers
    return nn.ModuleList(Layer(cfg, pattern[j % len(pattern)], device=device) for j in range(n))


def stack_forward(
    x: torch.Tensor,
    layers: nn.ModuleList,
    cfg: ModelConfig,
    positions: torch.Tensor,
    caches: list | None = None,
    ctx_embeds: torch.Tensor | None = None,
    *,
    causal: bool = True,
) -> tuple[torch.Tensor, list | None, torch.Tensor]:
    """Run the stack.  caches (if given) holds one dict a layer.

    Returns (x, new_caches, total aux loss: the MoE layers' f32 sum in layer
    order, as the reference sums every layer's, the others adding zero)."""
    new_caches = [] if caches is not None else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for j, layer in enumerate(layers):
        x, nc, a = layer(x, positions, caches[j] if caches is not None else None, ctx_embeds,
                         causal)
        if a is not None:
            aux = aux + a
        if new_caches is not None:
            new_caches.append(nc)
    return x, new_caches, aux
