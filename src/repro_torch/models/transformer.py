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
from repro_torch.models.layers import Params, dense_ffn, dense_ffn_shapes, scalar_like

NOT_PORTED = "is not ported yet (ROADMAP A.13b: MoE, MLA and SSM layers)"


def check_supported(cfg: ModelConfig, spec: LayerSpec) -> None:
    """Raise ``NotImplementedError`` for the layers the port lacks."""
    if spec.kind == "mamba":
        raise NotImplementedError(f"{cfg.name}: the mamba (SSD) layer {NOT_PORTED}")
    if spec.ffn == "moe":
        raise NotImplementedError(f"{cfg.name}: the MoE FFN {NOT_PORTED}")
    if cfg.mla is not None and spec.kind in ("attn", "attn_cross"):
        raise NotImplementedError(f"{cfg.name}: MLA attention {NOT_PORTED}")


class Layer(nn.Module):
    """One pattern layer: ``mixer`` (self- or gated cross-attention), for
    "attn_cross" a ``cross`` attention after it, and a dense ``ffn`` or
    none; each adds its delta to the residual, scaled by
    ``cfg.residual_scale`` in x's dtype."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, *, device="cuda"):
        super().__init__()
        check_supported(cfg, spec)
        self.cfg, self.spec = cfg, spec
        if spec.kind == "cross_attn":
            self.mixer = attn.init_attention(cfg, cross=True, device=device)
        else:  # attn | attn_cross
            self.mixer = attn.init_attention(cfg, device=device)
            if spec.kind == "attn_cross":
                self.cross = attn.init_attention(cfg, device=device)
        if spec.ffn == "dense":
            self.ffn = Params(dense_ffn_shapes(cfg, cfg.d_model, cfg.d_ff), device)

    def forward(
        self,
        x: torch.Tensor,
        positions: torch.Tensor,
        cache: dict | None = None,
        ctx_embeds: torch.Tensor | None = None,
        causal: bool = True,
    ) -> tuple[torch.Tensor, dict | None]:
        """Returns (x, new_cache)."""
        cfg, spec = self.cfg, self.spec
        rs = scalar_like(x, cfg.residual_scale) if cfg.residual_scale != 1.0 else None

        def add_resid(x, delta):
            return x + (delta * rs if rs is not None else delta)

        new_cache: dict = {}
        if spec.kind == "cross_attn":
            delta, cc = attn.cross_attention(x, self.mixer, cfg, ctx_embeds, cache, gated=True)
            if cc is not None:
                new_cache.update(cc)
            x = add_resid(x, delta)
        else:
            self_cache = (
                {k: v for k, v in cache.items() if k in ("k", "v")} if cache is not None else None
            )
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
        return x, (new_cache or None)


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
) -> tuple[torch.Tensor, list | None]:
    """Run the stack.  caches (if given) holds one dict a layer.

    Returns (x, new_caches)."""
    new_caches = [] if caches is not None else None
    for j, layer in enumerate(layers):
        x, nc = layer(x, positions, caches[j] if caches is not None else None, ctx_embeds,
                      causal)
        if new_caches is not None:
            new_caches.append(nc)
    return x, new_caches
