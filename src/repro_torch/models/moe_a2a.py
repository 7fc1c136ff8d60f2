"""Expert-parallel MoE with an explicit all-to-all dispatch: its one-card
path.

Counterpart of ``repro.models.moe_a2a``.  The reference's ``moe_ffn_a2a``
exchanges each chip's assignments with the expert owners over the mesh's
model axis, and falls back to the dense formulation (``models.moe``) when
no mesh axis context is installed (``moe_a2a.py:41-43``).  The port has no
axis context yet: the exchange over ``torch.distributed`` needs
``utils/sharding.py``'s axis context and comes with training and sharding
(ROADMAP A.13c).  Until then ``moe_ffn_a2a`` is always that fallback, the
path the full configs that set ``moe_impl="a2a"`` (deepseek-v2-lite,
kimi-k2, jamba) take on one card.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe


def moe_ffn_a2a(x: torch.Tensor, p, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Drop-in replacement for ``moe.moe_ffn``; with no mesh axis context
    (always, until ROADMAP A.13c) it is ``moe.moe_ffn``."""
    return moe.moe_ffn(x, p, cfg)
