"""LM serving: batched prefill + lockstep decode for the language-model stack.

Counterpart of ``repro.serve.lm``'s ``Engine``.  The reference's
``make_serve_fns`` and ``cache_pspecs`` build mesh sharding specs; they
come with ``utils/sharding.py`` (ROADMAP A.13c).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import CACHE_SEQ, Model, decode_step, exact_gemms, prefill


class Engine:
    """Host-side generation loop (single process) on the model's device.

    ``generate`` runs the prefill, extends every self-attention cache (k /
    v, MLA's c_kv / k_pe) by ``max_new_tokens`` zero rows, leaving an SSD
    block's conv / ssm state as it is, then decodes in lockstep: greedy
    (``temperature <= 0``) or sampled at ``temperature`` from the engine's
    own generator, seeded with ``seed``, over the real classes only (the
    padded vocabulary rows are never chosen)."""

    def __init__(self, cfg: ModelConfig, params: Model, *, max_seq: int = 256,
                 temperature: float = 0.0, seed: int = 0):
        self.cfg, self.params = cfg, params
        self.max_seq = max_seq
        self.temperature = temperature
        self.generator = torch.Generator(device=params.device).manual_seed(seed)
        if params.device.type == "cuda":
            exact_gemms()

    def _extend_caches(self, caches: list, extra: int) -> list:
        return [{name: torch.cat([t, t.new_zeros((t.shape[0], extra, *t.shape[2:]))], dim=1)
                 if name in CACHE_SEQ else t for name, t in c.items()} for c in caches]

    @torch.inference_mode()
    def generate(self, batch: dict, *, max_new_tokens: int = 32) -> np.ndarray:
        """batch: tokens (B, S) [+ image_embeds | frames] → (B,
        max_new_tokens) int32 ids."""
        b, s = batch["tokens"].shape
        logits, caches = prefill(self.cfg, self.params, batch)
        caches = self._extend_caches(caches, max_new_tokens)
        out = []
        tok = self._sample(logits)
        out.append(tok)
        for i in range(max_new_tokens - 1):
            logits, caches = decode_step(self.cfg, self.params, tok, s + i, caches)
            tok = self._sample(logits)
            out.append(tok)
        return torch.stack(out, dim=1).cpu().numpy()

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        logits = logits[..., : self.cfg.vocab_size]  # mask padded classes
        if self.temperature <= 0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        # Gumbel-max, as jax.random.categorical.
        u = torch.rand(logits.shape, generator=self.generator, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
        return torch.argmax(logits / self.temperature + gumbel, dim=-1).to(torch.int32)
