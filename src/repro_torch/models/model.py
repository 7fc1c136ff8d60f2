"""Top-level model API: init / train-forward / prefill / decode / caches.

Counterpart of ``repro.models.model``: the same four entry points, params
first, with a ``Model`` (an ``nn.Module`` holding the parameters: bf16,
f32 where the reference keeps f32) in place of the reference's pytree.
Modality frontends are stubs, as in the reference: VLM image patches and
audio frames arrive as precomputed embeddings in the batch.  ``forward_train`` is the forward pass only (the
port has no trainer yet, ROADMAP A.13c).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models.layers import Params, apply_norm, embed_tokens, lm_logits, norm_shapes
from repro_torch.models.ssm import _dims as ssm_dims
from repro_torch.models.transformer import SELF_CACHE, init_stack, stack_forward
from repro_torch.utils.interop import host_tensor

ENC_PATTERN = (LayerSpec(kind="attn", ffn="dense"),)
CACHE_SEQ = SELF_CACHE  # cache entries with a sequence axis (the rest: context, state)


def exact_gemms() -> None:
    """Full-precision products on the card, as the reference's dots: no
    TF32 for f32 operands, f32 reductions for bf16 ones."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


class Model(Params):
    """The parameters of one architecture: ``embed`` (vocab_padded, d),
    ``lm_head`` (d, vocab_padded) unless tied, ``final_norm``, ``layers``
    (``transformer.init_stack``) and, for whisper, ``encoder`` (its own
    ``layers`` and ``final_norm``).  Built uninitialised on ``device`` (the
    meta device holds shapes only); ``init_params`` draws them,
    ``utils.interop.lm_params_from_numpy`` loads the reference's."""

    def __init__(self, cfg: ModelConfig, *, device="cuda"):
        spec = {"embed": ((cfg.vocab_padded, cfg.d_model), 0.02),
                "final_norm": norm_shapes(cfg, cfg.d_model)}
        if not cfg.tie_embeddings:
            spec["lm_head"] = ((cfg.d_model, cfg.vocab_padded), 0.02)
        if cfg.encoder is not None:
            spec["encoder"] = {"final_norm": norm_shapes(cfg, cfg.d_model)}
        super().__init__(spec, device)
        self.cfg = cfg
        self.layers = init_stack(cfg, device=device)
        if cfg.encoder is not None:
            self.encoder.layers = init_stack(cfg, ENC_PATTERN, cfg.encoder.n_layers,
                                             device=device)
        if torch.device(device).type == "cuda":
            exact_gemms()

    @property
    def device(self) -> torch.device:
        return self.embed.device


# -------------------------------------------------------------------- init
def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> Model:
    """A ``Model`` on ``device`` drawn from a ``torch.Generator`` of its own
    on ``device``, seeded with ``seed``, at the reference's scales:
    embeddings and head normal × 0.02, projections normal × fan_in^-0.5,
    norms ones, biases and gates zeros.  The values cannot match
    ``jax.random``'s; tests load the reference's weights instead."""
    model = Model(cfg, device=device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    for m in model.modules():
        if isinstance(m, Params):
            m.draw_(gen)
    return model


# ----------------------------------------------------------------- forward
def _input(params: Model, x) -> torch.Tensor:
    """A batch entry on the model's device (numpy through ``host_tensor``,
    bf16 by its bits)."""
    t = x if isinstance(x, torch.Tensor) else host_tensor(x)
    return t.to(params.device)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def _encode(cfg: ModelConfig, params: Model, frames: torch.Tensor) -> torch.Tensor:
    """Whisper encoder over stub frame embeddings (B, n_frames, D)."""
    b, s, _ = frames.shape
    x, _, _ = stack_forward(frames, params.encoder.layers, cfg,
                            _positions(b, s, frames.device), causal=False)
    return apply_norm(x, params.encoder.final_norm, cfg)


def _context(cfg, params, batch: dict) -> torch.Tensor | None:
    if cfg.encoder is not None:
        return _encode(cfg, params, _input(params, batch["frames"]))
    if cfg.family == "vlm":
        return _input(params, batch["image_embeds"])
    return None


def forward_train(cfg: ModelConfig, params: Model,
                  batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """batch: tokens (B,S) [+ image_embeds | frames].  Returns (logits f32
    (B, S, vocab_padded), aux loss: the MoE layers' load-balance loss, f32,
    zero without MoE layers)."""
    tokens = _input(params, batch["tokens"])
    b, s = tokens.shape
    ctx = _context(cfg, params, batch)
    x = embed_tokens(params.embed, tokens, cfg)
    x, _, aux = stack_forward(x, params.layers, cfg, _positions(b, s, x.device),
                              ctx_embeds=ctx)
    return lm_logits(x, params, cfg), aux


# ------------------------------------------------------------------ caches
def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
               *, device="cuda") -> list[dict]:
    """One dict a layer, in layer order: "k" / "v" (B, max_seq, Hkv, hd) for
    self-attention, "c_kv" (B, max_seq, kv_lora_rank) / "k_pe" (B, max_seq,
    qk_rope_head_dim) for MLA, "ck" / "cv" (B, n_ctx, Hkv, hd) for
    cross-attention, and for an SSD block its decode state: "conv" (B,
    d_conv-1, conv_dim) of ``dtype`` and "ssm" (B, H, N, P) f32."""
    n_ctx = cfg.n_image_tokens or (cfg.encoder.n_frames if cfg.encoder else 0)
    hkv, hd = cfg.n_kv_heads, cfg.head_dim_

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    def one(spec: LayerSpec) -> dict:
        c: dict = {}
        if spec.kind == "mamba":
            s = cfg.ssm
            _, nh, conv_dim = ssm_dims(cfg)
            c["conv"] = zeros(batch, s.d_conv - 1, conv_dim)
            c["ssm"] = zeros(batch, nh, s.d_state, s.head_dim, dt=torch.float32)
            return c
        if spec.kind in ("attn", "attn_cross"):
            if cfg.mla is not None:
                c["c_kv"] = zeros(batch, max_seq, cfg.mla.kv_lora_rank)
                c["k_pe"] = zeros(batch, max_seq, cfg.mla.qk_rope_head_dim)
            else:
                c["k"] = zeros(batch, max_seq, hkv, hd)
                c["v"] = zeros(batch, max_seq, hkv, hd)
        if spec.kind in ("cross_attn", "attn_cross"):
            c["ck"] = zeros(batch, n_ctx, hkv, hd)
            c["cv"] = zeros(batch, n_ctx, hkv, hd)
        return c

    pattern = cfg.layer_pattern
    return [one(pattern[j % len(pattern)]) for j in range(cfg.n_layers)]


# ------------------------------------------------------------------- serve
def prefill(cfg: ModelConfig, params: Model, batch: dict) -> tuple[torch.Tensor, list]:
    """Process the prompt, returning (last-position logits, filled caches).

    The returned caches have sequence capacity == prompt length; the engine
    extends them for generation (serve/lm.py).
    """
    tokens = _input(params, batch["tokens"])
    b, s = tokens.shape
    ctx = _context(cfg, params, batch)
    caches = init_cache(cfg, b, s, device=params.device)
    x = embed_tokens(params.embed, tokens, cfg)
    x, new_caches, _ = stack_forward(x, params.layers, cfg, _positions(b, s, x.device),
                                     caches=caches, ctx_embeds=ctx)
    logits = lm_logits(x[:, -1:], params, cfg)
    return logits[:, 0], new_caches


def decode_step(cfg: ModelConfig, params: Model, token: torch.Tensor, pos,
                caches: list) -> tuple[torch.Tensor, list]:
    """One lockstep decode step.  token (B,), pos the current write position
    (an int or a 0-d tensor; all sequences advance together).  Writes each
    layer's cache row ``pos`` (an SSD block: its state) in place; returns
    (logits (B, V), caches)."""
    token = _input(params, token)
    b = token.shape[0]
    x = embed_tokens(params.embed, token[:, None], cfg)
    positions = torch.full((b, 1), int(pos), dtype=torch.int32, device=x.device)
    x, new_caches, _ = stack_forward(x, params.layers, cfg, positions, caches=caches)
    logits = lm_logits(x, params, cfg)
    return logits[:, 0], new_caches


# ------------------------------------------------------------------ counts
def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Total (or per-token active) parameter count, from a ``Model`` on the
    meta device.

    ``active_only`` scales routed-expert tensors by top_k / n_experts (the
    MoE 6·N_active·D convention) as the reference's ``count_params`` does:
    in a config with MoE, every FFN leaf named w1 / w2 / w3 / router of two
    or more axes a layer (three stacked over the periods), the dense FFNs'
    of a hybrid included, each pattern slot's leaf scaled over all its
    periods at once and truncated to an int."""
    model = Model(cfg, device="meta")
    total = sum(p.numel() for p in model.parameters())
    if not (active_only and cfg.moe is not None):
        return total
    period = len(cfg.layer_pattern)
    for layer in model.layers[:period]:
        ffn = getattr(layer, "ffn", None)
        for name, p in (ffn.named_parameters() if ffn is not None else ()):
            if name in ("w1", "w2", "w3", "router") and p.dim() >= 2:
                n = p.numel() * cfg.n_periods
                total += int(n * cfg.moe.top_k / cfg.moe.n_experts) - n
    return total


def matmul_param_count(cfg: ModelConfig, active_only: bool = True) -> int:
    """Params participating in per-token matmuls (MODEL_FLOPS = 6·N·tokens):
    excludes the embedding gather, includes the LM head (tied or not)."""
    n = count_params(cfg, active_only=active_only)
    emb = cfg.vocab_padded * cfg.d_model
    if cfg.tie_embeddings:
        return n  # the single table *is* the head matmul
    return n - emb


def flops_param_groups(cfg: ModelConfig, active_only: bool = True) -> dict:
    """Split matmul params by the token stream they act on (roofline):

      body — decoder stack params × decoder tokens
      enc  — encoder layers' params × encoder frames (whisper)
      head — lm-head matmul (d_model × padded vocab) × positions where
             logits are actually computed (all for train, last for prefill,
             one for decode)
    """
    total = matmul_param_count(cfg, active_only=active_only)
    n_head = cfg.d_model * cfg.vocab_padded
    n_enc = 0
    if cfg.encoder is not None:
        enc = Model(cfg, device="meta").encoder.layers
        n_enc = sum(p.numel() for p in enc.parameters())
    return {"body": total - n_head - n_enc, "enc": n_enc, "head": n_head}


def model_flops(cfg: ModelConfig, *, kind: str, global_batch: int,
                seq_len: int) -> float:
    """Useful-FLOPs for a step: 6·N·D (train) / 2·N·D (inference), with the
    head counted only where logits are computed and encoder params counted
    on encoder frames."""
    g = flops_param_groups(cfg, active_only=True)
    mult = 6.0 if kind == "train" else 2.0
    toks_body = global_batch * (seq_len if kind != "decode" else 1)
    # The encoder runs at train/prefill only (decode reuses cross caches).
    toks_enc = (
        global_batch * cfg.encoder.n_frames
        if cfg.encoder and kind != "decode"
        else 0
    )
    toks_head = global_batch * (seq_len if kind == "train" else 1)
    return mult * (g["body"] * toks_body + g["enc"] * toks_enc
                   + g["head"] * toks_head)
