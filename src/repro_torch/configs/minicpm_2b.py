"""MiniCPM 2B — dense llama-like with mup-style scaling and WSD schedule
[arXiv:2404.06395; hf].

36 heads; vocab 122753 padded to 122880.
emb_scale=12, residual scale 1.4/sqrt(L), logits divided by d_model/256 —
the published mup constants.
"""
import math

from repro_torch.configs.base import LayerSpec, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="minicpm-2b",
        family="dense",
        n_layers=40,
        d_model=2304,
        n_heads=36,
        n_kv_heads=36,
        head_dim=64,
        d_ff=5760,
        vocab_size=122753,
        tie_embeddings=True,
        emb_scale=12.0,
        residual_scale=1.4 / math.sqrt(40),
        logits_divisor=2304 / 256,
        layer_pattern=(LayerSpec(),),
    ),
    smoke=ModelConfig(
        name="minicpm-2b-smoke",
        family="dense",
        n_layers=2,
        d_model=72,   # 36-head-like non-power-of-two head count: 6 heads
        n_heads=6,
        n_kv_heads=6,
        head_dim=12,
        d_ff=144,
        vocab_size=512,
        tie_embeddings=True,
        emb_scale=12.0,
        residual_scale=1.4 / math.sqrt(2),
        logits_divisor=72 / 256,
        layer_pattern=(LayerSpec(),),
    ),
)
