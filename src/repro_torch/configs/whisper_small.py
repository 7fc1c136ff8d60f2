"""Whisper-small — encoder-decoder transformer backbone [arXiv:2212.04356].

The conv frontend is a STUB: input_specs() provides precomputed frame
embeddings (B, 1500, 768) standing in for the two stride-2 conv1d layers.
Encoder: 12 bidirectional layers.  Decoder: 12 layers of self-attn +
cross-attn + FFN (kind="attn_cross").  LayerNorm + GELU per the paper;
positions realized with RoPE (an adaptation of the published model).
"""
from repro_torch.configs.base import EncoderConfig, LayerSpec, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="whisper-small",
        family="audio",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab_size=51865,
        norm_kind="layernorm",
        act="gelu",
        encoder=EncoderConfig(n_layers=12, n_frames=1500),
        layer_pattern=(LayerSpec(kind="attn_cross"),),
    ),
    smoke=ModelConfig(
        name="whisper-small-smoke",
        family="audio",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        norm_kind="layernorm",
        act="gelu",
        encoder=EncoderConfig(n_layers=2, n_frames=30),
        layer_pattern=(LayerSpec(kind="attn_cross"),),
    ),
)
