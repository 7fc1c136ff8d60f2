"""Qwen1.5-0.5B — dense with QKV bias, tied embeddings
[hf:Qwen/Qwen1.5-0.5B]."""
from repro_torch.configs.base import LayerSpec, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen1.5-0.5b",
        family="dense",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        head_dim=64,
        d_ff=2816,
        vocab_size=151936,
        qkv_bias=True,
        tie_embeddings=True,
        layer_pattern=(LayerSpec(),),
    ),
    smoke=ModelConfig(
        name="qwen1.5-0.5b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        qkv_bias=True,
        tie_embeddings=True,
        layer_pattern=(LayerSpec(),),
    ),
)
