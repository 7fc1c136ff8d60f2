"""Qwen2-72B — dense GQA (kv=8) with QKV bias [arXiv:2407.10671]."""
from repro_torch.configs.base import LayerSpec, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen2-72b",
        family="dense",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab_size=152064,
        qkv_bias=True,
        layer_pattern=(LayerSpec(),),
        grad_accum=4,
    ),
    smoke=ModelConfig(
        name="qwen2-72b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        head_dim=8,
        d_ff=256,
        vocab_size=512,
        qkv_bias=True,
        layer_pattern=(LayerSpec(),),
    ),
)
