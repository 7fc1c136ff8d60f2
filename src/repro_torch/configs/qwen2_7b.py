"""Qwen2-7B — dense GQA (28 heads, kv=4) with QKV bias [arXiv:2407.10671]."""
from repro_torch.configs.base import LayerSpec, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen2-7b",
        family="dense",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab_size=152064,
        qkv_bias=True,
        layer_pattern=(LayerSpec(),),
        grad_accum=2,
    ),
    smoke=ModelConfig(
        name="qwen2-7b-smoke",
        family="dense",
        n_layers=2,
        d_model=56,
        n_heads=7,
        n_kv_heads=1,
        head_dim=8,
        d_ff=128,
        vocab_size=512,
        qkv_bias=True,
        layer_pattern=(LayerSpec(),),
    ),
)
