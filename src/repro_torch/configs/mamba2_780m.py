"""Mamba-2 780M — attention-free SSD (state-space duality)
[arXiv:2405.21060].

d_inner = 2*1536 = 3072, head_dim 64 → 48 SSD heads, d_state 128.
Runs long_500k (constant-size decode state).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, SSMConfig, register

CONFIG = register(
    ModelConfig(
        name="mamba2-780m",
        family="ssm",
        n_layers=48,
        d_model=1536,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64),
        layer_pattern=(LayerSpec(kind="mamba", ffn="none"),),
    ),
    smoke=ModelConfig(
        name="mamba2-780m-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=512,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk_size=16),
        layer_pattern=(LayerSpec(kind="mamba", ffn="none"),),
    ),
)
