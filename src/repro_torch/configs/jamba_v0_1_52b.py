"""Jamba v0.1 52B — hybrid Mamba+attention 1:7 interleave, MoE every 2nd
layer [arXiv:2403.19887].

Period-8 pattern: attention at offset 4 (1 of 8 layers), Mamba elsewhere;
MoE FFN on odd layers (16 experts, top-2), dense FFN on even layers.
Jamba's SSM layers are Mamba-1; this framework realizes them with the
Mamba-2/SSD block (a chunked scan).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig, SSMConfig, register

_pattern = tuple(
    LayerSpec(
        kind="attn" if i == 4 else "mamba",
        ffn="moe" if i % 2 == 1 else "dense",
    )
    for i in range(8)
)

CONFIG = register(
    ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=65536,
        moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336),
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64),
        layer_pattern=_pattern,
        grad_accum=8,
        moe_impl="a2a",
    ),
    smoke=ModelConfig(
        name="jamba-v0.1-52b-smoke",
        family="hybrid",
        n_layers=8,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        moe=MoEConfig(capacity_factor=8.0, n_experts=4, top_k=2, d_ff_expert=128),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk_size=16),
        layer_pattern=_pattern,
    ),
)
