"""Kimi K2 — trillion-parameter MoE with MLA [arXiv:2501.kimi2, paper-table;
unverified tier].

384 routed experts top-8 + 1 shared, expert d_ff 2048, MLA with q_lora 1536.
All-MoE periodic stack (the published first dense layer is folded into
the pattern).
"""
from repro_torch.configs.base import LayerSpec, MLAConfig, ModelConfig, MoEConfig, register

CONFIG = register(
    ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        d_ff=18432,
        vocab_size=163840,
        moe=MoEConfig(n_experts=384, top_k=8, d_ff_expert=2048, n_shared=1,
                      aux_loss_coef=0.0),  # K2 trains aux-loss-free
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, qk_nope_head_dim=128,
                      qk_rope_head_dim=64, v_head_dim=128),
        layer_pattern=(LayerSpec(kind="attn", ffn="moe"),),
        grad_accum=16,
        moe_impl="a2a",
    ),
    smoke=ModelConfig(
        name="kimi-k2-1t-a32b-smoke",
        family="moe",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        moe=MoEConfig(capacity_factor=8.0, n_experts=8, top_k=3, d_ff_expert=32, n_shared=1,
                      aux_loss_coef=0.0),
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
        layer_pattern=(LayerSpec(kind="attn", ffn="moe"),),
    ),
)
