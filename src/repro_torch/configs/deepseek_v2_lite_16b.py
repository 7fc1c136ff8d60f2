"""DeepSeek-V2-Lite 16B — MLA (kv_lora=512) + fine-grained MoE
[arXiv:2405.04434].

Assignment line reads "MoE 64e top-6, 2 shared + 160 routed"; 160 routed
belongs to full V2 — we implement the published V2-Lite MoE: 64 routed +
2 shared experts, top-6, expert d_ff 1408.  The published
model's first layer uses a dense FFN; we keep the stack periodic (all-MoE)
for scan homogeneity.
"""
from repro_torch.configs.base import LayerSpec, MLAConfig, ModelConfig, MoEConfig, register

CONFIG = register(
    ModelConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=10944,
        vocab_size=102400,
        moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2),
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, qk_nope_head_dim=128,
                      qk_rope_head_dim=64, v_head_dim=128),
        layer_pattern=(LayerSpec(kind="attn", ffn="moe"),),
        grad_accum=4,
        moe_impl="a2a",
    ),
    smoke=ModelConfig(
        name="deepseek-v2-lite-16b-smoke",
        family="moe",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        moe=MoEConfig(capacity_factor=8.0, n_experts=8, top_k=2, d_ff_expert=32, n_shared=1),
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=0, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
        layer_pattern=(LayerSpec(kind="attn", ffn="moe"),),
    ),
)
