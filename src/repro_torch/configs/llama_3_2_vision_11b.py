"""Llama-3.2-Vision-11B backbone — cross-attention image-injection layers
every 5th layer [hf:meta-llama/Llama-3.2-11B-Vision; unverified tier].

Modality frontend is a STUB per the assignment: input_specs() provides
precomputed patch embeddings (B, 1601, d_model); the cross-attn layers
attend over them.  Period-5 pattern with cross-attn at offset 3 (8 cross
layers in 40, matching the published layout [3,8,...,38]).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, register

_pattern = tuple(
    LayerSpec(kind="cross_attn" if i == 3 else "attn") for i in range(5)
)

CONFIG = register(
    ModelConfig(
        name="llama-3.2-vision-11b",
        family="vlm",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=128256,
        n_image_tokens=1601,
        layer_pattern=_pattern,
        grad_accum=4,
    ),
    smoke=ModelConfig(
        name="llama-3.2-vision-11b-smoke",
        family="vlm",
        n_layers=5,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        n_image_tokens=17,
        layer_pattern=_pattern,
    ),
)
