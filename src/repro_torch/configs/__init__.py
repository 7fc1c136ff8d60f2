"""Architecture configs (one module per assigned architecture)."""
from repro_torch.configs.base import (
    LM_SHAPES,
    SHAPES,
    EncoderConfig,
    LayerSpec,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
    cells,
    get_config,
    get_smoke_config,
    list_archs,
)
