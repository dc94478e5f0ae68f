"""CLIP model family (PyTorch)."""

from summer_clip_torch.models.clip.configs import (  # noqa: F401
    CLIPConfig, CLIP_CONFIGS, available_models,
)
from summer_clip_torch.models.clip.modeling import (  # noqa: F401
    CLIP, VisionTransformer, TextTransformer, Transformer, ResidualAttentionBlock,
    LayerNormF32, Bottleneck, AttentionPool2d, ModifiedResNet, build_clip,
)
from summer_clip_torch.models.clip.convert import (  # noqa: F401
    from_flax_variables, to_openai_state_dict, detect_model_name, load_clip,
)
