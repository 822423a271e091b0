"""internvl2-26b  [vlm]  (arXiv:2404.16821).

InternLM2-20B language backbone: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553.  The InternViT-6B vision tower is a STUB per the assignment:
``input_specs()`` provides precomputed patch embeddings (B, n_patches,
d_model) that are prepended to the token embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    frontend="vision_patches",
    n_frontend_tokens=256,   # one image tile = 256 visual tokens
    rope_theta=1_000_000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="internvl2-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=128, n_frontend_tokens=8,
        dtype="float32",
    )
