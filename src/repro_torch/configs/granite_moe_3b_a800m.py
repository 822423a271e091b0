"""granite-moe-3b-a800m  [moe]  (hf:ibm-granite granite-3.0 MoE family).

32L d_model=1536 24H (GQA kv=8) per-expert d_ff=512 vocab=49155, 40 experts
top-8.  (The assignment line mentions both "40e" and "32 experts"; we follow
the config field ``40e``, which matches the HF granite-3b-a800m card.)
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    n_experts=40,
    moe_top_k=8,
    moe_d_ff=512,
    rope_theta=10_000.0,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="granite-moe-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=32, moe_d_ff=32, vocab_size=128, n_experts=4,
        moe_top_k=2, dtype="float32",
    )
