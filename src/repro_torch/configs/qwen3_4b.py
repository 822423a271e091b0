"""qwen3-4b  [dense]  (hf:Qwen/Qwen3 family).  36L d2560 32H GQA kv=8
d_ff=9728 vocab=151936, qk_norm, head_dim=128."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=9728,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="qwen3-4b-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=128, head_dim=16, dtype="float32",
    )
