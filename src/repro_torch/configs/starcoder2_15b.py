"""starcoder2-15b  [dense]  (arXiv:2402.19173).  40L d6144 48H GQA kv=4
d_ff=24576 vocab=49152, RoPE."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    rope_theta=100_000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="starcoder2-reduced", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=256, vocab_size=128, dtype="float32",
    )
