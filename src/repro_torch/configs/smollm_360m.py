"""smollm-360m  [dense]  (hf:HuggingFaceTB/SmolLM family, llama-arch small).
32L d960 15H GQA kv=5 d_ff=2560 vocab=49152."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="smollm-reduced", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=128, dtype="float32",
    )
