"""hymba-1.5b  [hybrid]  (arXiv:2411.13676).

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Each block runs attention heads and mamba (selective-SSM) heads in PARALLEL on
the same input; the two paths are normalized and fused with a learned
per-channel gate (Hymba Fig. 2).  Layers {0, 15, 31} use global attention,
all others sliding-window (1024) -- sub-quadratic, so ``long_500k`` runs.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    hybrid=True,
    ssm_state=16,
    ssm_expand=2,
    global_attn_positions=(0, 15, 31),
    sliding_window=1024,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="hymba-reduced", n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=128, global_attn_positions=(0, 2),
        sliding_window=16, ssm_state=4, dtype="float32",
    )
