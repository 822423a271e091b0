"""xlstm-350m  [ssm]  (arXiv:2405.04517).

24L d_model=1024, mLSTM blocks (matrix memory, 4 heads) with sLSTM blocks at
layers {8, 16}.  d_ff=0: xLSTM blocks carry their own up-projection
(mLSTM expand=2; sLSTM has a 4/3-GLU FFN).  O(1) recurrent state ->
``long_500k`` runs (sub-quadratic by construction).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    ssm_state=0,        # mLSTM memory is (head_dim x head_dim) per head
    ssm_expand=2,
    slstm_positions=(8, 16),
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="xlstm-reduced", n_layers=3, d_model=64, n_heads=2, n_kv_heads=2,
        vocab_size=128, slstm_positions=(1,), dtype="float32",
    )
