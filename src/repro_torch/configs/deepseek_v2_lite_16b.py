"""deepseek-v2-lite-16b  [moe]  (arXiv:2405.04434).

27L d_model=2048 16H, MLA with kv_lora_rank=512 (rope head dim 64, nope 128,
v 128), per-expert d_ff=1408, vocab=102400, 64 routed experts top-6 + 2 shared.
The assignment's "(GQA kv=16)" is subsumed by MLA: the KV cache is the shared
rank-512 latent + rope key, not per-head KV.  Layer 0 uses a dense FFN
(DeepSeek-V2 convention).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,              # dense FFN width for the first dense layer
    vocab_size=102400,
    use_mla=True,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    n_experts=64,
    n_shared_experts=2,
    moe_top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    rope_theta=10_000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="deepseek-v2-lite-reduced", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=96, vocab_size=128, kv_lora_rank=32,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        n_experts=4, n_shared_experts=1, moe_top_k=2, moe_d_ff=32,
        first_dense_layers=1, dtype="float32",
    )
