"""musicgen-medium  [audio]  (arXiv:2306.05284).

48L d_model=1536 24H (MHA: kv=24) d_ff=6144, vocab=2048 EnCodec codes with 4
codebooks (delay pattern).  The EnCodec frontend is a STUB per the assignment:
``input_specs()`` provides precomputed frame embeddings (B, S, d_model); the
backbone predicts 4 parallel codebook logits heads of 2048 entries each.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    frontend="audio_frames",
    n_codebooks=4,
    # small per-device batch at prefill_32k -> big q tiles are free VMEM-wise
    # and cut the flash KV re-stream 4x vs the 512 baseline (Perf iter 2)
    attn_block_q=2048,
    attn_block_kv=2048,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="musicgen-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab_size=64, n_codebooks=2, dtype="float32",
    )
