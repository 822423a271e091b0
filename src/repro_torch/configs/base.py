"""Configuration system.

Every assigned architecture is described by a single frozen ``ModelConfig``.
The config is pure data: model modules read it, the sharding rules engine reads
it, and the dry-run enumerates (config x shape) cells from it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Input shapes (assigned shape set for the LM family)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


TRAIN_4K = InputShape("train_4k", seq_len=4_096, global_batch=256, kind="train")
PREFILL_32K = InputShape("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill")
DECODE_32K = InputShape("decode_32k", seq_len=32_768, global_batch=128, kind="decode")
LONG_500K = InputShape("long_500k", seq_len=524_288, global_batch=1, kind="decode")

ALL_SHAPES: Tuple[InputShape, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | audio | vlm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    # attention
    head_dim: int = 0             # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    attn_logit_softcap: float = 0.0
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0             # per-expert hidden size (0 -> d_ff)
    moe_capacity_factor: float = 1.25
    first_dense_layers: int = 0   # leading layers that use a dense FFN

    # MLA (DeepSeek multi-head latent attention)
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # SSM / recurrent (xLSTM, mamba-in-hymba)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    slstm_positions: Tuple[int, ...] = ()   # xLSTM: layer ids that are sLSTM
    # hybrid (hymba)
    hybrid: bool = False
    global_attn_positions: Tuple[int, ...] = ()  # hymba: full-attn layers
    sliding_window: int = 0                      # hymba: SWA for other layers

    # modality frontends (audio / vlm) -- frontend is a STUB; input_specs()
    # provides precomputed frame/patch embeddings.
    frontend: str = "none"        # none | audio_frames | vision_patches
    n_frontend_tokens: int = 0    # patches/frames prepended to the sequence
    n_codebooks: int = 0          # musicgen: parallel codebook heads

    # numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5

    # implementation switches (beyond-paper perf knobs; see EXPERIMENTS.md)
    attn_impl: str = "xla"        # xla | pallas (pallas used on real TPU)
    # flash tiles: KV re-stream traffic is ceil(S/block_q) * KV bytes, so
    # bigger q tiles cut HBM traffic linearly (§Perf iteration 2)
    attn_block_q: int = 1024      # flash-attention Q tile (XLA path)
    attn_block_kv: int = 1024     # flash-attention KV tile
    remat: bool = True
    remat_policy: str = "none"    # none (save block boundaries only) | dots
    loss_chunk: int = 512         # chunked cross-entropy sequence tile
    scan_layers: bool = True

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_experts and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    # -- derived quantities ------------------------------------------------
    @property
    def q_head_dim(self) -> int:
        if self.use_mla:
            return self.qk_nope_head_dim + self.qk_rope_head_dim
        return self.head_dim

    def sub_quadratic(self) -> bool:
        """True if the arch supports 500k-token decode (assignment rule)."""
        return self.family in ("ssm", "hybrid")

    def shapes(self) -> Tuple[InputShape, ...]:
        out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
        if self.sub_quadratic():
            out.append(LONG_500K)
        return tuple(out)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Parameter counting (used by roofline MODEL_FLOPS = 6*N*D and energy model)
# ---------------------------------------------------------------------------

def _attn_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    if cfg.use_mla:
        q = d * cfg.n_heads * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
        dkv = d * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
        uk = cfg.kv_lora_rank * cfg.n_heads * cfg.qk_nope_head_dim
        uv = cfg.kv_lora_rank * cfg.n_heads * cfg.v_head_dim
        o = cfg.n_heads * cfg.v_head_dim * d
        return q + dkv + uk + uv + o
    hd = cfg.head_dim
    qkv = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
    o = cfg.n_heads * hd * d
    return qkv + o


def _ffn_params_per_layer(cfg: ModelConfig, layer: int) -> int:
    d = cfg.d_model
    if cfg.n_experts and layer >= cfg.first_dense_layers:
        per_expert = 3 * d * cfg.moe_d_ff
        router = d * cfg.n_experts
        shared = cfg.n_shared_experts * per_expert
        return cfg.n_experts * per_expert + router + shared
    return 3 * d * cfg.d_ff if cfg.d_ff else 0


def _ssm_params(cfg: ModelConfig) -> int:
    """mLSTM/mamba-style block params (projections dominate)."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    # in-proj (x,z), conv, qkv/gates, out-proj -- close-form approximation used
    # only for MODEL_FLOPS accounting; exact counts come from the param tree.
    return 2 * d * di + di * cfg.ssm_conv + 3 * di * (di // max(cfg.n_heads, 1)) + di * d


def count_params(cfg: ModelConfig) -> int:
    """Analytic total parameter count (exact counts via models.param_count)."""
    total = cfg.vocab_size * cfg.d_model  # embedding
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * cfg.d_model
    for layer in range(cfg.n_layers):
        if cfg.family == "ssm":
            if layer in cfg.slstm_positions:
                total += 4 * cfg.d_model * cfg.d_model + 3 * cfg.d_model * int(cfg.d_model * 4 / 3)
            else:
                total += _ssm_params(cfg)
        elif cfg.hybrid:
            total += _attn_params(cfg) + _ssm_params(cfg) + _ffn_params_per_layer(cfg, layer)
        else:
            total += _attn_params(cfg) + _ffn_params_per_layer(cfg, layer)
        total += 2 * cfg.d_model  # norms
    return total


def count_active_params(cfg: ModelConfig) -> int:
    """Active params per token (MoE: only top-k + shared experts count)."""
    if not cfg.n_experts:
        return count_params(cfg)
    total = count_params(cfg)
    d = cfg.d_model
    per_expert = 3 * d * cfg.moe_d_ff
    moe_layers = cfg.n_layers - cfg.first_dense_layers
    inactive = moe_layers * (cfg.n_experts - cfg.moe_top_k) * per_expert
    return total - inactive
