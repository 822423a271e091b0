"""Stage-structured decoder: ``repro/models/transformer.py`` for every LM
family the JAX package has: dense, MoE, recurrent (xLSTM), hybrid (Hymba),
audio (musicgen) and vision-language (InternVL).

Layers are grouped into runs of one block kind, and each run's parameters
are stacked along a leading layer axis, as the JAX package stacks them with
``jax.vmap``.  Its ``jax.lax.scan`` over a run becomes a Python loop over the
stacked weights here.  Runs are also the split boundaries of the paper's
technique on an LM (``core/splitting.py::LMSplitPlan``): ``forward_slice``
executes layers [lo, hi) of the same parameters, across runs.

Blocks (``LayerKind.block``): ``attn_ffn`` (GQA attention with optional
qk-norm, or MLA; a SwiGLU or capacity-routed MoE FFN: ``qwen3-1.7b``,
``qwen3-4b``, ``smollm-360m``, ``starcoder2-15b``, ``granite-moe-3b-a800m``,
``deepseek-v2-lite-16b``), ``mlstm`` and ``slstm`` (``xlstm-350m``,
``models/ssm.py``) and ``hymba`` (``hymba-1.5b``: GQA attention and mamba
heads in parallel on the same normed input, fused by learned per-channel
gates, then the FFN; a sliding window on every layer but
``global_attn_positions``).  The audio and vision families are the dense
block behind a stub frontend, as there: musicgen takes precomputed EnCodec
frame embeddings (B, S, d) in prefill, and in decode a frame or one token
of each of its ``n_codebooks`` codebooks (B, 1, ncb), whose embeddings are
summed; its ``n_codebooks`` heads give logits (B, S, ncb, V).  InternVL
prepends precomputed patch embeddings (B, n_frontend_tokens, d) to its
text tokens' embeddings.  ``attn_logit_softcap`` goes to B5 and B6.

What runs where: GQA prefill attention runs B5 (``ops.flash_attention``,
with the layer's window), GQA decode B6 (``ops.decode_attention_kv_major``);
on CPU tensors their plain versions.  MLA, the MoE FFN, the recurrent blocks
and everything else are plain PyTorch ops on the tensors' device.

Decode caches are one stacked tree per run: GQA's KV-major, (layers, B, KV,
max_len, hd), on a windowed layer a ring of (layers, B, KV, w, hd) whatever
max_len is; MLA's the latent (layers, B, max_len, r) and the rope key
(layers, B, max_len, dr); the recurrent states as ``models/ssm.py`` lays
them out (mLSTM conv and (C, n, m), sLSTM (h, c, n, m), mamba conv and
state).  A decode step writes its token's rows, and each layer's new
states, into them in place (the JAX package returns new caches).
``forward`` and ``forward_slice`` return the MoE load-balance term summed
over the layers in float32, as there.

Training (``loss_fn``): ``train_forward`` runs every layer with no cache,
each under ``torch.utils.checkpoint`` when ``cfg.remat`` is set (the JAX
package's ``jax.checkpoint`` of its scan body in train mode: only the
residual stream between layers is kept, and the backward recomputes each
layer, B5's forward included); ``lm_loss`` is the chunked cross-entropy over
``cfg.loss_chunk`` positions, each chunk's float32 logits recomputed in the
backward as there.  GQA attention then runs B5 through its autograd
function, whose backward is B5's backward kernel on the card.  MoE routing
is not recorded in training (a recompute would record it twice).

Tensor parallelism (inside ``collectives.model_parallel``): the layers
split as ``models/layers.py`` and ``models/ssm.py`` say; where the rules
split the vocabulary over the model group the embedding lookup is
vocab-parallel (each rank looks up the tokens in its range, zeros
elsewhere, then g; per codebook, so the sum keeps its order), the
unembedding gives the rank's vocab columns (gathered whole for the
prefill's logits), and the chunked cross-entropy reduces the maximum, the
sum of exponentials and the target logit over the group.

Sequence parallelism (the train step's default over a mesh,
``collectives.model_parallel(..., seq=True)``): the residual stream between
layers is the rank's chunk of the sequence.  ``embed_inputs`` gives that
chunk (a vocab-parallel lookup's partial rows reduce-scattered, any whole
stream cut), the blocks' norms, residual adds and Hymba's fuse run on it
(each replicated norm and gate through ``collectives.seq_weight``), each
layer gathers the sequence at its entry and gives its chunk back
(``layers.py``, ``ssm.py``), a remat checkpoint keeps only the chunk, and
the final norm runs on it before ``lm_loss`` gathers the sequence: the
vocab-parallel cross-entropy needs the same positions on every rank.
RoPE takes the whole sequence's positions.

Over a mesh (``cuts``: each stacked cache leaf's ``collectives.Cut``, from
``sharding.cache_cuts``) the caches are placed as
``sharding.cache_shardings`` places them: ``prefill`` returns each leaf's
chunk (the attention rows of every kv head, cut on the dim the rule picks;
the recurrent states on theirs) and ``decode_step`` takes and returns them
so.  The layers say how they compute on a chunk (``layers.attn_apply``,
``layers.mla_apply``, ``ssm``); the live-row tensors of a step are the
rank's own, its rows' share of the cache's live rows.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import collectives as C
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.tree import spec_map, tree_flatten, tree_map


# ---------------------------------------------------------------------------
# layer plan: one LayerKind per layer; runs = maximal uniform groups
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LayerKind:
    block: str = "attn_ffn"     # attn_ffn | mlstm | slstm | hymba
    attn: str = "gqa"           # gqa | mla | none
    ffn: str = "dense"          # dense | moe | none
    sliding_window: int = 0     # 0 = global attention


def layer_plan(cfg: ModelConfig) -> Tuple[LayerKind, ...]:
    plan = []
    for i in range(cfg.n_layers):
        if cfg.family == "ssm":
            plan.append(LayerKind(block="slstm" if i in cfg.slstm_positions
                                  else "mlstm", attn="none", ffn="none"))
        elif cfg.hybrid:
            sw = 0 if i in cfg.global_attn_positions else cfg.sliding_window
            plan.append(LayerKind(block="hymba", attn="gqa", ffn="dense",
                                  sliding_window=sw))
        else:
            ffn = ("moe" if (cfg.n_experts and i >= cfg.first_dense_layers)
                   else "dense")
            plan.append(LayerKind(attn="mla" if cfg.use_mla else "gqa",
                                  ffn=ffn))
    return tuple(plan)


def layer_runs(cfg: ModelConfig) -> List[Tuple[LayerKind, int]]:
    runs: List[Tuple[LayerKind, int]] = []
    for kind in layer_plan(cfg):
        if runs and runs[-1][0] == kind:
            runs[-1] = (kind, runs[-1][1] + 1)
        else:
            runs.append((kind, 1))
    return runs


# ---------------------------------------------------------------------------
# block init / apply / cache
# ---------------------------------------------------------------------------

def block_init(cfg: ModelConfig, kind: LayerKind,
               generator: torch.Generator) -> Dict[str, Any]:
    """One layer's weights in the JAX package's tree and dtypes, drawn from
    ``generator`` on its device."""
    if kind.block == "mlstm":
        return SSM.mlstm_block_init(cfg, generator)
    if kind.block == "slstm":
        return SSM.slstm_block_init(cfg, generator)
    dev = generator.device
    ones = torch.ones((cfg.d_model,), dtype=L.dtype_of(cfg), device=dev)
    p = {"ln1": ones, "ln2": ones.clone(),
         "attn": (L.mla_init(cfg, generator) if kind.attn == "mla"
                  else L.attn_init(cfg, generator)),
         "ffn": (L.moe_init(cfg, generator) if kind.ffn == "moe"
                 else L.mlp_init(cfg, generator))}
    if kind.block == "hymba":
        p["mamba"] = SSM.mamba_init(cfg, generator)
        p["norm_attn"] = ones.clone()
        p["norm_ssm"] = ones.clone()
        p["beta_attn"] = torch.ones((cfg.d_model,), dtype=torch.float32,
                                    device=dev)
        p["beta_ssm"] = p["beta_attn"].clone()
    return p


def block_spec(cfg: ModelConfig, kind: LayerKind) -> Dict[str, Any]:
    """The logical axes of ``block_init``'s leaves, in its tree."""
    if kind.block == "mlstm":
        return SSM.mlstm_block_spec(cfg)
    if kind.block == "slstm":
        return SSM.slstm_block_spec(cfg)
    p: Dict[str, Any] = {
        "ln1": ("embed",), "ln2": ("embed",),
        "attn": L.mla_spec(cfg) if kind.attn == "mla" else L.attn_spec(cfg),
        "ffn": L.moe_spec(cfg) if kind.ffn == "moe" else L.mlp_spec(cfg)}
    if kind.block == "hymba":
        p["mamba"] = SSM.mamba_spec(cfg)
        for name in ("norm_attn", "norm_ssm", "beta_attn", "beta_ssm"):
            p[name] = ("embed",)
    return p


def block_apply(cfg: ModelConfig, kind: LayerKind, p, x: torch.Tensor,
                positions: torch.Tensor, *, cache=None,
                cache_index: Optional[int] = None,
                kv_len: Optional[torch.Tensor] = None,
                kv_rows: Optional[int] = None, cuts=None):
    """One layer.  ``attn_ffn``: pre-norm attention and FFN with residuals;
    ``hymba``: attention (windowed or global, ``kind.sliding_window``) and
    mamba on the same normed input, each output rms-normed, weighted by
    beta and averaged in float32, then the FFN; ``mlstm``/``slstm``: the
    recurrent block.  ``kv_len`` (B,) int32: the live rows of this layer's
    attention cache in a decode step, ``kv_rows`` the same count on the
    host (every row's; for the kernel's cost count).  ``cuts``: the layer's
    cache cuts over a mesh (the layers compute on placed chunks).  Returns
    (x, new_cache, aux): aux is the MoE layer's load-balance term, None
    otherwise."""
    if kind.block == "mlstm":
        x, c = SSM.mlstm_block_apply(cfg, p, x, cache=cache, cuts=cuts)
        return x, c, None
    if kind.block == "slstm":
        x, c = SSM.slstm_block_apply(cfg, p, x, cache=cache, cuts=cuts)
        return x, c, None
    h = L.rms_norm(x, C.seq_weight(p["ln1"]), cfg.norm_eps)
    attn_cache = None if cache is None else cache["attn"]
    attn_cuts = None if cuts is None else cuts["attn"]
    if kind.attn == "mla":
        ay, new_attn = L.mla_apply(cfg, p["attn"], h, positions,
                                   cache=attn_cache, cache_index=cache_index,
                                   cuts=attn_cuts)
    else:
        ay, new_attn = L.attn_apply(cfg, p["attn"], h, positions,
                                    cache=attn_cache, cache_index=cache_index,
                                    kv_len=kv_len, kv_rows=kv_rows,
                                    sliding_window=kind.sliding_window,
                                    cuts=attn_cuts)
    new_cache: Dict[str, Any] = {"attn": new_attn}
    if kind.block == "hymba":
        my, new_cache["mamba"] = SSM.mamba_apply(
            cfg, p["mamba"], h, cache=None if cache is None else cache["mamba"],
            cuts=None if cuts is None else cuts["mamba"])
        w = {k: C.seq_weight(p[k]) for k in ("beta_attn", "norm_attn",
                                              "beta_ssm", "norm_ssm")}
        fused = 0.5 * (w["beta_attn"] * L.rms_norm(ay, w["norm_attn"],
                                                   cfg.norm_eps).float()
                       + w["beta_ssm"] * L.rms_norm(my, w["norm_ssm"],
                                                    cfg.norm_eps).float())
        x = x + fused.to(x.dtype)
    else:
        x = x + ay
    h2 = L.rms_norm(x, C.seq_weight(p["ln2"]), cfg.norm_eps)
    if kind.ffn == "moe":
        fy, aux = L.moe_apply(cfg, p["ffn"], h2)
    else:
        fy, aux = L.mlp_apply(p["ffn"], h2, cfg.d_ff), None
    return x + fy, new_cache, aux


def block_cache_init(cfg: ModelConfig, kind: LayerKind, B: int, max_len: int,
                     device) -> Dict[str, Any]:
    """One layer's decode cache, zeroed: MLA's latent (B, max_len, r) and
    rope key (B, max_len, dr); GQA's KV-major k and v (B, KV, max_len, hd),
    on a windowed layer the ring (B, KV, w, hd); the recurrent blocks'
    states (``models/ssm.py``), and on a hymba layer the mamba state beside
    the attention cache."""
    if kind.block == "mlstm":
        return SSM.mlstm_cache_init(cfg, B, device)
    if kind.block == "slstm":
        return SSM.slstm_state_init(cfg, B, device)
    if kind.attn == "mla":
        shapes = {"latent": (B, max_len, cfg.kv_lora_rank),
                  "k_rope": (B, max_len, cfg.qk_rope_head_dim)}
    else:
        shape = (B, cfg.n_kv_heads, kind.sliding_window or max_len,
                 cfg.head_dim)
        shapes = {"k": shape, "v": shape}
    c: Dict[str, Any] = {"attn": {
        name: torch.zeros(shape, dtype=L.dtype_of(cfg), device=device)
        for name, shape in shapes.items()}}
    if kind.block == "hymba":
        c["mamba"] = SSM.mamba_cache_init(cfg, B, device)
    return c


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def init(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    """Random weights in the JAX package's tree, scales and dtypes (the
    config's, the MoE router float32), drawn from ``generator`` on its
    device.  With ``n_codebooks`` the embedding is (ncb, V, d) at scale 0.02
    and the heads (ncb, d, V) at d^-1/2.  Each run's stacked weights are
    allocated once and filled layer by layer, so the peak is the model and
    one layer.  The draws are torch's, not ``jax.random``'s: a comparison
    with the JAX package bridges its weights (``bridge.lm_params_from_numpy``)
    instead."""
    device = resolve_device(device)
    dt = L.dtype_of(cfg)
    V, d, ncb = cfg.vocab_size, cfg.d_model, cfg.n_codebooks

    def cast(t):
        return t.to(device=device, dtype=dt)

    params: Dict[str, Any] = {}
    if ncb:
        params["embed"] = cast(L.init_dense(generator, (ncb, V, d), scale=0.02))
        params["lm_head"] = cast(L.init_dense(generator, (ncb, d, V),
                                              scale=1.0 / math.sqrt(d)))
    else:
        params["embed"] = cast(L.init_dense(generator, (V, d), scale=0.02))
        if not cfg.tie_embeddings:
            params["lm_head"] = cast(L.init_dense(generator, (d, V)))
    params["final_norm"] = torch.ones((cfg.d_model,), dtype=dt, device=device)
    runs = []
    for kind, count in layer_runs(cfg):
        stacked = None
        for i in range(count):
            layer = block_init(cfg, kind, generator)
            if stacked is None:
                stacked = tree_map(lambda a: a.new_empty(
                    (count,) + tuple(a.shape), device=device), layer)
            tree_map(lambda s, a: s[i].copy_(a), stacked, layer)
        runs.append(stacked)
    params["runs"] = runs
    return params


def spec(cfg: ModelConfig) -> Dict[str, Any]:
    """The logical axes of every leaf of ``init``'s tree (a tuple of names,
    one per dim), which ``launch/sharding.py`` maps onto a mesh: each run's
    stacked leaves lead with ``"layers"``."""
    sp: Dict[str, Any] = {}
    if cfg.n_codebooks:
        sp["embed"] = (None, "vocab", "embed")
        sp["lm_head"] = (None, "embed", "vocab")
    else:
        sp["embed"] = ("vocab", "embed")
        if not cfg.tie_embeddings:
            sp["lm_head"] = ("embed", "vocab")
    sp["final_norm"] = ("embed",)
    sp["runs"] = [spec_map(lambda s: ("layers",) + s, block_spec(cfg, kind))
                  for kind, _ in layer_runs(cfg)]
    return sp


def param_count(params) -> int:
    return sum(x.numel() for x in tree_flatten(params)[0])


def embed_inputs(cfg: ModelConfig, params, batch) -> torch.Tensor:
    """Raw inputs -> the (B, S, d) residual stream in the config's dtype:
    ``frames`` (B, S, d) as they are; token ids (B, S), or with codebooks
    (B, S, ncb) whose embeddings are summed in codebook order in the
    config's dtype; ``patches`` (B, P, d) prepended to the tokens'.  Where
    the sequence is cut, the rank's chunk of it (``_embed_chunk``)."""
    if C.seq_sharded():
        return _embed_chunk(cfg, params, batch)
    dt = L.dtype_of(cfg)
    if "frames" in batch:
        return batch["frames"].to(dt)
    tokens = batch["tokens"]
    if cfg.n_codebooks:
        h = _lookup(cfg, params["embed"][0], tokens[..., 0])
        for c in range(1, cfg.n_codebooks):
            h = h + _lookup(cfg, params["embed"][c], tokens[..., c])
    else:
        h = _lookup(cfg, params["embed"], tokens)
    if "patches" in batch:
        h = torch.cat([batch["patches"].to(dt), h.to(dt)], dim=1)
    return h.to(dt)


def _embed_chunk(cfg: ModelConfig, params, batch) -> torch.Tensor:
    """``embed_inputs`` where the sequence is cut over the model group: the
    rank's chunk of the stream.  On a vocab shard each lookup's partial
    rows (zeros for the tokens outside the rank's range, with the patches
    prepended on the first rank and zeros on the others) are summed and
    cut in one reduce-scatter (``C.scatter_seq``), a codebook at a time,
    the chunks summed in codebook order; a whole stream (frames, a
    replicated table's rows after the patches) is cut
    (``C.split_seq``)."""
    dt = L.dtype_of(cfg)
    if "frames" in batch:
        return C.split_seq(batch["frames"].to(dt))
    tokens = batch["tokens"]
    table = params["embed"]
    tp = _vocab_range(cfg, table.shape[-2])[1]
    patches = batch.get("patches")

    def chunk(tab, tok):
        h = _lookup(cfg, tab, tok, reduce=False)
        if patches is not None:
            pre = patches.to(dt)
            if tp and C.model_rank():
                pre = torch.zeros_like(pre)
            h = torch.cat([pre, h], dim=1)
        return C.scatter_seq(h) if tp else C.split_seq(h)

    if not cfg.n_codebooks:
        return chunk(table, tokens)
    h = chunk(table[0], tokens[..., 0])
    for c in range(1, cfg.n_codebooks):
        h = h + chunk(table[c], tokens[..., c])
    return h.to(dt)


def _vocab_range(cfg: ModelConfig, rows: int):
    """The first vocabulary id of this rank's rows of a (V, ...) table of
    ``rows`` rows, and whether the table is split over a model group."""
    tp = C.split(rows, cfg.vocab_size)
    return (C.model_rank() * rows if tp else 0), tp


def _lookup(cfg: ModelConfig, table: torch.Tensor,
            tokens: torch.Tensor, reduce: bool = True) -> torch.Tensor:
    """``table[tokens]``; on a vocab shard the rank's rows, zeros for the
    tokens outside its range, summed over the model group (g), or left so
    with ``reduce=False``."""
    v0, tp = _vocab_range(cfg, table.shape[0])
    if not tp:
        return table[tokens]
    local = tokens - v0
    mine = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)]
    rows = torch.where(mine[..., None], rows, rows.new_zeros(()))
    return C.reduce_from_model(rows) if reduce else rows


def _live_rows(kind: LayerKind, cuts, n: int):
    """(a key for the live-row tensor, the live rows) of a run's GQA cache
    in a step that makes ``n`` rows live: ``n`` (on a ring of w rows at
    most w), or on a chunk cut on its rows, their share of them."""
    w = kind.sliding_window
    live = min(n, w) if w else n
    cut = cuts["attn"]["k"] if cuts is not None and kind.attn == "gqa" else None
    if cut is None or cut.dim != 2:
        return (w, 0, 0), live
    return (w, cut.start, cut.size), min(max(live - cut.start, 0), cut.size)


def _run_layers(cfg: ModelConfig, params, h: torch.Tensor,
                positions: torch.Tensor, lo: int, hi: int, caches,
                cache_index: Optional[int], cuts=None):
    """Layers [lo, hi), across runs.  With ``caches`` (one stacked tree per
    run) each layer decodes into its slice in place (attention rows, and
    the new recurrent states copied over the old) and the new caches are
    views of them; without, the new caches stack the layers' (k, v),
    (latent, k_rope) or states.  A run outside [lo, hi) adds no cache.
    ``cuts`` (one tree per run): the caches are placed chunks (module
    docstring).  Returns (h, new_caches, the MoE layers' aux summed in
    float32)."""
    runs = layer_runs(cfg)
    new_caches = []
    live, made = {}, {}
    if caches is not None:
        # the live rows of an attention cache, one (B,) tensor per step and
        # window (and rank's rows): cache_index + S, or on a ring of w rows
        # at most w, or their share of a chunk's rows
        B, S = h.shape[:2]
        for ri, (kind, _) in enumerate(runs):
            key, rows = _live_rows(kind, None if cuts is None else cuts[ri],
                                   cache_index + S)
            if key not in made:
                made[key] = (torch.full((B,), rows, dtype=torch.int32,
                                        device=h.device), rows)
            live[ri] = made[key]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    start = 0
    for ri, (kind, count) in enumerate(runs):
        end = start + count
        s, e = max(lo, start), min(hi, end)
        if s < e:
            rp = params["runs"][ri]
            rc = None if caches is None else caches[ri]
            rcut = None if cuts is None else cuts[ri]
            kv_len, kv_rows = live.get(ri, (None, None))
            got = []
            for i in range(s - start, e - start):
                c_i = None if rc is None else tree_map(lambda a: a[i], rc)
                h, c, a = block_apply(cfg, kind, tree_map(lambda a: a[i], rp),
                                      h, positions, cache=c_i,
                                      cache_index=cache_index,
                                      kv_len=kv_len, kv_rows=kv_rows,
                                      cuts=rcut)
                if a is not None:
                    aux = aux + a
                if c_i is not None:
                    tree_map(_store, c_i, c)
                got.append(c)
            if rc is None:
                new_caches.append(tree_map(lambda *xs: torch.stack(xs), *got))
            else:
                new_caches.append(tree_map(
                    lambda a: a[s - start:e - start], rc))
        start = end
    return h, new_caches, aux


def _store(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Write a layer's new cache leaf into its slice of the stacked caches;
    the attention rows were written in place already (src is dst)."""
    if src is not dst:
        dst.copy_(src)


def forward(cfg: ModelConfig, params, h: torch.Tensor, positions: torch.Tensor,
            *, caches=None, cache_index: Optional[int] = None, cuts=None):
    """Every layer, then the final norm.  h: (B, S, d).  Returns (h,
    new_caches, aux)."""
    h, new_caches, aux = _run_layers(cfg, params, h, positions, 0,
                                     cfg.n_layers, caches, cache_index, cuts)
    return L.rms_norm(h, params["final_norm"], cfg.norm_eps), new_caches, aux


def forward_slice(cfg: ModelConfig, params, h: torch.Tensor,
                  positions: torch.Tensor, lo: int, hi: int, *, caches=None,
                  cache_index: Optional[int] = None):
    """Layers [lo, hi) only, no final norm: the split-inference partial
    forward on the published weights.  Returns (h, new_caches_for_slice,
    aux)."""
    return _run_layers(cfg, params, h, positions, lo, hi, caches, cache_index)


def _train_block(cfg: ModelConfig, kind: LayerKind, p, x: torch.Tensor,
                 positions: torch.Tensor):
    x, _, aux = block_apply(cfg, kind, p, x, positions)
    return x, aux


def train_forward(cfg: ModelConfig, params, h: torch.Tensor,
                  positions: torch.Tensor):
    """Every layer with no cache, then the final norm: the JAX package's
    ``forward(mode="train")``.  With ``cfg.remat`` each layer runs under
    ``checkpoint(use_reentrant=False)``, so the backward keeps only the
    residual stream between layers and recomputes the rest.  Each run's
    stacked weights are unbound once, so a layer's gradient lands in its
    slice of the stack with one stacking per run.  Returns (h, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for (kind, count), rp in zip(layer_runs(cfg), params["runs"]):
        leaves, treedef = tree_flatten(rp)
        layers = zip(*(leaf.unbind(0) for leaf in leaves))
        for p in map(treedef.unflatten, layers):
            if cfg.remat:
                h, a = checkpoint(_train_block, cfg, kind, p, h, positions,
                                  use_reentrant=False)
            else:
                h, a = _train_block(cfg, kind, p, h, positions)
            if a is not None:
                aux = aux + a
    return L.rms_norm(h, C.seq_weight(params["final_norm"]),
                      cfg.norm_eps), aux


def _chunk_loss(cfg: ModelConfig, params, h: torch.Tensor,
                labels: torch.Tensor, gathered: bool = False):
    """Summed cross-entropy of one chunk and its count of labels >= 0.  On
    a vocab shard the log-sum-exp takes the maximum and the sum of
    exponentials over the model group, and the target logit comes from the
    rank whose range holds it.  ``gathered``: h came through
    ``C.gather_seq`` (``local_logits``)."""
    logits = local_logits(cfg, params, h, gathered)   # (B, Lc, [ncb,] V) f32
    lab = labels.clamp_min(0).long()
    v0, tp = _vocab_range(cfg, logits.shape[-1])
    if tp:
        m = C.max_over_model(logits.detach().amax(dim=-1, keepdim=True))
        lse = m[..., 0] + torch.log(C.reduce_from_model(
            torch.exp(logits - m).sum(dim=-1)))
        lab = lab - v0
        mine = (lab >= 0) & (lab < logits.shape[-1])
        got = logits.gather(-1, lab.clamp(0, logits.shape[-1] - 1)[..., None])
        picked = C.reduce_from_model(torch.where(mine, got[..., 0],
                                                 got.new_zeros(())))
    else:
        lse = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(-1, lab[..., None])[..., 0]
    w = (labels >= 0).float()
    return ((lse - picked) * w).sum(), w.sum()


def lm_loss(cfg: ModelConfig, params, h: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of h (B, S, d) against labels (B, S), or (B, S,
    ncb) with codebooks, -1 ignored: over chunks of ``cfg.loss_chunk``
    positions (the last padded with ignored labels), each chunk's float32
    logits made under ``checkpoint`` and recomputed in the backward, so the
    (B, S, V) logits never exist at once.  The sum over the chunks in order
    divided by the count of labels, at least 1.  Where the sequence is cut,
    ``h`` is the rank's chunk and is gathered whole first (``C.gather_seq``
    where the vocabulary is split, its backward summing the ranks' partial
    gradients in f's place; else ``C.gather_seq_whole``)."""
    gathered = C.seq_sharded()
    if gathered:
        h = (C.gather_seq if _vocab_split(cfg, params)
             else C.gather_seq_whole)(h)
    S = h.shape[1]
    Lc = min(cfg.loss_chunk, S)
    pad = (-S) % Lc
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, 0) * (labels.dim() - 2) + (0, pad),
                       value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S + pad, Lc):
        s, n = checkpoint(_chunk_loss, cfg, params, h[:, c0:c0 + Lc],
                          labels[:, c0:c0 + Lc], gathered,
                          use_reentrant=False)
        tot, cnt = tot + s, cnt + n
    return tot / cnt.clamp_min(1.0)


def loss_fn(cfg: ModelConfig, params, batch) -> torch.Tensor:
    """The training loss of ``batch`` (``embed_inputs``'s inputs and
    ``labels``): ``lm_loss`` after ``train_forward``, plus 0.01 times the
    MoE load-balance term over the layers for a MoE config."""
    h = embed_inputs(cfg, params, batch)
    # the whole sequence's positions (h may be the rank's chunk of it)
    h, aux = train_forward(cfg, params, h, positions_for(batch["labels"]))
    loss = lm_loss(cfg, params, h, batch["labels"])
    if cfg.n_experts:
        loss = loss + 0.01 * aux / max(cfg.n_layers, 1)
    return loss


def _unembedding(cfg: ModelConfig, params) -> torch.Tensor:
    """The unembedding weight: (d, V), tied ``embed.T``; (ncb, d, V) with
    codebooks."""
    if cfg.n_codebooks or not cfg.tie_embeddings:
        return params["lm_head"]
    return params["embed"].T


def _vocab_split(cfg: ModelConfig, params) -> bool:
    """Whether the unembedding holds the rank's vocab columns only."""
    return C.split(_unembedding(cfg, params).shape[-1], cfg.vocab_size)


def local_logits(cfg: ModelConfig, params, h: torch.Tensor,
                 gathered: bool = False) -> torch.Tensor:
    """h: (B, S, d) -> float32 logits (B, S, V); tied: ``embed.T``; with
    codebooks (B, S, ncb, V), one head each.  On a vocab shard the rank's
    columns of them (h through f, unless it was ``gathered`` through
    ``C.gather_seq``, whose backward sums the gradients already)."""
    w = _unembedding(cfg, params)
    if _vocab_split(cfg, params) and not gathered:
        h = C.copy_to_model(h)
    if cfg.n_codebooks:
        return L.einsum32("bsd,cdv->bscv", h, w)
    return L.dense32(h, w)


def unembed(cfg: ModelConfig, params, h: torch.Tensor) -> torch.Tensor:
    """``local_logits``, gathered whole over the model group where the
    vocabulary is split."""
    logits = local_logits(cfg, params, h)
    if C.split(logits.shape[-1], cfg.vocab_size):
        logits = C.gather_from_model(logits, -1)
    return logits


def positions_for(h: torch.Tensor, start: int = 0) -> torch.Tensor:
    """(B, S) int32 positions start .. start + S - 1 for the stream h."""
    B, S = h.shape[:2]
    return (torch.arange(start, start + S, dtype=torch.int32, device=h.device)
            .expand(B, S))


# ---------------------------------------------------------------------------
# serving entry points (prefill / decode_step)
# ---------------------------------------------------------------------------

def cache_init(cfg: ModelConfig, B: int, max_len: int, device="cuda"):
    """Stacked decode caches, one tree per run."""
    device = resolve_device(device)
    caches = []
    for kind, count in layer_runs(cfg):
        single = block_cache_init(cfg, kind, B, max_len, device)
        caches.append(tree_map(
            lambda a: a.new_zeros((count,) + tuple(a.shape)), single))
    return caches


def prefill(cfg: ModelConfig, params, batch, max_len: int, cuts=None):
    """Process the prompt (tokens, frames, or patches and tokens) and build
    the decode caches.  Returns (last-position logits (B, 1, V), or
    (B, 1, ncb, V) with codebooks, float32, caches); with ``cuts`` (a mesh
    step's) each cache leaf as its placed chunk."""
    h = embed_inputs(cfg, params, batch)
    Sq = h.shape[1]
    if max_len < Sq:
        raise ValueError(f"max_len {max_len} is shorter than the prompt {Sq}")
    h, seq_caches, _ = forward(cfg, params, h, positions_for(h), cuts=cuts)
    out = [_merge_prefill_cache(kind, got, Sq, max_len,
                                None if cuts is None else cuts[ri])
           for ri, ((kind, _), got) in enumerate(zip(layer_runs(cfg),
                                                     seq_caches))]
    return unembed(cfg, params, h[:, -1:]), out


def _merge_prefill_cache(kind: LayerKind, got, Sq: int, max_len: int,
                         cuts=None):
    """The decode cache of a run, zeroed (as ``cache_init`` lays it out,
    in the heads the prompt's rows carry) with the prompt's rows written
    in: MLA's (layers, B, Sq, r) latent and (layers, B, Sq, dr) rope key as
    they lie into the first Sq of max_len rows; GQA's (layers, B, Sq, KV,
    hd) k and v turned KV-major into the first Sq rows, or on a ring of w
    rows with Sq >= w the last w rows rolled by Sq % w, so that position p
    sits in slot p % w.  Recurrent states are taken as they come.  With
    ``cuts`` each attention leaf's placed chunk of it (the stacked layer
    dim leads the leaf, so each cut's dim moves up by one): a leaf cut on
    its rows the layers made as that chunk already, and it is taken as it
    comes."""
    if kind.block in ("mlstm", "slstm"):
        return got
    w = kind.sliding_window
    dec: Dict[str, Any] = {"attn": {}}
    for name, rows in got["attn"].items():
        cut = None if cuts is None else cuts["attn"][name]
        if cut is not None and cut.dim == (1 if kind.attn == "mla" else 2):
            dec["attn"][name] = rows
            continue
        if kind.attn == "mla":
            n, B, _, r = rows.shape
            c = rows.new_zeros((n, B, max_len, r))
            c[:, :, :Sq] = rows
        else:
            n, B, _, KV, hd = rows.shape
            c = rows.new_zeros((n, B, KV, w or max_len, hd))
            if w and Sq >= w:
                c.copy_(torch.roll(rows[:, :, Sq - w:].transpose(2, 3),
                                   Sq % w, dims=3))
            else:
                c[:, :, :, :Sq] = rows.transpose(2, 3)
        if cut is not None:
            c = c.narrow(cut.dim + 1, cut.start, cut.size).clone()
        dec["attn"][name] = c
    if kind.block == "hymba":
        dec["mamba"] = got["mamba"]
    return dec


def decode_step(cfg: ModelConfig, params, caches, batch, cache_index: int,
                cuts=None):
    """One-token decode.  batch: tokens (B, 1), or (B, 1, ncb) with
    codebooks, or frames (B, 1, d); cache_index: the new token's position
    (a prompt's patches count).  Returns (logits (B, 1, V), or (B, 1, ncb,
    V), float32, caches updated in place); with ``cuts`` (a mesh step's)
    the caches are placed chunks."""
    cache_index = int(cache_index)
    h = embed_inputs(cfg, params, batch)
    h, caches, _ = forward(cfg, params, h, positions_for(h, cache_index),
                           caches=caches, cache_index=cache_index, cuts=cuts)
    return unembed(cfg, params, h), caches
