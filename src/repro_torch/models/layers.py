"""Shared layers (``repro/models/layers.py``): the Swin slice's and the LM's.

Conventions, as the JAX package's: activations flow in the model's dtype
(float32 for Swin-T, bf16 for the full-width LMs); norm statistics, RoPE
angles and softmax run in float32; every product accumulates in float32
(``preferred_element_type=jnp.float32`` there).  ``einsum32`` is the
counterpart: with ``out_dtype`` equal to the operands' dtype it runs that
dtype's GEMM, which accumulates in float32 (the package keeps bf16 reduced-
precision reductions off) and rounds once at the end; otherwise it runs on
float32 copies of the operands, and without ``out_dtype`` the result stays
float32.  Logits stay float32 (``dense32``).  The package's fp32 policy
keeps float32 products off TF32.  Weights are drawn in float32 and cast to
the config's dtype (``dtype_of``), as ``init_dense`` does there; the MoE
router stays float32.

GQA attention runs through the kernels: prefill through
``ops.flash_attention`` (B5), decode through
``ops.decode_attention_kv_major`` (B6) on the KV-major cache.  The JAX
package's ``plain_attention`` and its XLA blockwise path
(``models/attention_flash.py``), between which it switches at
``attn_block_q``, have no port for GQA: every GQA prefill takes B5, whose
CPU path is the dense masked softmax.

MLA (DeepSeek's latent attention) runs no kernel, as in the JAX package:
its prefill attention (q and k at head dim dn + dr against v at dv) is
``mla_prefill_attention``, the dense masked softmax of ``plain_attention``
in plain PyTorch ops, and its decode is the absorbed form against the
latent cache, einsums.  The MoE FFN (``moe_apply``) is capacity-routed
top-k with a cumsum-position dispatch, einsums and a scatter, as there.
A sliding window (Hymba's) goes to B5 as its argument in prefill; in
decode the windowed layer keeps the JAX package's ring buffer of w rows, and
B6 reads its live rows as they lie.  A logit soft-cap
(``attn_logit_softcap``) goes to B5 and B6 as their argument, on windowed
layers and rings too; MLA ignores it, as the JAX package's ``mla_apply``
does.

Tensor parallelism (inside ``collectives.model_parallel``, from the mesh
steps): a layer whose leaves the rules split over the ``model`` axis runs
on the rank's shard, Megatron-style, between ``C.copy_to_model`` (f) and
``C.reduce_from_model`` (g; a row-parallel product's partial sums in
float32, rounded once after the sum, ``reduced_dense``).  Attention takes the rank's q heads and the kv
heads they read (a replicated wk/wv sliced to them), MLA its heads over the
whole latent, the SwiGLU and each expert their hidden columns; the MoE
router stays whole, so every rank routes alike.  A replicated leaf that a
rank uses for its shard only (a sliced wk, qk-norm scales, MLA's ``w_dkv``)
goes through f, so its gradient is summed over the ranks.  Whether a leaf
is split is read from its shape against the config's width.

Sequence parallelism (the train step's default over a mesh): each layer
gets the residual stream as the rank's chunk of the sequence and gives its
output back so.  Its input comes whole through ``C.layer_in`` (the
all-gather of ``C.gather_seq`` in f's place where the layer splits, else
``C.gather_seq_whole``), attention takes RoPE at the gathered sequence's
positions, and its output goes back through ``C.layer_out`` (the
row-parallel partial sums reduce-scattered in float32 in g's place, else
the rank's chunk cut).  The MoE routes the gathered tokens: the router
runs on the rank's chunk (its weight through ``C.seq_weight``) and its
logits are gathered whole, so that capacity, drops and the load-balance
term see every token of the batch row alike on every rank.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.launch import collectives as C


NEG_INF = -1e30


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def einsum32(subs: str, *args: torch.Tensor,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``torch.einsum`` with products accumulated in float32 and the result
    rounded once to ``out_dtype``, float32 without it."""
    if out_dtype is not None and all(a.dtype == out_dtype for a in args):
        return torch.einsum(subs, *args)
    out = torch.einsum(subs, *(a.float() for a in args))
    return out if out_dtype is None else out.to(out_dtype)


def _half_gemm_f32_out(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether a product of ``a`` and ``b`` may take cuBLAS's half GEMM with
    a float32 output: on the card (or on the meta device, where a dry-run
    counts the card's path), half-precision operands of one dtype, and no
    gradient wanted.  ``mm``/``bmm`` with ``out_dtype`` have no derivative
    (their backward raises "derivative for aten::mm is not implemented"),
    so under autograd the operands are upcast instead: the same exact
    products and float32 sums."""
    return (a.device.type in ("cuda", "meta")
            and a.dtype == b.dtype != torch.float32
            and not (torch.is_grad_enabled()
                     and (a.requires_grad or b.requires_grad)))


def bmm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` with products accumulated in float32 and a float32
    result.  On the card, half-precision operands go through cuBLAS's half
    GEMM with a float32 output (no float32 copy of the expert weights);
    elsewhere, and where a gradient is wanted, the operands are upcast
    (``aten::bmm.dtype`` has no CPU kernel)."""
    if _half_gemm_f32_out(a, b):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def dense32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with products accumulated in float32 and a float32 result,
    as the JAX package's ``einsum32`` without ``out_dtype``.  On the card,
    half-precision operands go through cuBLAS's half GEMM with a float32
    output, so a large ``w`` (the tied unembedding) is never copied to
    float32; elsewhere, and where a gradient is wanted, the operands are
    upcast."""
    if _half_gemm_f32_out(x, w):
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())


def reduced_dense(x: torch.Tensor, w: torch.Tensor,
                  out_dtype: torch.dtype, mid: bool = False) -> torch.Tensor:
    """``x @ w`` where a model group splits the contraction (a row-parallel
    product): each rank's partial sums stay float32 through their sum over
    the group (a layer's exit, ``C.layer_out``: g, or the reduce-scatter of
    ``C.scatter_seq`` where the sequence is cut; with ``mid`` an all-reduce
    each way inside a layer, ``C.reduce_mid``) and round once to
    ``out_dtype``, as the one-process product rounds its whole sum."""
    y = dense32(x, w)
    return (C.reduce_mid(y) if mid else C.layer_out(y, True)).to(out_dtype)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Contract the last axis of ``x`` with the first of ``w``, accumulating
    in float32; the output in ``x``'s dtype."""
    if x.dtype == w.dtype:
        return torch.matmul(x, w)
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def init_dense(generator: torch.Generator, shape: Sequence[int],
               scale: Optional[float] = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Normal(0, scale^2) weights drawn in float32 and cast to ``dtype``,
    ``scale`` = fan_in^-1/2 by default, from ``generator`` on its device."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    if scale is None:
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    return (torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                        device=generator.device) * scale).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Biased variance and rsqrt, math in float32, as the JAX package."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (halves, not interleaved; angles in float32)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float,
                   device: torch.device) -> torch.Tensor:
    """``rope_freqs`` uploaded once per device: a host-to-device copy in
    every layer would stall the stream at each decode step."""
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) int."""
    freqs = _rope_freqs_on(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs             # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                     # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention layer and the dense (SwiGLU) FFN
# ---------------------------------------------------------------------------

def attn_init(cfg, generator: torch.Generator) -> dict:
    """Weights in the config's dtype, drawn from ``generator`` on its
    device."""
    dt = dtype_of(cfg)
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": init_dense(generator, (d, H, hd), dtype=dt),
        "wk": init_dense(generator, (d, KV, hd), dtype=dt),
        "wv": init_dense(generator, (d, KV, hd), dtype=dt),
        "wo": init_dense(generator, (H, hd, d), scale=1.0 / math.sqrt(H * hd),
                         dtype=dt),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dt, device=generator.device)
        p["k_norm"] = torch.ones((hd,), dtype=dt, device=generator.device)
    return p


def attn_spec(cfg) -> dict:
    """The logical axes of ``attn_init``'s leaves, for the sharding rules."""
    p = {"wq": ("embed", "heads", "head_dim"),
         "wk": ("embed", "kv_heads", "head_dim"),
         "wv": ("embed", "kv_heads", "head_dim"),
         "wo": ("heads", "head_dim", "embed")}
    if cfg.qk_norm:
        p["q_norm"] = ("head_dim",)
        p["k_norm"] = ("head_dim",)
    return p


def cache_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                    kv_len: torch.Tensor, *,
                    logit_softcap: float = 0.0,
                    kv_rows: Optional[int] = None) -> torch.Tensor:
    """Decode attention against a KV-major cache: q (B, 1, H, hd), ck and cv
    (B, KV, Sc, hd), kv_len (B,) int32, each scaled logit soft-capped at
    ``logit_softcap`` (0: none); ``kv_rows`` the live rows on the host, for
    B6's cost count.  Runs B6 on the cache as it lies."""
    if q.shape[1] != 1:
        raise ValueError(f"the cache path decodes one token a step; got "
                         f"{q.shape[1]}")
    return ops.decode_attention_kv_major(q, ck, cv, kv_len,
                                         logit_softcap=logit_softcap,
                                         kv_rows=kv_rows)


def attn_apply(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor, *,
               cache: Optional[dict] = None,
               cache_index: Optional[int] = None,
               kv_len: Optional[torch.Tensor] = None,
               kv_rows: Optional[int] = None,
               sliding_window: int = 0,
               cuts: Optional[dict] = None):
    """GQA attention with qk-norm before RoPE; with ``sliding_window`` w a
    query at position i sees keys i - w < j <= i; the config's
    ``attn_logit_softcap`` caps the scaled logits in prefill and decode.
    ``cache``: None (prefill, B5 with the window) or a dict of KV-major k
    and v (B, KV, S_cache, hd) that the new token is written into in place
    (the JAX package's ``dynamic_update_slice`` returns a new cache
    instead): at ``cache_index``, or on a windowed layer into the ring of
    S_cache = w rows at slot ``cache_index % w``, where a key carries RoPE
    at its absolute position.  ``kv_len`` (B,) int32 is then the cache's live
    rows, ``cache_index`` + S (on a ring at most w: softmax does not depend
    on the order of the keys, so B6 reads the ring as it lies), built once
    per step by the caller for all layers, ``kv_rows`` the same on the
    host.  Returns (out, new_kv): the (k,
    v) for cache construction, or the updated cache.

    Under a model group that splits the q heads, the rank computes its q
    heads and the kv heads they read (``_tp_attn_weights``), B5 runs on
    them, and ``wo``'s partial sums are reduced (g).  Where the sequence is
    cut (training), ``x`` is the rank's chunk and the output too
    (``C.layer_in`` / ``C.layer_out``); ``positions`` are the whole
    sequence's.

    ``cuts`` (a mesh step's, ``{"k": Cut or None, "v": ...}``): the cache is
    placed as ``sharding.cache_shardings`` places it, whatever the heads'
    split, and the layer works on every kv head.  A prefill runs B5 on the
    rank's kv heads as above and returns the cache of every kv head: on a
    cache cut on its rows only the rank's rows of it (``_prefill_rows``: k
    and v at the prompt positions those rows hold), else k and v at every
    position.  A decode step gathers q over the model group and
    forms the new row's k and v for every kv head, then runs ``_decode`` on
    the placed chunk.  The rank's q heads then go through ``wo`` as
    above."""
    tp = C.split(p["wq"].shape[1], cfg.n_heads)
    cut = None if cuts is None else cuts["k"]
    placed = cuts is not None and (tp or cut is not None)
    whole = p
    x = C.layer_in(x, tp)
    if tp:
        p = _tp_attn_weights(cfg, p, whole_kv=placed and cache is not None)
    q = einsum32("bsd,dhk->bshk", x, p["wq"], out_dtype=x.dtype)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k, v = _kv(cfg, p, x, positions)
    if cache is not None:
        Hl = q.shape[2]
        if placed and k.shape[2] != cfg.n_kv_heads:
            # the model group splits the kv heads: every rank's, whole
            k, v = C.gather_from_model(k, 2), C.gather_from_model(v, 2)
        out = _decode(cfg, C.gather_from_model(q, 2) if placed and tp else q,
                      k, v, cache, cut, cache_index, kv_len, kv_rows,
                      sliding_window, x.dtype)
        if placed and tp:
            out = out[:, :, C.model_rank() * Hl:(C.model_rank() + 1) * Hl]
        new_kv = cache
    else:
        out = ops.flash_attention(q, k, v, causal=True,
                                  sliding_window=sliding_window,
                                  logit_softcap=cfg.attn_logit_softcap)
        new_kv = {"k": k, "v": v}
        if placed:
            mine = (k, v) if k.shape[2] == cfg.n_kv_heads else None
            if mine is None and whole["wk"].shape[1] != cfg.n_kv_heads:
                whole = dict(whole, wk=C.gather_from_model(whole["wk"], 1),
                             wv=C.gather_from_model(whole["wv"], 1))
            if cut is not None and cut.dim == 2:
                k, v = _prefill_rows(cfg, whole, x, positions, cut,
                                     sliding_window, mine)
            elif mine is None:
                k, v = _kv(cfg, whole, x, positions)
            new_kv = {"k": k, "v": v}
    if tp:
        y = reduced_dense(out.reshape(*out.shape[:2], -1),
                          p["wo"].reshape(-1, p["wo"].shape[-1]), x.dtype)
    else:
        y = C.layer_out(einsum32("bshk,hkd->bsd", out, p["wo"],
                                 out_dtype=x.dtype), False)
    return y, new_kv


def _kv(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor):
    """k (normed where the config norms it, RoPE at ``positions``) and v of
    ``x`` (B, S, d) through ``p``'s wk and wv: (B, S, KV, hd) each."""
    k = einsum32("bsd,dnk->bsnk", x, p["wk"], out_dtype=x.dtype)
    v = einsum32("bsd,dnk->bsnk", x, p["wv"], out_dtype=x.dtype)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return apply_rope(k, positions, cfg.rope_theta), v


def chunk_positions(cut, prompt: int, window: int, device):
    """The prompt position each row of a prefilled cache chunk holds (the
    ``cut.size`` rows from ``cut.start`` of a cache of ``cut.n * cut.size``
    rows): row r holds position r, and on a ring of w rows that the prompt
    has filled, slot s the position p of the last w with p % w == s.
    Returns (the positions (rows,), clamped to the prompt, and whether each
    row holds one: a row past the prompt holds none)."""
    rows = torch.arange(cut.start, cut.start + cut.size, device=device)
    if window and prompt >= window:
        return prompt - window + (rows - prompt) % window, rows >= 0
    return rows.clamp(max=prompt - 1), rows < prompt


def _prefill_rows(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
                  cut, sliding_window: int, kv=None):
    """The rank's rows (``cut``, on dim 2) of the prefilled KV-major cache
    of every kv head: k and v at the prompt positions those rows hold
    (``chunk_positions``), zero where they hold none; taken from ``kv``
    (every kv head's k and v at every position) where the layer has them,
    else projected there through ``p``'s whole wk and wv.  Returns k and v
    (B, KV, cut.size, hd)."""
    pos, live = chunk_positions(cut, x.shape[1], sliding_window, x.device)
    if kv is None:
        kv = _kv(cfg, p, x[:, pos], positions[:, pos])
    else:
        kv = tuple(t[:, pos] for t in kv)
    keep = live[None, :, None, None]
    return tuple(torch.where(keep, t, t.new_zeros(())).transpose(1, 2)
                 for t in kv)


def _decode(cfg, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            cache: dict, cut, cache_index: int, kv_len: torch.Tensor,
            kv_rows: Optional[int], sliding_window: int,
            dtype: torch.dtype) -> torch.Tensor:
    """One decode step of q's heads (q (B, 1, H, hd), the new row's k and
    v (B, 1, KV, hd)) against the cache, or its chunk as ``cut`` places it:
    the new row written where the rows hold its slot (``cache_index``, on
    a ring of w rows ``cache_index % w``).  Whole (``cut`` None): B6 on the
    cache.  Cut on its rows (dim 2): B6's partial mode over the rank's rows
    (``kv_len``: their live rows, a clamp of the whole cache's: a ring's
    live slots are a prefix) and the partials of the cut's group combined
    in rank order, rounded once to ``dtype``.  Cut on another dim (head_dim,
    where the rows are fewer than it): the chunks gathered whole over its
    group for the step, B6 on every head, and the rank's chunk kept after
    the write; that route is correct before it is fast, and no full-width
    cache takes it (their rows are the largest dim).  Returns (B, 1, H,
    hd)."""
    ck, cv = cache["k"], cache["v"]
    rows = ck.shape[2] * (cut.n if cut is not None and cut.dim == 2 else 1)
    at = cache_index % rows if sliding_window else cache_index
    cap = cfg.attn_logit_softcap
    if cut is not None and cut.dim == 2:
        if cut.start <= at < cut.start + cut.size:
            ck[:, :, at - cut.start] = k[:, 0].to(ck.dtype)
            cv[:, :, at - cut.start] = v[:, 0].to(cv.dtype)
        out, lse = ops.decode_attention_kv_major(
            q, ck, cv, kv_len, logit_softcap=cap, kv_rows=kv_rows,
            return_lse=True)
        return C.combine_partials(out, lse[:, None], cut.group, dtype)
    ckw, cvw = (c if cut is None else cut.gather(c) for c in (ck, cv))
    ckw[:, :, at] = k[:, 0].to(ckw.dtype)
    cvw[:, :, at] = v[:, 0].to(cvw.dtype)
    out = cache_attention(q, ckw, cvw, kv_len, logit_softcap=cap,
                          kv_rows=kv_rows)
    if cut is not None:
        ck.copy_(cut.chunk(ckw))
        cv.copy_(cut.chunk(cvw))
    return out


def _tp_attn_weights(cfg, p: dict, whole_kv: bool = False):
    """The weights a rank's q heads read: its shards of wq and wo; wk and
    wv its shards where the kv heads are split too, else the replicated
    tensors sliced to the kv heads its q heads map to (q head h reads kv
    head h // (H / KV)), through f, or whole with ``whole_kv``; qk-norm
    scales through f.  The local group (q heads over kv heads) must be
    whole; a ``ValueError`` says where it is not."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    Hl, KVl = p["wq"].shape[1], p["wk"].shape[1]
    p = dict(p)
    if KVl == KV:
        G, r = H // KV, C.model_rank()
        if Hl % G == 0:
            k0, k1 = r * Hl // G, (r + 1) * Hl // G
        elif G % Hl == 0:
            k0 = r * Hl // G
            k1 = k0 + 1
        else:
            raise ValueError(f"{Hl} q heads a rank over groups of {G}: the "
                             "rank's q heads do not map to whole kv heads")
        for name in ("wk", "wv"):
            p[name] = C.copy_to_model(p[name])
            if not whole_kv:
                p[name] = p[name][:, k0:k1]
        KVl = k1 - k0
    if Hl % KVl:
        raise ValueError(f"{Hl} q heads over {KVl} kv heads on a rank")
    for name in ("q_norm", "k_norm"):
        if name in p:
            p[name] = C.copy_to_model(p[name])
    return p


# ---------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention)
# ---------------------------------------------------------------------------

def mla_init(cfg, generator: torch.Generator) -> dict:
    dt = dtype_of(cfg)
    d, H = cfg.d_model, cfg.n_heads
    r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_head_dim,
                     cfg.qk_rope_head_dim, cfg.v_head_dim)
    return {
        "wq": init_dense(generator, (d, H, dn + dr), dtype=dt),
        "w_dkv": init_dense(generator, (d, r + dr), dtype=dt),
        "w_uk": init_dense(generator, (r, H, dn), dtype=dt),
        "w_uv": init_dense(generator, (r, H, dv), dtype=dt),
        "wo": init_dense(generator, (H, dv, d), scale=1.0 / math.sqrt(H * dv),
                         dtype=dt),
        "kv_norm": torch.ones((r,), dtype=dt, device=generator.device),
    }


def mla_spec(cfg) -> dict:
    """The logical axes of ``mla_init``'s leaves."""
    return {"wq": ("embed", "heads", "head_dim"),
            "w_dkv": ("embed", "kv_lora"),
            "w_uk": ("kv_lora", "heads", "head_dim"),
            "w_uv": ("kv_lora", "heads", "head_dim"),
            "wo": ("heads", "head_dim", "embed"),
            "kv_norm": ("kv_lora",)}


def mla_prefill_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Causal attention with one kv head per query head: q, k (B, S, H, dqk),
    v (B, S, H, dv) -> (B, S, H, dv) in q's dtype.  The JAX package's
    ``plain_attention`` at this shape: float32 logits over sqrt(dqk), the
    causal mask at NEG_INF, a float32 softmax, the context rounded once.  Its
    blockwise XLA path, taken above ``attn_block_q``, is the same function."""
    S = q.shape[1]
    logits = einsum32("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    pos = torch.arange(S, device=q.device)
    logits = logits.masked_fill(pos[None, :] > pos[:, None], NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return einsum32("bhqk,bkhd->bqhd", p, v, out_dtype=q.dtype)


def mla_apply(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor, *,
              cache: Optional[dict] = None,
              cache_index: Optional[int] = None,
              cuts: Optional[dict] = None):
    """MLA.  The cache holds only the normed latent (B, S_cache, r) and the
    shared rope key (B, S_cache, dr).  Prefill (``cache`` None) materialises
    per-head K and V from the latent; decode takes the absorbed form: q_nope
    through ``w_uk`` against the latent cache, plus q_rope . k_rope, the
    context back through ``w_uv``.  The new rows are written into the cache
    at ``cache_index`` in place.  Returns (out, new_cache): the (latent,
    k_rope) for cache construction, or the updated cache.

    Under a model group that splits the heads, the rank computes the whole
    latent and rope key (``w_dkv`` and ``kv_norm`` replicated, through f)
    and its heads of q, K and V, and ``wo``'s partial sums are reduced.
    Where the sequence is cut, ``x`` and the output are the rank's chunk
    (``C.layer_in`` / ``C.layer_out``).

    ``cuts`` (a mesh step's): the cache is placed as
    ``sharding.cache_shardings`` places it.  A prefill returns a leaf cut on
    its rows as the rank's rows of it (zero past the prompt), the others
    at every position; a decode step runs ``_mla_decode`` on the placed
    chunks, and takes its heads of the context through ``w_uv``.  Plain
    PyTorch, as in the JAX package."""
    H = p["wq"].shape[1]
    tp = C.split(H, cfg.n_heads)
    w_dkv, kv_norm = p["w_dkv"], p["kv_norm"]
    x = C.layer_in(x, tp)
    B, S, _ = x.shape
    if tp:
        w_dkv, kv_norm = C.copy_to_model(w_dkv), C.copy_to_model(kv_norm)
    r, dn = cfg.kv_lora_rank, cfg.qk_nope_head_dim
    q = einsum32("bsd,dhk->bshk", x, p["wq"], out_dtype=x.dtype)
    q_nope = q[..., :dn]
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    dkv = einsum32("bsd,dr->bsr", x, w_dkv, out_dtype=x.dtype)
    latent = rms_norm(dkv[..., :r], kv_norm, cfg.norm_eps)
    k_rope = apply_rope(dkv[..., None, r:], positions, cfg.rope_theta)[..., 0, :]
    if cache is not None:
        q_abs = einsum32("bshk,rhk->bshr", q_nope, p["w_uk"]).to(x.dtype)
        ctx = _mla_decode(q_abs, q_rope, latent, k_rope, cache, cuts,
                          cache_index, tp, q.shape[-1])
        out = einsum32("bshr,rhv->bshv", ctx, p["w_uv"], out_dtype=x.dtype)
        new_cache = cache
    else:
        k_nope = einsum32("bsr,rhk->bshk", latent, p["w_uk"], out_dtype=x.dtype)
        v = einsum32("bsr,rhv->bshv", latent, p["w_uv"], out_dtype=x.dtype)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            B, S, H, k_rope.shape[-1])], dim=-1)
        out = mla_prefill_attention(torch.cat([q_nope, q_rope], dim=-1), k, v)
        new_cache = {"latent": latent, "k_rope": k_rope}
        for n, cut in (cuts or {}).items():
            if cut is not None and cut.dim == 1:
                pos, live = chunk_positions(cut, S, 0, x.device)
                rows = new_cache[n][:, pos]
                new_cache[n] = torch.where(live[:, None], rows,
                                           rows.new_zeros(()))
    if tp:
        y = reduced_dense(out.reshape(B, S, -1),
                          p["wo"].reshape(-1, p["wo"].shape[-1]), x.dtype)
    else:
        y = C.layer_out(einsum32("bshv,hvd->bsd", out, p["wo"],
                                 out_dtype=x.dtype), False)
    return y, new_cache


def _mla_decode(q_abs, q_rope, latent, k_rope, cache, cuts, cache_index,
                tp, dqk):
    """MLA's absorbed decode (``mla_apply``): the float32 context (B, 1,
    Hl, r) of q's heads against the latent and rope-key cache, or its
    chunks as ``cuts`` place them.  Whole: the new rows written at
    ``cache_index``, logits masked at NEG_INF past ``cache_index`` + 1, their
    softmax.  Cut on its rows (both leaves): the absorbed query and q_rope
    of every head gathered over the model group, the rows written on the
    rank that holds them, the softmax over the rank's rows with its
    log-sum-exp (-inf where none is live yet), and the ranks' contexts
    combined in rank order (``collectives.combine_partials``).  Cut on
    another dim: the leaves gathered whole for the step and the rank's
    chunks kept after the write."""
    cuts = cuts or {"latent": None, "k_rope": None}
    rows_cut = all(c is not None and c.dim == 1 for c in cuts.values())
    cut = cuts["latent"] if rows_cut else None
    Hl, S = q_abs.shape[2], latent.shape[1]
    if rows_cut and tp:
        q_abs, q_rope = (C.gather_from_model(t, 2) for t in (q_abs, q_rope))
    if rows_cut:
        cl, cr, start = cache["latent"], cache["k_rope"], cut.start
    else:
        cl, cr = (cache[n] if cuts[n] is None else cuts[n].gather(cache[n])
                  for n in ("latent", "k_rope"))
        start = 0
    if 0 <= cache_index - start < cl.shape[1]:
        at = cache_index - start
        cl[:, at:at + S] = latent.to(cl.dtype)
        cr[:, at:at + S] = k_rope.to(cr.dtype)
    logits = einsum32("bshr,btr->bhst", q_abs, cl)
    logits = logits + einsum32("bshk,btk->bhst", q_rope, cr)
    logits = logits * (1.0 / math.sqrt(dqk))
    dead = (torch.arange(start, start + cl.shape[1], device=cl.device)
            >= cache_index + S)
    logits = logits.masked_fill(dead, NEG_INF)
    ctx = einsum32("bhst,btr->bshr", torch.softmax(logits, dim=-1), cl)
    if not rows_cut:
        for n, whole in (("latent", cl), ("k_rope", cr)):
            if cuts[n] is not None:
                cache[n].copy_(cuts[n].chunk(whole))
        return ctx
    if cache_index + S <= cut.start:            # no live row here yet
        lse = torch.full(ctx.shape[:-1], -torch.inf, device=ctx.device)
        ctx = torch.zeros_like(ctx)
    else:
        lse = torch.logsumexp(logits, dim=-1).transpose(1, 2)   # (B, S, H)
    ctx = C.combine_partials(ctx, lse, cut.group)
    if tp:
        ctx = ctx[:, :, C.model_rank() * Hl:(C.model_rank() + 1) * Hl]
    return ctx


# ---------------------------------------------------------------------------
# FFN: dense (SwiGLU) and MoE
# ---------------------------------------------------------------------------

def mlp_init(cfg, generator: torch.Generator,
             d_ff: Optional[int] = None) -> dict:
    dt = dtype_of(cfg)
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {"w_gate": init_dense(generator, (d, f), dtype=dt),
            "w_up": init_dense(generator, (d, f), dtype=dt),
            "w_down": init_dense(generator, (f, d), dtype=dt)}


def mlp_spec(cfg) -> dict:
    """The logical axes of ``mlp_init``'s leaves."""
    return {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
            "w_down": ("mlp", "embed")}


def mlp_apply(p: dict, x: torch.Tensor, d_ff: Optional[int] = None,
              reduce: bool = True) -> torch.Tensor:
    """SwiGLU; SiLU runs on the float32 of the already-rounded gate.  Where
    the hidden dim (``d_ff`` whole) is split over a model group, w_gate and
    w_up are column-parallel (their input through ``C.layer_in``: f, or the
    sequence's all-gather where it is cut) and w_down row-parallel, its
    partial sums reduced in float32 (``reduced_dense``), or left partial
    and whole along the sequence in x's dtype with ``reduce=False``.  A
    whole layer's output goes out through ``C.layer_out``."""
    tp = d_ff is not None and C.split(p["w_gate"].shape[-1], d_ff)
    x = C.layer_in(x, tp)
    h = torch.nn.functional.silu(dense(x, p["w_gate"]).float()).to(x.dtype)
    h = h * dense(x, p["w_up"])
    if not reduce:
        return dense(h, p["w_down"])
    if tp:
        return reduced_dense(h, p["w_down"], x.dtype)
    return C.layer_out(dense(h, p["w_down"]), False)


def moe_init(cfg, generator: torch.Generator) -> dict:
    """The router (d, E) in float32 in every config; the experts (E, d, f)
    and (E, f, d) and the shared experts' SwiGLU in the config's dtype."""
    dt = dtype_of(cfg)
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    p = {
        "router": init_dense(generator, (d, E)),
        "w_gate": init_dense(generator, (E, d, f), scale=1.0 / math.sqrt(d),
                             dtype=dt),
        "w_up": init_dense(generator, (E, d, f), scale=1.0 / math.sqrt(d),
                           dtype=dt),
        "w_down": init_dense(generator, (E, f, d), scale=1.0 / math.sqrt(f),
                             dtype=dt),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(cfg, generator, d_ff=cfg.n_shared_experts * f)
    return p


_ROUTING: Optional[List[dict]] = None


def moe_spec(cfg) -> dict:
    """The logical axes of ``moe_init``'s leaves: experts replicated (their
    counts do not divide a 16-way axis), each expert's hidden dim over
    ``expert_mlp``."""
    p = {"router": ("embed", "experts"),
         "w_gate": ("experts", "embed", "expert_mlp"),
         "w_up": ("experts", "embed", "expert_mlp"),
         "w_down": ("experts", "expert_mlp", "embed")}
    if cfg.n_shared_experts:
        p["shared"] = mlp_spec(cfg)
    return p


@contextlib.contextmanager
def record_routing():
    """While open, every ``moe_apply`` appends its routing to the yielded
    list: ``idx`` (B, S, k), the chosen experts best first; ``keep`` (B, S,
    k), whether the assignment found room under the capacity; ``slot`` (B, S,
    k), its row in the batch row's dispatch buffer, ``expert * cap + pos``,
    or ``E * cap`` (the overflow row) when dropped.  Tensors stay on the
    device; nothing is read back."""
    global _ROUTING
    outer, _ROUTING = _ROUTING, []
    try:
        yield _ROUTING
    finally:
        _ROUTING = outer


def moe_capacity(cfg, S: int) -> int:
    """Rows per expert and batch row: ``S k / E`` times the capacity factor,
    rounded, within [1, S]."""
    cap = int(S * cfg.moe_top_k / cfg.n_experts * cfg.moe_capacity_factor
              + 0.5)
    return max(min(cap, S), 1)


def moe_apply(cfg, p: dict, x: torch.Tensor):
    """Capacity-routed top-k MoE with a cumsum-position dispatch, per batch
    row, as the JAX package's.  x (B, S, d) -> (y (B, S, d), aux).

    Top-k takes the first k of a stable descending sort, so ties go to the
    lowest expert as with ``jax.lax.top_k`` (``torch.topk`` does not order
    them).  An assignment's position is the running count of its expert
    over the batch row's (S k) assignments, token-major; from ``cap`` on it
    is dropped.  Every kept row of the dispatch buffer holds one token, so
    the scatter copies; the buffer lies expert-major, (E, B, cap), so each
    expert's rows of every batch row are one GEMM operand.  Gate and up
    products stay float32 through ``silu(g) * u`` and round once (unlike
    ``mlp_apply``); the gather is weighted by ``keep * gate`` in x's dtype.

    Where each expert's hidden dim is split over a model group, every rank
    routes the whole batch with the replicated router (the same experts,
    positions and drops everywhere), runs its columns of every expert on
    f(x) and combines with f(gate), and one g sums the partial outputs
    (with the shared experts' where they are split too).  The load-balance
    term is every rank's, counted once.

    Where the sequence is cut, ``x`` is the rank's chunk: the router runs
    on it (its weight through ``C.seq_weight``) and its logits are
    gathered whole (``C.gather_seq_whole``), so every rank routes every
    token of its batch rows alike; the experts take the gathered tokens
    (``C.layer_in``) and their output goes back as the rank's chunk
    (``C.layer_out``)."""
    E, k = cfg.n_experts, cfg.moe_top_k
    router_logits = C.gather_seq_whole(dense32(x, C.seq_weight(p["router"])))
    tp = C.split(p["w_gate"].shape[-1], cfg.moe_d_ff)
    xin, x = x, C.layer_in(x, tp)
    B, S, d = x.shape
    cap = moe_capacity(cfg, S)
    probs = torch.softmax(router_logits, dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[..., :k], idx[..., :k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    if tp:
        gate = C.copy_to_model(gate)

    idx_f = idx.reshape(B, S * k)
    pos_in_e = torch.nn.functional.one_hot(idx_f, E).cumsum(dim=1) - 1
    pos = pos_in_e.gather(-1, idx_f[..., None])[..., 0]
    keep = pos < cap
    rows = torch.arange(B, device=x.device)[:, None]
    dest = torch.where(keep, (idx_f * B + rows) * cap + pos, E * B * cap)
    if _ROUTING is not None:
        _ROUTING.append({
            "idx": idx, "keep": keep.reshape(B, S, k),
            "slot": torch.where(keep, idx_f * cap + pos,
                                E * cap).reshape(B, S, k)})

    buf = x.new_zeros((E * B * cap + 1, d))
    buf[dest.reshape(-1)] = x.repeat_interleave(k, dim=1).reshape(-1, d)
    buf = buf[:-1].view(E, B * cap, d)
    g = bmm32(buf, p["w_gate"])
    h = (torch.nn.functional.silu(g) * bmm32(buf, p["w_up"])).to(x.dtype)
    out = einsum32("ecf,efd->ecd", h, p["w_down"], out_dtype=x.dtype)

    got = out.reshape(E * B * cap, d)[torch.where(keep, dest, 0)]
    got = got * (keep * gate.reshape(B, S * k)).to(x.dtype)[..., None]
    y = got.reshape(B, S, k, d).sum(dim=2)
    if cfg.n_shared_experts:
        ff = cfg.n_shared_experts * cfg.moe_d_ff
        if tp and C.split(p["shared"]["w_gate"].shape[-1], ff):
            y = y + mlp_apply(p["shared"], xin, ff, reduce=False)
        else:
            y = C.layer_out(y, tp) + mlp_apply(p["shared"], xin, ff)
            return y, moe_load_balance_loss(cfg, router_logits)
    return C.layer_out(y, tp), moe_load_balance_loss(cfg, router_logits)


def moe_load_balance_loss(cfg, router_logits: torch.Tensor) -> torch.Tensor:
    """E times the sum over experts of (mean router probability) x (share of
    tokens whose first choice it is), float32, over the whole batch: under
    a batch group both means take every rank's rows (their sums reduced
    over the group)."""
    probs = torch.softmax(router_logits, dim=-1)
    top1 = torch.nn.functional.one_hot(probs.argmax(-1), cfg.n_experts)
    if C.batch_ranks() == 1:
        frac = probs.mean(dim=(0, 1))
        return cfg.n_experts * (frac * top1.float().mean(dim=(0, 1))).sum()
    n = torch.tensor(float(probs.shape[0] * probs.shape[1]
                           * C.batch_ranks()), device=probs.device)
    frac = C.sum_over_batch(probs.sum(dim=(0, 1))) / n
    share = C.sum_over_batch(top1.float().sum(dim=(0, 1)).detach()) / n
    return cfg.n_experts * (frac * share).sum()
