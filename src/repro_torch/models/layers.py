"""Shared layers (``repro/models/layers.py``): the Swin slice's and the dense
LM's.

Conventions, as the JAX package's: activations flow in the model's dtype
(float32 for Swin-T, bf16 for the full-width LMs); norm statistics, RoPE
angles and softmax run in float32; every product accumulates in float32
(``preferred_element_type=jnp.float32`` there).  ``einsum32`` is the
counterpart: with ``out_dtype`` equal to the operands' dtype it runs that
dtype's GEMM, which accumulates in float32 (the package keeps bf16 reduced-
precision reductions off) and rounds once at the end; otherwise it runs on
float32 copies of the operands.  Logits stay float32 (``dense32``).  The
package's fp32 policy keeps float32 products off TF32.

Attention runs through the kernels: prefill through ``ops.flash_attention``
(B5), decode through ``ops.decode_attention_kv_major`` (B6) on the KV-major
cache.  The JAX package's ``plain_attention`` and its XLA blockwise path
(``models/attention_flash.py``), between which it switches at
``attn_block_q``, have no port: every prefill takes B5, whose CPU path is the
dense masked softmax.  MLA, MoE, sliding windows and logit soft-capping are
not ported (ROADMAP A8b).
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import ops


def einsum32(subs: str, *args: torch.Tensor,
             out_dtype: torch.dtype) -> torch.Tensor:
    """``torch.einsum`` with products accumulated in float32 and the result
    rounded once to ``out_dtype``."""
    if all(a.dtype == out_dtype for a in args):
        return torch.einsum(subs, *args)
    return torch.einsum(subs, *(a.float() for a in args)).to(out_dtype)


def dense32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with products accumulated in float32 and a float32 result,
    as the JAX package's ``einsum32`` without ``out_dtype``.  On the card,
    half-precision operands go through cuBLAS's half GEMM with a float32
    output, so a large ``w`` (the tied unembedding) is never copied to
    float32; elsewhere the operands are upcast."""
    if x.is_cuda and x.dtype == w.dtype != torch.float32:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Contract the last axis of ``x`` with the first of ``w``, accumulating
    in float32; the output in ``x``'s dtype."""
    if x.dtype == w.dtype:
        return torch.matmul(x, w)
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def init_dense(generator: torch.Generator, shape: Sequence[int],
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal(0, scale^2) float32 weights, ``scale`` = fan_in^-1/2 by
    default, drawn from ``generator`` on its device."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    if scale is None:
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    return torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                       device=generator.device) * scale


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
    """float32 weights; ``models/transformer.py::init`` casts them to the
    config's dtype."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": init_dense(generator, (d, H, hd)),
        "wk": init_dense(generator, (d, KV, hd)),
        "wv": init_dense(generator, (d, KV, hd)),
        "wo": init_dense(generator, (H, hd, d), scale=1.0 / math.sqrt(H * hd)),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), device=generator.device)
        p["k_norm"] = torch.ones((hd,), device=generator.device)
    return p


def cache_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                    kv_len: torch.Tensor) -> torch.Tensor:
    """Decode attention against a KV-major cache: q (B, 1, H, hd), ck and cv
    (B, KV, Sc, hd), kv_len (B,) int32.  Runs B6 on the cache as it lies."""
    if q.shape[1] != 1:
        raise ValueError(f"the cache path decodes one token a step; got "
                         f"{q.shape[1]}")
    return ops.decode_attention_kv_major(q, ck, cv, kv_len)


def attn_apply(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor, *,
               cache: Optional[dict] = None,
               cache_index: Optional[int] = None,
               kv_len: Optional[torch.Tensor] = None):
    """GQA attention with qk-norm before RoPE.  ``cache``: None (prefill) or
    a dict of KV-major k and v (B, KV, S_cache, hd) that the new token is
    written into at ``cache_index`` in place (the JAX package's
    ``dynamic_update_slice`` returns a new cache instead); ``kv_len`` (B,)
    int32 is then ``cache_index`` + S, built once per step by the caller
    for all layers.  Returns (out, new_kv): the (k, v) for cache
    construction, or the updated cache."""
    q = einsum32("bsd,dhk->bshk", x, p["wq"], out_dtype=x.dtype)
    k = einsum32("bsd,dnk->bsnk", x, p["wk"], out_dtype=x.dtype)
    v = einsum32("bsd,dnk->bsnk", x, p["wv"], out_dtype=x.dtype)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        S = x.shape[1]
        ck[:, :, cache_index:cache_index + S] = k.transpose(1, 2).to(ck.dtype)
        cv[:, :, cache_index:cache_index + S] = v.transpose(1, 2).to(cv.dtype)
        out = cache_attention(q, ck, cv, kv_len)
        new_kv = cache
    else:
        out = ops.flash_attention(q, k, v, causal=True)
        new_kv = {"k": k, "v": v}
    y = einsum32("bshk,hkd->bsd", out, p["wo"], out_dtype=x.dtype)
    return y, new_kv


def mlp_init(cfg, generator: torch.Generator) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {"w_gate": init_dense(generator, (d, f)),
            "w_up": init_dense(generator, (d, f)),
            "w_down": init_dense(generator, (f, d))}


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU; SiLU runs on the float32 of the already-rounded gate."""
    h = torch.nn.functional.silu(dense(x, p["w_gate"]).float()).to(x.dtype)
    h = h * dense(x, p["w_up"])
    return dense(h, p["w_down"])
