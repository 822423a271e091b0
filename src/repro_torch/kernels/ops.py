"""Public kernel entry points, dispatching by the device of the tensors.

A tensor on the CPU goes to the kernel's plain PyTorch version; a tensor on
a CUDA device goes to the hand-written CUDA kernel, which either launches or
raises; a tensor on the meta device gets empty outputs of the right shapes
and dtypes and reaches neither (``launch/cost.py`` counts a step so).
Nothing falls back from a CUDA tensor to the plain version, and the choice
never depends on whether CUDA is present or a build worked.  The
signatures follow ``repro/kernels/ops.py`` (``quantize``, ``dequantize``,
``flash_attention``, ``decode_attention``, ``fused_window_attention``,
``window_attention``, ``codec_encode``, ``codec_decode``); the attention
kernels choose their own block sizes, so those are not arguments.
``decode_attention_kv_major`` is the LM's decode entry, on the cache layout
it keeps.

``LAUNCHES`` counts kernel launches by name; ``COSTS`` the operations and
bytes of every call, on every route, from the operands' shapes alone (see
``_build``).  The bounds ``chip_smoke.py`` reports come from the same cost
functions.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import codec as _codec
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import quant as _quant
from repro_torch.kernels import window_attention as _wa
from repro_torch.kernels._build import COSTS, LAUNCHES  # noqa: F401
from repro_torch.kernels._build import count, route

QUANT = {"cuda": _quant.quant_cuda, "cpu": _quant.quant_plain,
         "meta": _quant.quant_meta}
DEQUANT = {"cuda": _quant.dequant_cuda, "cpu": _quant.dequant_plain,
           "meta": _quant.dequant_meta}
DECODE = {"cuda": _da.decode_attention_cuda, "cpu": _da.decode_attention_plain,
          "meta": _da.decode_attention_meta}
FUSED_WINDOW = {"cuda": _wa.fused_window_attention_cuda,
                "cpu": _wa.fused_window_attention_plain,
                "meta": _wa.fused_window_attention_meta}
WINDOWS = {"cuda": _wa.window_attention_cuda, "cpu": _wa.window_attention_plain,
           "meta": _wa.window_attention_meta}
ENCODE = {"cuda": _codec.codec_encode_cuda, "cpu": _codec.codec_encode_plain,
          "meta": _codec.codec_encode_meta}
DECODE_CODEC = {"cuda": _codec.codec_decode_cuda,
                "cpu": _codec.codec_decode_plain,
                "meta": _codec.codec_decode_meta}


def quantize(x: torch.Tensor, block: int = 8192
             ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Per-block absmax int8 quant of one tensor of any shape.  Returns
    (q (nb, block) int8, scales (nb,) f32, n)."""
    count("quant", _quant.cost(x.numel(), block))
    return QUANT[route(x)](x, block)


def dequantize(q: torch.Tensor, scales: torch.Tensor, n: int, shape,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of ``quantize``: a tensor of ``shape`` and ``dtype``."""
    count("dequant", _quant.cost(n, q.shape[-1]))
    return DEQUANT[route(q)](q, scales, n, shape, dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sliding_window: int = 0,
                    logit_softcap: float = 0.0) -> torch.Tensor:
    """Causal GQA attention: q (B, Sq, H, hd), k and v (B, Skv, KV, hd), q
    aligned to the end of kv; ``sliding_window`` w > 0 keeps key j for query
    position i iff i - w < j <= i; ``logit_softcap`` c > 0 caps each scaled
    logit s at tanh(s / c) c.  Returns (B, Sq, H, hd) in q's dtype.  Where a
    gradient is wanted (grad enabled and an operand requiring it) the call
    goes through ``FlashAttentionFn``, which also keeps the log-sum-exp and
    runs B5's backward; otherwise no log-sum-exp is written."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _fa.FlashAttentionFn.apply(q, k, v, causal, sliding_window,
                                          logit_softcap)
    return _fa.forward(q, k, v, causal, sliding_window, logit_softcap)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, *, logit_softcap: float = 0.0,
                     kv_rows: Optional[int] = None) -> torch.Tensor:
    """One query token against a cache: q (B, 1, H, hd), k and v
    (B, S, KV, hd), kv_len (B,) int32 valid rows, ``logit_softcap`` as
    ``flash_attention``'s.  Transposes the cache to KV-major, as the TPU
    wrapper does; returns (B, 1, H, hd).  ``kv_rows``: every row's live
    cache rows as the caller knows them on the host, for the cost count
    (the cache's length if None); the kernel reads ``kv_len``."""
    return decode_attention_kv_major(q, k.transpose(1, 2), v.transpose(1, 2),
                                     kv_len, logit_softcap=logit_softcap,
                                     kv_rows=kv_rows)


def decode_attention_kv_major(q: torch.Tensor, ck: torch.Tensor,
                              cv: torch.Tensor, kv_len: torch.Tensor, *,
                              logit_softcap: float = 0.0,
                              kv_rows: Optional[int] = None,
                              return_lse: bool = False):
    """``decode_attention`` on a KV-major cache, ck and cv (B, KV, S, hd):
    no transpose.  ``return_lse``: B6's partial mode, (out (B, 1, H, hd)
    float32, lse (B, H) float32; -inf and zeros where ``kv_len`` is 0), for
    a rank's rows of a cache cut over several ranks."""
    count("decode_attention_lse" if return_lse else "decode_attention",
          _da.cost(q.shape, ck.shape, q.element_size(), kv_rows, return_lse))
    return DECODE[route(q)](q, ck, cv, kv_len, logit_softcap, return_lse)


def fused_window_attention(qkv: torch.Tensor, bias: torch.Tensor,
                           mask: Optional[torch.Tensor] = None, *, window: int,
                           shift: int, n_heads: int) -> torch.Tensor:
    """One-launch Swin window attention: shifted roll + partition + biased
    and masked softmax + un-partition.

    qkv: (B, Hp, Wp, 3C) packed projection in image coordinates (Hp, Wp
    multiples of ``window``); bias: (nh, w2, w2); mask: (nW, w2, w2) bool or
    None, ordered by rolled window index.  Returns (B, Hp, Wp, C)."""
    count("fused_window_attention", _wa.fused_cost(
        qkv.shape, qkv.element_size(), n_heads, window, mask is not None))
    return FUSED_WINDOW[route(qkv)](qkv, bias, mask, window=window,
                                    shift=shift, n_heads=n_heads)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Swin windowed attention on pre-partitioned windows.

    q, k, v: (nB, w2, nh, hd); bias: (nh, w2, w2); mask: (nB, w2, w2) bool
    or None.  f32 inside, returns q's dtype.  A row whose keys are all
    masked averages v over the JAX op's padded W2P = ceil(w2/64)*64 rows,
    as that op does."""
    count("window_attention", _wa.windows_cost(q.shape, q.element_size(),
                                               mask is not None))
    return WINDOWS[route(q)](q, k, v, bias, mask)


def codec_encode(flat: torch.Tensor, block: int = 8192,
                 delta: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block absmax scales + int8 quant (+ block-local mod-256 row delta)
    over a packed block-aligned stream.  Returns (stream (total,) uint8|int8,
    scales (nb,) f32)."""
    count("codec_encode", _codec.cost(flat.shape[0], block))
    return ENCODE[route(flat)](flat, block, delta)


def codec_decode(stream: torch.Tensor, scales: torch.Tensor, block: int = 8192,
                 delta: bool = False) -> torch.Tensor:
    """Inverse of ``codec_encode``; returns the dequantised (total,) f32."""
    count("codec_decode", _codec.cost(stream.shape[0], block))
    return DECODE_CODEC[route(stream)](stream, scales, block, delta)
