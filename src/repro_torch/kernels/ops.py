"""Public kernel entry points, dispatching by the device of the tensors.

A tensor on the CPU goes to the kernel's plain PyTorch version; a tensor on
a CUDA device goes to the hand-written CUDA kernel, which either launches or
raises.  Nothing falls back from a CUDA tensor to the plain version, and the
choice never depends on whether CUDA is present or a build worked.  The
signatures follow ``repro/kernels/ops.py`` (``quantize``, ``dequantize``,
``fused_window_attention``, ``codec_encode``, ``codec_decode``).

``LAUNCHES`` counts kernel launches by name (see ``_build``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import codec as _codec
from repro_torch.kernels import quant as _quant
from repro_torch.kernels import window_attention as _wa
from repro_torch.kernels._build import LAUNCHES  # noqa: F401  (re-exported)


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"no kernel or plain version for device {t.device}")


def quantize(x: torch.Tensor, block: int = 8192
             ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Per-block absmax int8 quant of one tensor of any shape.  Returns
    (q (nb, block) int8, scales (nb,) f32, n)."""
    fn = _quant.quant_cuda if _route(x) == "cuda" else _quant.quant_plain
    return fn(x, block)


def dequantize(q: torch.Tensor, scales: torch.Tensor, n: int, shape,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of ``quantize``: a tensor of ``shape`` and ``dtype``."""
    fn = (_quant.dequant_cuda if _route(q) == "cuda"
          else _quant.dequant_plain)
    return fn(q, scales, n, shape, dtype)


def fused_window_attention(qkv: torch.Tensor, bias: torch.Tensor,
                           mask: Optional[torch.Tensor] = None, *, window: int,
                           shift: int, n_heads: int) -> torch.Tensor:
    """One-launch Swin window attention: shifted roll + partition + biased
    and masked softmax + un-partition.

    qkv: (B, Hp, Wp, 3C) packed projection in image coordinates (Hp, Wp
    multiples of ``window``); bias: (nh, w2, w2); mask: (nW, w2, w2) bool or
    None, ordered by rolled window index.  Returns (B, Hp, Wp, C)."""
    fn = (_wa.fused_window_attention_cuda if _route(qkv) == "cuda"
          else _wa.fused_window_attention_plain)
    return fn(qkv, bias, mask, window=window, shift=shift, n_heads=n_heads)


def codec_encode(flat: torch.Tensor, block: int = 8192,
                 delta: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block absmax scales + int8 quant (+ block-local mod-256 row delta)
    over a packed block-aligned stream.  Returns (stream (total,) uint8|int8,
    scales (nb,) f32)."""
    fn = (_codec.codec_encode_cuda if _route(flat) == "cuda"
          else _codec.codec_encode_plain)
    return fn(flat, block, delta)


def codec_decode(stream: torch.Tensor, scales: torch.Tensor, block: int = 8192,
                 delta: bool = False) -> torch.Tensor:
    """Inverse of ``codec_encode``; returns the dequantised (total,) f32."""
    fn = (_codec.codec_decode_cuda if _route(stream) == "cuda"
          else _codec.codec_decode_plain)
    return fn(stream, scales, block, delta)
