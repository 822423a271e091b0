"""Fused Swin window attention: the CUDA kernel's wrapper and its plain version.

Replaces the TPU kernel ``repro/kernels/window_attention.py ::
fused_window_attention_pallas``: one launch covers the cyclic shift by
(-shift, -shift), the partition into ``window`` x ``window`` windows,
``softmax(q hd^-1/2 k^T + bias, mask -> -1e9) v`` per window and head, the
un-partition and the roll back.

The CUDA kernel (``csrc/window_attention.cu``) runs one CTA per (window,
head, image), gathers its rows from the image-layout qkv with modular
indices and keeps scores, softmax and P.V in shared memory.  On the H100 it
is bound by bytes: each qkv element is read once and each output element
written once; the source note gives the numbers.

``fused_window_attention_plain`` is the same function in plain PyTorch, with
the roll and the partition written out.  ``kernels/ops.py`` takes it only for
tensors on the CPU; ``chip_smoke.py`` holds the kernel against it on the card.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e9
SUPPORTED_HEAD_DIMS = (16, 32)


def fused_window_attention_plain(qkv: torch.Tensor, bias: torch.Tensor,
                                 mask: Optional[torch.Tensor], *, window: int,
                                 shift: int, n_heads: int) -> torch.Tensor:
    """qkv (B, Hp, Wp, 3C) in image coordinates; bias (nh, w2, w2); mask
    (nW, w2, w2) bool (True = may attend) indexed by rolled window, or None.
    Returns (B, Hp, Wp, C) in image coordinates, qkv's dtype."""
    B, Hp, Wp, C3 = qkv.shape
    C = C3 // 3
    hd = C // n_heads
    w2 = window * window
    nwh, nww = Hp // window, Wp // window
    x = qkv.float()
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    x = x.reshape(B, nwh, window, nww, window, 3, n_heads, hd)
    x = x.permute(0, 1, 3, 5, 6, 2, 4, 7).reshape(B, nwh * nww, 3, n_heads,
                                                   w2, hd)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]        # (B, nW, nh, w2, hd)
    s = torch.matmul(q * (1.0 / math.sqrt(hd)), k.transpose(-1, -2))
    s = s + bias.float()
    if mask is not None:
        s = s.masked_fill(~mask[None, :, None], NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, v)                              # (B, nW, nh, w2, hd)
    o = o.reshape(B, nwh, nww, n_heads, window, window, hd)
    o = o.permute(0, 1, 4, 2, 5, 3, 6).reshape(B, Hp, Wp, C)
    if shift:
        o = torch.roll(o, (shift, shift), dims=(1, 2))
    return o.to(qkv.dtype)


@functools.cache
def _lib():
    lib = _build.library("window_attention")
    fn = lib.fused_window_attention_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_window_attention_cuda(qkv: torch.Tensor, bias: torch.Tensor,
                                mask: Optional[torch.Tensor], *, window: int,
                                shift: int, n_heads: int) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream.  Same contract as
    the plain version; fp32 only, head dim 16 or 32."""
    B, Hp, Wp, C3 = qkv.shape
    C = C3 // 3
    w2 = window * window
    nW = (Hp // window) * (Wp // window)
    tensors = (qkv, bias) if mask is None else (qkv, bias, mask)
    if any(t.device.type != "cuda" or t.device != qkv.device for t in tensors):
        raise ValueError("fused_window_attention_cuda: every operand must lie "
                         "on the same CUDA device")
    if qkv.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("fused_window_attention_cuda takes float32 qkv and bias")
    if C % n_heads or C // n_heads not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {C / n_heads} not in {SUPPORTED_HEAD_DIMS}")
    if Hp % window or Wp % window or not 0 <= shift < window:
        raise ValueError("Hp and Wp must be multiples of window, 0 <= shift < window")
    if tuple(bias.shape) != (n_heads, w2, w2):
        raise ValueError(f"bias must be {(n_heads, w2, w2)}, got {tuple(bias.shape)}")
    if mask is not None and (mask.dtype != torch.bool
                             or tuple(mask.shape) != (nW, w2, w2)):
        raise ValueError(f"mask must be bool {(nW, w2, w2)}")
    qkv, bias = qkv.contiguous(), bias.contiguous()
    mask = None if mask is None else mask.contiguous()
    out = torch.empty((B, Hp, Wp, C), dtype=torch.float32, device=qkv.device)
    if out.numel() == 0:
        return out
    fn = _lib()
    rc = fn(qkv.data_ptr(), bias.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            B, Hp, Wp, C, n_heads, window, shift,
            float(1.0 / math.sqrt(C // n_heads)),
            torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(rc, "fused_window_attention")
    _build.LAUNCHES["fused_window_attention"] += 1
    return out
