"""Per-tensor block int8 quantisation: the CUDA kernels' wrappers and their
plain versions.

Replaces the TPU kernel pair ``repro/kernels/quant.py :: quant_pallas`` /
``dequant_pallas``, which the legacy per-tensor codec launches once per
payload leaf.  For a leaf of any shape, flattened to ``n`` f32 values and
cut into ``nb = ceil(n / block)`` blocks (the last one zero-padded):

  quant:   ``scale = absmax * f32(1/127)`` (1.0 for an all-zero block),
           ``q = clip(round_half_even(x / scale), -127, 127)`` as int8;
           returns (q (nb, block) int8, scales (nb,) f32, n).
  dequant: ``q * scale[block]``, the first ``n`` values, reshaped to the
           leaf's shape and cast to its dtype.

The arithmetic is that of the fused codec's encode (``kernels/codec.py``),
so the plain quant below runs ``codec_encode_plain`` on the padded stream:
kernels, plain versions and the JAX reference agree bitwise.  The CUDA
kernels (``csrc/quant.cu``) read the leaf without padding it and write the
dequantised values without the ``[:n]`` copy; the source note has the
design.  An empty leaf gives ``nb = 0`` and launches nothing.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.codec import LANES, codec_encode_plain


def _check_block(block: int) -> None:
    if block <= 0 or block % LANES:
        raise ValueError(f"quant block must pack whole {LANES}-lane rows; got {block}")


def quant_plain(x: torch.Tensor, block: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """x any shape -> (q (nb, block) int8, scales (nb,) f32, n)."""
    _check_block(block)
    flat = x.float().reshape(-1)
    n = flat.shape[0]
    flat = F.pad(flat, (0, (-n) % block))
    q, scales = codec_encode_plain(flat, block, False)
    return q.reshape(-1, block), scales, n


def dequant_plain(q: torch.Tensor, scales: torch.Tensor, n: int, shape,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of ``quant_plain``: a tensor of ``shape`` and ``dtype``."""
    y = q.to(torch.float32) * scales.float()[:, None]
    return y.reshape(-1)[:n].reshape(shape).to(dtype)


@functools.cache
def _fns():
    lib = _build.library("quant")
    q, dq = lib.quant_f32, lib.dequant_f32
    q.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p])
    dq.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_void_p])
    q.restype = dq.restype = ctypes.c_int
    return q, dq


def quant_cuda(x: torch.Tensor, block: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Launch the quant kernel on PyTorch's current stream.  The leaf is cast
    to a contiguous float32 first, as the reference casts before its pad."""
    _build.check_operands("quant_cuda", x)
    _check_block(block)
    flat = x.to(torch.float32).contiguous().reshape(-1)
    n = flat.shape[0]
    nb = -(-n // block)
    q = torch.empty((nb, block), dtype=torch.int8, device=x.device)
    scales = torch.empty((nb,), dtype=torch.float32, device=x.device)
    if nb == 0:
        return q, scales, n
    rc = _fns()[0](flat.data_ptr(), q.data_ptr(), scales.data_ptr(), n, nb,
                   block, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "quant")
    _build.LAUNCHES["quant"] += 1
    return q, scales, n


def dequant_cuda(q: torch.Tensor, scales: torch.Tensor, n: int, shape,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch the dequant kernel on PyTorch's current stream; the cast to a
    dtype other than float32 follows in PyTorch."""
    _build.check_operands("dequant_cuda", q, scales)
    if q.dtype != torch.int8 or q.dim() != 2:
        raise TypeError("dequant_cuda takes (nb, block) int8")
    if scales.dtype != torch.float32 or scales.shape != (q.shape[0],):
        raise TypeError("dequant_cuda takes one float32 scale per block")
    nb, block = q.shape
    _check_block(block)
    if not 0 <= n <= nb * block:
        raise ValueError(f"{n} values do not fit {nb} blocks of {block}")
    if nb == 0:
        return torch.zeros(shape, dtype=dtype, device=q.device)
    q, scales = q.contiguous(), scales.contiguous()
    out = torch.empty((n,), dtype=torch.float32, device=q.device)
    if n:
        rc = _fns()[1](q.data_ptr(), scales.data_ptr(), out.data_ptr(), n,
                       block, torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(rc, "dequant")
        _build.LAUNCHES["dequant"] += 1
    return out.reshape(shape).to(dtype)
