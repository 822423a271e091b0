"""Fused activation codec: the CUDA kernels' wrappers and their plain versions.

Replaces the TPU kernel pair ``repro/kernels/codec.py ::
codec_encode_pallas`` / ``codec_decode_pallas``.  For each block of
``block`` f32 values (8192 = 64 rows of 128 lanes by default):

  encode: ``scale = absmax * f32(1/127)`` (1.0 for an all-zero block),
          ``q = clip(round_half_even(x / scale), -127, 127)``; with
          ``delta`` each 128-wide row minus the row above, mod 256, as
          uint8 (row 0 absolute), else int8.
  decode: the inverse: an int32 running sum down the rows mod 256 (delta
          only), values above 127 folded back to negative, times the scale.

Both are integer-exact, so the kernels (``csrc/codec.cu``), the plain
versions below and the JAX reference agree bitwise: ``torch.round`` rounds
half to even, ``/`` is IEEE on both devices, and the scale is the same f32
product.  On the H100 both kernels are bound by bytes: encode reads 4 B and
writes 1 B per element, decode the reverse (the source note has the design).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

LANES = 128
INT8_MAX = 127.0
INV_INT8_MAX = float(np.float32(1.0) / np.float32(INT8_MAX))
MAX_CUDA_BLOCK = 48 * 1024          # the encode kernel stages one block in shared memory


def _check_geometry(total: int, block: int) -> int:
    if block % LANES:
        raise ValueError(f"quant block must pack whole {LANES}-lane rows; got {block}")
    if total % block:
        raise ValueError(f"stream of {total} elements is not block-aligned ({block})")
    return total // block


def codec_encode_plain(flat: torch.Tensor, block: int,
                       delta: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """flat (total,) f32 with total % block == 0 -> (stream (total,) uint8 if
    delta else int8, scales (nb,) f32)."""
    nb = _check_geometry(flat.shape[0], block)
    x = flat.float().reshape(nb, block)
    absmax = x.abs().amax(dim=1) if nb else x.new_zeros((0,))
    inv = torch.tensor(INV_INT8_MAX, dtype=torch.float32, device=x.device)
    scale = torch.where(absmax > 0, absmax * inv, torch.ones_like(absmax))
    q = torch.clamp(torch.round(x / scale[:, None]), -INT8_MAX, INT8_MAX)
    q = q.to(torch.int32)
    if not delta:
        return q.to(torch.int8).reshape(-1), scale
    q = q.reshape(nb, block // LANES, LANES)
    prev = torch.zeros_like(q)
    prev[:, 1:] = q[:, :-1]
    return ((q - prev) & 0xFF).to(torch.uint8).reshape(-1), scale


def codec_decode_plain(stream: torch.Tensor, scales: torch.Tensor, block: int,
                       delta: bool) -> torch.Tensor:
    """Inverse of ``codec_encode_plain``: (total,) f32."""
    nb = scales.shape[0]
    q = stream.reshape(nb, block // LANES, LANES)
    if delta:
        acc = torch.cumsum(q.to(torch.int32), dim=1) & 0xFF
        q = acc - torch.where(acc > 127, 256, 0)
    else:
        q = q.view(torch.int8)
    return (q.to(torch.float32) * scales.float()[:, None, None]).reshape(-1)


@functools.cache
def _fns():
    lib = _build.library("codec")
    enc, dec = lib.codec_encode_f32, lib.codec_decode_f32
    for fn in (enc, dec):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return enc, dec


def _check_cuda(*tensors: torch.Tensor) -> None:
    if any(t.device.type != "cuda" or t.device != tensors[0].device
           for t in tensors):
        raise ValueError("codec kernels: every operand must lie on the same "
                         "CUDA device")


def codec_encode_cuda(flat: torch.Tensor, block: int,
                      delta: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the encode kernel on PyTorch's current stream."""
    _check_cuda(flat)
    if flat.dtype != torch.float32 or flat.dim() != 1:
        raise TypeError("codec_encode_cuda takes a flat float32 stream")
    if block > MAX_CUDA_BLOCK:
        raise ValueError(f"quant block {block} exceeds {MAX_CUDA_BLOCK}")
    nb = _check_geometry(flat.shape[0], block)
    flat = flat.contiguous()
    stream = torch.empty(flat.shape, dtype=torch.uint8 if delta else torch.int8,
                         device=flat.device)
    scales = torch.empty((nb,), dtype=torch.float32, device=flat.device)
    if nb == 0:
        return stream, scales
    rc = _fns()[0](flat.data_ptr(), stream.data_ptr(), scales.data_ptr(), nb,
                   block, int(delta),
                   torch.cuda.current_stream(flat.device).cuda_stream)
    _build.check(rc, "codec_encode")
    _build.LAUNCHES["codec_encode"] += 1
    return stream, scales


def codec_decode_cuda(stream: torch.Tensor, scales: torch.Tensor, block: int,
                      delta: bool) -> torch.Tensor:
    """Launch the decode kernel on PyTorch's current stream."""
    _check_cuda(stream, scales)
    if stream.dtype not in (torch.int8, torch.uint8) or stream.dim() != 1:
        raise TypeError("codec_decode_cuda takes a flat int8/uint8 stream")
    if scales.dtype != torch.float32:
        raise TypeError("codec_decode_cuda takes float32 scales")
    nb = scales.shape[0]
    if _check_geometry(stream.shape[0], block) != nb:
        raise ValueError(f"{stream.shape[0]} stream bytes do not match {nb} scales")
    stream, scales = stream.contiguous(), scales.contiguous()
    out = torch.empty(stream.shape, dtype=torch.float32, device=stream.device)
    if nb == 0:
        return out
    rc = _fns()[1](stream.data_ptr(), scales.data_ptr(), out.data_ptr(), nb,
                   block, int(delta),
                   torch.cuda.current_stream(stream.device).cuda_stream)
    _build.check(rc, "codec_decode")
    _build.LAUNCHES["codec_decode"] += 1
    return out
