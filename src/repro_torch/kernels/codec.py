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
writes 1 B per element, decode the reverse.  Each CTA takes one block in
register-resident strips of rows with 16-byte loads or stores; the source
note has the design, and ``tests/test_torch_codec_strips.py`` mirrors its
decomposition on the CPU.
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
# the largest block the kernels are held to their plain versions at (larger
# blocks would run the same chunked body; none is checked, so none is taken)
MAX_CUDA_BLOCK = 48 * 1024


def _check_geometry(total: int, block: int) -> int:
    if block % LANES:
        raise ValueError(f"quant block must pack whole {LANES}-lane rows; got {block}")
    if total % block:
        raise ValueError(f"stream of {total} elements is not block-aligned ({block})")
    return total // block


def cost(total: int, block: int):
    """(flop, bytes) of B2 or B3 over a stream of ``total`` f32: bound by
    bytes, 4 B and 1 B an element and 4 B a block's scale (no flop
    counted)."""
    return 0, 5 * total + 4 * (total // block)


def codec_encode_meta(flat, block, delta):
    """Shapes alone (meta tensors): the stream and scales, empty."""
    nb = _check_geometry(flat.shape[0], block)
    dt = torch.uint8 if delta else torch.int8
    return (torch.empty(flat.shape, dtype=dt, device=flat.device),
            torch.empty((nb,), dtype=torch.float32, device=flat.device))


def codec_decode_meta(stream, scales, block, delta):
    return torch.empty(stream.shape, dtype=torch.float32, device=stream.device)


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


def codec_edge_blocks(block: int) -> np.ndarray:
    """(8, block) f32, one quantisation block per row, each probing an edge
    of the codec: scaled normals; all zero (scale 1.0); exact half-step ties
    (absmax 127 gives a scale of exactly 1.0, so x / scale is k + 0.5 and
    rounds half to even); values at +-absmax with uniform ones between;
    subnormals and -0.0 in a block of normal scale; rows alternating +-127
    (deltas 254 and 2); a single nonzero value; a block whose scale is
    subnormal (absmax 1e-38: IEEE in the plain versions and the kernels; the
    JAX package on the CPU flushes it to 0).  The cases the kernels and their
    CPU mirror are checked on; made with numpy from a fixed seed."""
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(8, block)) * 9).astype(np.float32)
    x[1] = 0.0
    x[2] = rng.integers(-127, 127, size=block) + 0.5
    x[2, 0] = 127.0
    a = np.float32(3.7)
    x[3] = rng.uniform(-a, a, size=block)
    x[3, ::3], x[3, 1::3] = a, -a
    x[4, ::2] = rng.choice(np.array([1e-39, -2e-40, 1.4e-45, -1e-38, -0.0],
                                    np.float32), size=block // 2)
    rows = x[5].reshape(-1, LANES)
    rows[0::2], rows[1::2] = 127.0, -127.0
    x[6] = 0.0
    x[6, block // 2] = -3.0
    x[7] = rng.uniform(-1e-38, 1e-38, size=block).astype(np.float32)
    x[7, 1] = 1e-38
    return x


@functools.cache
def _fns():
    lib = _build.library("codec")
    enc, dec = lib.codec_encode_f32, lib.codec_decode_f32
    for fn in (enc, dec):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return enc, dec


def codec_encode_cuda(flat: torch.Tensor, block: int,
                      delta: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the encode kernel on PyTorch's current stream."""
    _build.check_operands("codec_encode_cuda", flat)
    if flat.dtype != torch.float32 or flat.dim() != 1:
        raise TypeError("codec_encode_cuda takes a flat float32 stream")
    if block > MAX_CUDA_BLOCK:
        raise ValueError(f"quant block {block} exceeds {MAX_CUDA_BLOCK}")
    total = flat.shape[0]
    nb = _check_geometry(total, block)
    if flat.data_ptr() % 16 or not flat.is_contiguous():
        # the kernel reads 16-byte vectors: a view that starts inside one,
        # or a strided one, is copied
        flat = flat.clone(memory_format=torch.contiguous_format)
    stream = torch.empty((total,), dtype=torch.uint8 if delta else torch.int8,
                         device=flat.device)
    scales = torch.empty((nb,), dtype=torch.float32, device=flat.device)
    if nb == 0:
        return stream, scales
    rc = _fns()[0](flat.data_ptr(), stream.data_ptr(), scales.data_ptr(), nb,
                   block, int(delta), _build.current_stream(flat.device))
    _build.check(rc, "codec_encode")
    _build.LAUNCHES["codec_encode"] += 1
    return stream, scales


def codec_decode_cuda(stream: torch.Tensor, scales: torch.Tensor, block: int,
                      delta: bool) -> torch.Tensor:
    """Launch the decode kernel on PyTorch's current stream."""
    _build.check_operands("codec_decode_cuda", stream, scales)
    if stream.dtype not in (torch.int8, torch.uint8) or stream.dim() != 1:
        raise TypeError("codec_decode_cuda takes a flat int8/uint8 stream")
    if scales.dtype != torch.float32:
        raise TypeError("codec_decode_cuda takes float32 scales")
    if block > MAX_CUDA_BLOCK:
        raise ValueError(f"quant block {block} exceeds {MAX_CUDA_BLOCK}")
    nb = scales.shape[0]
    if _check_geometry(stream.shape[0], block) != nb:
        raise ValueError(f"{stream.shape[0]} stream bytes do not match {nb} scales")
    if stream.data_ptr() % 4 or not stream.is_contiguous():
        # the kernel reads the bytes as 32-bit words
        stream = stream.clone(memory_format=torch.contiguous_format)
    if not scales.is_contiguous():
        scales = scales.contiguous()
    out = torch.empty(stream.shape, dtype=torch.float32, device=stream.device)
    if nb == 0:
        return out
    rc = _fns()[1](stream.data_ptr(), scales.data_ptr(), out.data_ptr(), nb,
                   block, int(delta), _build.current_stream(stream.device))
    _build.check(rc, "codec_decode")
    _build.LAUNCHES["codec_decode"] += 1
    return out
