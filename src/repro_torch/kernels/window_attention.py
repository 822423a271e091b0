"""Swin window attention: the CUDA kernels' wrappers and their plain versions.

Both kernels of ``csrc/window_attention.cu`` take f32 or bf16 q, k and v
and return their dtype; the logits, the softmax and P.V are f32 either
way, and a bf16 output is rounded once, at the store, as the TPU kernels
do.  Their products run on the H100's tensor cores.  An f32 product is
three TF32 products (3xTF32): each f32 operand is split into a TF32 ``hi``
and the TF32 rounding of ``x - hi``, and a.b is taken as lo.hi + hi.lo +
hi.hi, which keeps f32 parity where one TF32 product would not (the source
note gives the numbers; the CPU tests hold a mirror of this arithmetic
against the JAX package).  Padded query rows and keys live in shared
memory and registers only: padded keys score -inf and weigh exactly 0,
padded value rows are zero, padded query rows are never stored.  Bytes
bound both kernels on the H100 (each input element read once, each output
written once).

B1 at windows up to 8 (every configuration of the repo uses 7) runs a
persistent kernel built for Hopper: a CTA an SM walks (head, image,
window) tiles with the head slowest, a producer warp loads each tile's q,
k, v rows (one TMA box each where the window does not wrap, else 16-byte
cp.async pieces) and mask bytes into rings of stages ahead of consumer
warpgroups (2 in f32, 3 in bf16), each of which holds its head's bias in
shared memory and takes a tile's 64 query rows through both products on
``wgmma``: in f32 as 3xTF32 on K and V split in shared memory, in bf16 as
q.k^T of the bf16 values scaled afterwards and P.V as P_hi.V + P_lo.V.
Windows 9-12 and B7 run the earlier body, one CTA of four warps per
(window, head[, image]) on ``mma.sync`` m16n8k8 TF32 (a bf16 K or V value
is exact in TF32, so a bf16 call there takes two products, not three).

``fused_window_attention`` (B1) replaces the TPU kernel
``repro/kernels/window_attention.py :: fused_window_attention_pallas``: one
launch covers the cyclic shift by (-shift, -shift), the partition into
``window`` x ``window`` windows, ``softmax(q hd^-1/2 k^T + bias, mask ->
-1e9) v`` per window and head, the un-partition and the roll back.  The
kernel gathers its rows from the image-layout qkv with modular indices, one
per token.

``window_attention`` (B7) replaces ``window_attention_pallas`` behind the
JAX package's ``ops.window_attention``: the same attention on q, k, v
already partitioned into windows.  That op pads w2 to W2P = ceil(w2/64)*64
with keys every real query sees masked; on a row whose own keys are all
masked it therefore averages v over W2P rows, not w2.  The port pads
nothing in memory: the kernel and its plain version add ``(W2P - w2)
exp(-1e9 - max)`` to each row's softmax denominator, which is zero on every
row with an allowed key and gives the op's ``sum(v) / W2P`` on a row
without one.

The ``*_plain`` functions are the same functions in plain PyTorch, with the
roll and the partition written out.  ``kernels/ops.py`` takes them only for
tensors on the CPU; ``chip_smoke.py`` holds the kernels against them on the
card.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e9
# what csrc/window_attention.cu's bodies run, by route
BODY = ("B1 windows <= 8: persistent wgmma body (TMA or cp.async rows ahead "
        "of 2 (f32) or 3 (bf16) consumer warpgroups; f32 3xTF32 on m64nNk8, "
        "bf16 q.k^T then "
        "P_hi.V + P_lo.V on m64nNk16; f32 sums, softmax in registers); B1 "
        "windows 9-12 and B7: attend_warp on mma.sync.m16n8k8 TF32, 3xTF32 "
        "(bf16 K and V exact, hi.lo skipped); f32 or bf16 in and out")
# B1's windows on the wgmma body; 9-12 take attend_warp
WGMMA_MAX_WINDOW = 8
# B1: these head dims, f32 or bf16 qkv
SUPPORTED_HEAD_DIMS = (16, 32)
# B7: any w2 up to window 12, these head dims, f32 or bf16 q, k, v
WINDOW_MAX_W2 = 144
WINDOW_HEAD_DIMS = (16, 32, 64, 128)
# the dtype codes of both kernels' C entries
WINDOW_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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
def fused_cost(qkv_shape, esize: int, n_heads: int, window: int,
               masked: bool):
    """(flop, bytes) of B1: per window and head 4 w2^2 hd flop (Q.K^T,
    P.V) plus the softmax's 4 w2^2 and the normalisation's w2 hd; qkv read
    and the output written once (4C values a pixel), the f32 bias and the
    bool mask once."""
    B, Hp, Wp, C3 = qkv_shape
    C, w2 = C3 // 3, window * window
    nW = (Hp // window) * (Wp // window)
    hd = C // n_heads
    flop = B * nW * n_heads * (4 * w2 * w2 * hd + 4 * w2 * w2 + w2 * hd)
    nbytes = esize * B * Hp * Wp * 4 * C + 4 * n_heads * w2 * w2
    return flop, nbytes + (nW * w2 * w2 if masked else 0)


def windows_cost(q_shape, esize: int, masked: bool):
    """(flop, bytes) of B7: B1's counts on pre-partitioned windows; q, k,
    v read and the output written once, the f32 bias and the mask once."""
    nB, w2, nh, hd = q_shape
    flop = nB * nh * (4 * w2 * w2 * hd + 4 * w2 * w2 + w2 * hd)
    nbytes = esize * 4 * nB * w2 * nh * hd + 4 * nh * w2 * w2
    return flop, nbytes + (nB * w2 * w2 if masked else 0)


def fused_window_attention_meta(qkv, bias, mask, *, window, shift, n_heads):
    """Shapes alone (meta tensors): the output, empty."""
    B, Hp, Wp, C3 = qkv.shape
    return torch.empty((B, Hp, Wp, C3 // 3), dtype=qkv.dtype,
                       device=qkv.device)


def window_attention_meta(q, k, v, bias, mask=None):
    return torch.empty_like(q)


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where it is contiguous, else a contiguous copy."""
    return t if t.is_contiguous() else t.contiguous()


@functools.cache
def _fused_fn():
    fn = _build.library("window_attention").fused_window_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_window_attention_cuda(qkv: torch.Tensor, bias: torch.Tensor,
                                mask: Optional[torch.Tensor], *, window: int,
                                shift: int, n_heads: int) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream.  Same contract as
    the plain version: f32 or bf16 qkv (the output in its dtype), f32 bias,
    head dim 16 or 32, window up to 12."""
    B, Hp, Wp, C3 = qkv.shape
    C = C3 // 3
    w2 = window * window
    nW = (Hp // window) * (Wp // window)
    tensors = (qkv, bias) if mask is None else (qkv, bias, mask)
    _build.check_operands("fused_window_attention_cuda", *tensors)
    if qkv.dtype not in WINDOW_DTYPE_CODES or bias.dtype != torch.float32:
        raise TypeError("fused_window_attention_cuda takes float32 or bfloat16 "
                        f"qkv and a float32 bias; got {qkv.dtype}, {bias.dtype}")
    if C % n_heads or C // n_heads not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {C / n_heads} not in {SUPPORTED_HEAD_DIMS}")
    if Hp % window or Wp % window or not 0 <= shift < window:
        raise ValueError("Hp and Wp must be multiples of window, 0 <= shift < window")
    if w2 > WINDOW_MAX_W2:
        raise ValueError(f"w2 {w2} over the kernel's {WINDOW_MAX_W2} (window 12)")
    if bias.shape != (n_heads, w2, w2):
        raise ValueError(f"bias must be {(n_heads, w2, w2)}, got {tuple(bias.shape)}")
    if mask is not None and (mask.dtype != torch.bool
                             or mask.shape != (nW, w2, w2)):
        raise ValueError(f"mask must be bool {(nW, w2, w2)}")
    qkv, bias = _dense(qkv), _dense(bias)
    if mask is not None:
        mask = _dense(mask)
        if mask.data_ptr() % 16:
            # the kernel copies the mask in 16-byte pieces
            mask = mask.clone()
    out = torch.empty((B, Hp, Wp, C), dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    rc = _fused_fn()(qkv.data_ptr(), bias.data_ptr(),
                     None if mask is None else mask.data_ptr(), out.data_ptr(),
                     B, Hp, Wp, C, n_heads, window, shift,
                     WINDOW_DTYPE_CODES[qkv.dtype],
                     1.0 / math.sqrt(C // n_heads),
                     _build.current_stream(qkv.device))
    _build.check(rc, "fused_window_attention")
    _build.LAUNCHES["fused_window_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# B7: attention on pre-partitioned windows
# ---------------------------------------------------------------------------

def padded_keys(w2: int) -> int:
    """Keys the TPU op adds to a window: w2 up to the next multiple of 64."""
    return -(-w2 // 64) * 64 - w2


def _check_windows(what: str, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, bias: torch.Tensor,
                   mask: Optional[torch.Tensor]) -> None:
    """Raise on what B7 does not take, on either device."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{what}: q, k and v must be (nB, w2, nh, hd) of one "
                         f"shape; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    nB, w2, nh, hd = q.shape
    if q.dtype not in WINDOW_DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"{what} takes q, k and v of one dtype, float32 or "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not 1 <= w2 <= WINDOW_MAX_W2 or hd not in WINDOW_HEAD_DIMS:
        raise ValueError(f"{what}: w2 {w2} not in 1..{WINDOW_MAX_W2} or head "
                         f"dim {hd} not in {WINDOW_HEAD_DIMS}")
    if tuple(bias.shape) != (nh, w2, w2):
        raise ValueError(f"bias must be {(nh, w2, w2)}, got {tuple(bias.shape)}")
    if mask is not None and (mask.dtype != torch.bool
                             or tuple(mask.shape) != (nB, w2, w2)):
        raise ValueError(f"mask must be bool {(nB, w2, w2)}")


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor,
                           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v (nB, w2, nh, hd); bias (nh, w2, w2); mask (nB, w2, w2) bool
    (True = may attend) or None.  f32 inside; returns (nB, w2, nh, hd) in
    q's dtype, with the TPU op's padded keys in each denominator."""
    _check_windows("window_attention_plain", q, k, v, bias, mask)
    hd = q.shape[-1]
    qf = q.float().permute(0, 2, 1, 3) * (1.0 / math.sqrt(hd))  # (nB, nh, w2, hd)
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    s = torch.matmul(qf, kf.transpose(-1, -2)) + bias.float()[None]
    if mask is not None:
        s = s.masked_fill(~mask[:, None], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    denom = e.sum(dim=-1, keepdim=True)
    pad = padded_keys(q.shape[1])
    if pad:
        denom = denom + pad * torch.exp(NEG_INF - m)
    o = torch.matmul(e / denom, vf)                      # (nB, nh, w2, hd)
    return o.permute(0, 2, 1, 3).to(q.dtype)


@functools.cache
def _windows_fn():
    fn = _build.library("window_attention").window_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def window_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the B7 kernel on PyTorch's current stream.  Same contract as
    the plain version: w2 up to 144, head dim 16, 32, 64 or 128, f32 or
    bf16 q, k, v; the bias is read as f32."""
    tensors = (q, k, v, bias) if mask is None else (q, k, v, bias, mask)
    _build.check_operands("window_attention_cuda", *tensors)
    _check_windows("window_attention_cuda", q, k, v, bias, mask)
    nB, w2, nh, hd = q.shape
    q, k, v = _dense(q), _dense(k), _dense(v)
    bias = _dense(bias.float())
    mask = None if mask is None else _dense(mask)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    rc = _windows_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       bias.data_ptr(), None if mask is None else mask.data_ptr(),
                       out.data_ptr(), nB, w2, nh, hd, padded_keys(w2),
                       WINDOW_DTYPE_CODES[q.dtype], 1.0 / math.sqrt(hd),
                       _build.current_stream(q.device))
    _build.check(rc, "window_attention")
    _build.LAUNCHES["window_attention"] += 1
    return out
