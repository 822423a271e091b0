"""Causal GQA flash attention (prefill): the CUDA kernel's wrapper and its
plain version.

Replaces the TPU kernel ``repro/kernels/flash_attention.py ::
flash_attention_pallas``.  q (B, Sq, H, hd) attends to k, v (B, Skv, KV, hd):
query head h reads kv head h // (H // KV), query row i sits at position
i + Skv - Sq (q aligned to the end of kv), scores above the diagonal (with
``causal``) are masked to -1e30, the softmax runs in f32 and the output is
cast to q's dtype.  A sliding window w > 0 (with ``causal`` only) also masks
the keys at or below i - w, as the JAX package's ``plain_attention`` does
(``repro/models/layers.py``), where its windowed prefill runs: key j is
kept for query position i iff i - w < j <= i.  A logit soft-cap c > 0 (the
config's ``attn_logit_softcap``) replaces each scaled logit s = q.k /
sqrt(hd) by tanh(s / c) c before the masks, as ``plain_attention`` and
``flash_attention_xla`` do there.  The Pallas kernel takes neither window
nor cap; the port gives both to B5 so that every GQA prefill runs the
kernel.

The CUDA source (``csrc/flash_attention.cu``) runs one CTA per (q tile,
head, batch row) that walks the kv tiles up to the diagonal with an f32
online softmax; with a window it starts at the tile that holds its first
row's oldest live key, so its work is bounded by the window.  For bf16 both products run on the tensor cores (mma.sync,
f32 sums; P split into bf16 hi and lo parts, so P is never rounded to bf16
once) with K and V tiles copied asynchronously; f32 keeps both products in
f32 on the CUDA cores.  At the full-width prefill shape it is bound by
operations (the source note gives the numbers).

``flash_attention_plain`` is the same function as a dense masked softmax in
f32 (``repro/kernels/ref.py::flash_attention_ref``).  ``kernels/ops.py``
takes it only for tensors on the CPU; ``chip_smoke.py`` holds the kernel
against it on the card.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_window(causal: bool, sliding_window: int) -> None:
    if sliding_window < 0 or (sliding_window and not causal):
        raise ValueError(f"a sliding window ({sliding_window}) is >= 0 and "
                         "applies to causal attention only")


def check_softcap(logit_softcap: float) -> None:
    if not logit_softcap >= 0 or math.isinf(logit_softcap):
        raise ValueError(f"a logit soft-cap ({logit_softcap}) is 0 (none) or "
                         "a finite c > 0")


def softcap(logits: torch.Tensor, logit_softcap: float) -> torch.Tensor:
    """tanh(s / c) c, the JAX package's soft-cap, or s itself for c = 0."""
    if logit_softcap:
        return torch.tanh(logits / logit_softcap) * logit_softcap
    return logits


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, sliding_window: int = 0,
                          logit_softcap: float = 0.0) -> torch.Tensor:
    """q (B, Sq, H, hd); k, v (B, Skv, KV, hd) -> (B, Sq, H, hd) in q's dtype."""
    check_window(causal, sliding_window)
    check_softcap(logit_softcap)
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Sq, KV, H // KV, hd)
    logits = softcap(torch.einsum("bqngd,bknd->bngqk", qg, k.float())
                     / math.sqrt(hd), logit_softcap)
    if causal:
        q_pos = torch.arange(Sq, device=q.device) + (Skv - Sq)
        k_pos = torch.arange(Skv, device=q.device)
        dead = k_pos[None, :] > q_pos[:, None]
        if sliding_window:
            dead |= k_pos[None, :] <= q_pos[:, None] - sliding_window
        logits = logits.masked_fill(dead, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bngqk,bknd->bqngd", p, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


@functools.cache
def _fn():
    fn = _build.library("flash_attention").flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_attention_operands(what: str, q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor) -> None:
    """Raise on what the attention kernels do not take: one dtype of
    ``DTYPE_CODES``, a head dim of ``SUPPORTED_HEAD_DIMS`` and 16-byte
    aligned storage."""
    hd = q.shape[-1]
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what} takes q, k and v of one dtype, float32 or "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in SUPPORTED_HEAD_DIMS or k.shape[-1] != hd or v.shape[-1] != hd:
        raise ValueError(f"{what}: head dim {hd} not in {SUPPORTED_HEAD_DIMS}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{what} takes 16-byte aligned operands")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, sliding_window: int = 0,
                         logit_softcap: float = 0.0) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream.  Same contract as
    the plain version; with ``causal``, Sq <= Skv."""
    _build.check_operands("flash_attention_cuda", q, k, v)
    check_window(causal, sliding_window)
    check_softcap(logit_softcap)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    check_attention_operands("flash_attention_cuda", q, k, v)
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Skv, KV, hd) or v.shape != k.shape:
        raise ValueError(f"k and v must be (B, Skv, KV, hd) = {tuple(k.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads do not split into {KV} kv heads")
    if Skv == 0 or (causal and Sq > Skv):
        raise ValueError(f"attention needs 1 <= Skv and, causal, Sq <= Skv; "
                         f"got Sq {Sq}, Skv {Skv}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    rc = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               B, Sq, Skv, H, KV, hd, int(causal), int(sliding_window),
               float(logit_softcap), DTYPE_CODES[q.dtype],
               1.0 / math.sqrt(hd), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention")
    _build.LAUNCHES["flash_attention"] += 1
    return out
