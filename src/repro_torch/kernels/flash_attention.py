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
row's oldest live key, so its work is bounded by the window.  For bf16 the
kernel is built for Hopper (FA3's shape): a producer warpgroup issues TMA
loads of Q and of K and V tiles into mbarrier rings, and two consumer
warpgroups of 64 query rows each run both products as wgmma (f32 sums; P
split into bf16 hi and lo parts taken from registers, so P is never
rounded to bf16 once), taking turns so that one's softmax runs under the
other's products; the Hopper primitives are inline PTX in
``csrc/hopper.cuh``.  f32 keeps both products in f32 on the CUDA cores.
At the full-width prefill shape it is bound by operations (the source note
gives the numbers).

``flash_attention_plain`` is the same function as a dense masked softmax in
f32 (``repro/kernels/ref.py::flash_attention_ref``).  ``kernels/ops.py``
takes it only for tensors on the CPU; ``chip_smoke.py`` holds the kernel
against it on the card.

Training.  With ``with_lse`` both versions also return each row's
log-sum-exp of its scaled, capped and masked scores, (B, H, Sq) f32 in
natural units (the bf16 body converts its base-2 m + log2(l)); the kernel's
output is bitwise the same either way.  B5's backward
(``csrc/flash_attention_bwd.cu``: a pass for D = sum(dO o), a dK/dV kernel
and a dQ kernel, no atomics) and its plain version
``flash_attention_bwd_plain`` compute dq, dk, dv of the same function for
Sq = Skv; the Pallas kernel has no backward, and the JAX package takes this
gradient from XLA's autodiff of ``plain_attention`` and of
``models/attention_flash.py``.  For bf16 the dK/dV and dQ kernels are
built for Hopper as the forward is: a producer warpgroup issues TMA loads
(the CTA's 128 kv or q rows once, the streamed q or kv tiles into an
mbarrier ring) and two consumer warpgroups of 64 rows each run every
product as wgmma with f32 sums, with P and dS kept in registers and each
rounded to bf16 once where it enters a product; f32 keeps every product in
f32 on the CUDA cores.  ``FlashAttentionFn`` ties the two together for
autograd; ``ops.flash_attention`` calls it where a gradient is wanted.
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


def _logits(q: torch.Tensor, k: torch.Tensor, causal: bool,
            sliding_window: int, logit_softcap: float) -> torch.Tensor:
    """The scaled, capped and masked f32 scores (B, KV, G, Sq, Skv)."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Sq, KV, H // KV, hd)
    logits = softcap(torch.einsum("bqngd,bknd->bngqk", qg, k.float())
                     / math.sqrt(hd), logit_softcap)
    if causal:
        logits = logits.masked_fill(
            dead_pairs(Sq, Skv, sliding_window, q.device), NEG_INF)
    return logits


def dead_pairs(Sq: int, Skv: int, sliding_window: int,
               device) -> torch.Tensor:
    """(Sq, Skv) bool: the causal (and windowed) mask, True where masked."""
    q_pos = torch.arange(Sq, device=device) + (Skv - Sq)
    k_pos = torch.arange(Skv, device=device)
    dead = k_pos[None, :] > q_pos[:, None]
    if sliding_window:
        dead |= k_pos[None, :] <= q_pos[:, None] - sliding_window
    return dead


def _range_sum(a: int, b: int) -> int:
    return (a + b) * (b - a + 1) // 2 if b >= a else 0


def live_pairs(Sq: int, Skv: int, causal: bool = True,
               sliding_window: int = 0) -> int:
    """The (query, key) pairs one head attends: a query at position p (q
    aligned to the end of kv) sees p + 1 keys, at most w with a window."""
    if not causal:
        return Sq * Skv
    a, b, w = Skv - Sq + 1, Skv, sliding_window
    if not w:
        return _range_sum(a, b)
    return _range_sum(a, min(b, w)) + w * max(0, b - max(a, w + 1) + 1)


def forward_cost(q_shape, k_shape, esize: int, causal: bool = True,
                 sliding_window: int = 0, with_lse: bool = False):
    """(flop, bytes) of B5: 4 hd flop a live pair and head (Q.K^T, P.V);
    q, k, v read and the output written once (plus the log-sum-exp)."""
    B, Sq, H, hd = q_shape
    Skv, KV = k_shape[1], k_shape[2]
    flop = 4 * hd * B * H * live_pairs(Sq, Skv, causal, sliding_window)
    nbytes = esize * (2 * B * Sq * H * hd + 2 * B * Skv * KV * hd)
    return flop, nbytes + (4 * B * H * Sq if with_lse else 0)


def backward_cost(q_shape, k_shape, esize: int, causal: bool = True,
                  sliding_window: int = 0):
    """(flop, bytes) of B5's backward (its three kernels together): 10 hd
    flop a live pair and head (the recomputed S, dP, dV, dK, dQ); q, o,
    dO, k, v and the log-sum-exp read, dq, dk, dv written once."""
    B, S, H, hd = q_shape
    KV = k_shape[2]
    flop = 10 * hd * B * H * live_pairs(S, S, causal, sliding_window)
    nbytes = esize * (4 * B * S * H * hd + 4 * B * S * KV * hd)
    return flop, nbytes + 4 * B * H * S


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, sliding_window: int = 0,
                          logit_softcap: float = 0.0, with_lse: bool = False):
    """q (B, Sq, H, hd); k, v (B, Skv, KV, hd) -> (B, Sq, H, hd) in q's dtype;
    with ``with_lse`` also each row's log-sum-exp of its scaled, capped and
    masked scores, (B, H, Sq) f32 in natural units, as the kernel writes it
    for the backward."""
    check_window(causal, sliding_window)
    check_softcap(logit_softcap)
    B, Sq, H, hd = q.shape
    logits = _logits(q, k, causal, sliding_window, logit_softcap)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bngqk,bknd->bqngd", p, v.float())
    out = out.reshape(B, Sq, H, hd).to(q.dtype)
    if not with_lse:
        return out
    return out, torch.logsumexp(logits, dim=-1).reshape(B, H, Sq)


@functools.cache
def _fn():
    fn = _build.library("flash_attention").flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
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
                         logit_softcap: float = 0.0, with_lse: bool = False):
    """Launch the CUDA kernel on PyTorch's current stream.  Same contract as
    the plain version; with ``causal``, Sq <= Skv.  The output is bitwise
    the same with and without ``with_lse``."""
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
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    rc = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               None if lse is None else lse.data_ptr(), B, Sq, Skv, H, KV, hd, int(causal), int(sliding_window),
               float(logit_softcap), DTYPE_CODES[q.dtype],
               1.0 / math.sqrt(hd), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention")
    _build.LAUNCHES["flash_attention"] += 1
    return (out, lse) if with_lse else out


# ---------------------------------------------------------------------------
# the backward (``csrc/flash_attention_bwd.cu``) and autograd
# ---------------------------------------------------------------------------

def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, dout: torch.Tensor,
                              causal: bool = True, sliding_window: int = 0,
                              logit_softcap: float = 0.0):
    """(dq, dk, dv) of B5's function at (q, k, v), given its output ``o``,
    its log-sum-exp ``lse`` (B, H, S) and the output's gradient ``dout``, by
    the kernels' explicit formulas in f32: P = exp(S - LSE), D = sum(dO o),
    dV = P^T dO, dS = P (dO V^T - D) (times 1 - tanh^2(s / c) under a cap),
    dQ = dS K hd^-1/2, dK = dS^T Q hd^-1/2.  Sq = Skv; each gradient comes
    back in its input's dtype."""
    check_backward_shapes(q, k)
    check_window(causal, sliding_window)
    check_softcap(logit_softcap)
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qg = q.float().reshape(B, S, KV, G, hd)
    dog = dout.float().reshape(B, S, KV, G, hd)
    s = torch.einsum("bqngd,bknd->bngqk", qg, k.float()) * scale
    if logit_softcap:
        t = torch.tanh(s / logit_softcap)
        s = t * logit_softcap
    p = torch.exp(s - lse.reshape(B, KV, G, S, 1))
    if causal:
        p = p.masked_fill(dead_pairs(S, S, sliding_window, q.device), 0.0)
    delta = (dout.float() * o.float()).sum(-1)                  # (B, S, H)
    delta = delta.reshape(B, S, KV, G).permute(0, 2, 3, 1)[..., None]
    dv = torch.einsum("bngqk,bqngd->bknd", p, dog)
    ds = p * (torch.einsum("bqngd,bknd->bngqk", dog, v.float()) - delta)
    if logit_softcap:
        ds = ds * (1.0 - t * t)
    dq = torch.einsum("bngqk,bknd->bqngd", ds, k.float()) * scale
    dk = torch.einsum("bngqk,bqngd->bknd", ds, qg) * scale
    return (dq.reshape(B, S, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def check_backward_shapes(q: torch.Tensor, k: torch.Tensor) -> None:
    """The backward takes Sq = Skv only (training's shapes)."""
    if q.shape[1] != k.shape[1]:
        raise ValueError(f"B5's backward takes Sq = Skv; got Sq {q.shape[1]}, "
                         f"Skv {k.shape[1]}")


BWD_KERNELS = ("flash_attention_bwd_delta", "flash_attention_bwd_dkdv",
               "flash_attention_bwd_dq")


@functools.cache
def _bwd_fns():
    lib = _build.library("flash_attention_bwd")
    fns = []
    for name in BWD_KERNELS:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns.append((name, fn))
    return fns


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor,
                             causal: bool = True, sliding_window: int = 0,
                             logit_softcap: float = 0.0):
    """Launch the three backward kernels (D, then dK/dV, then dQ) on
    PyTorch's current stream.  Same contract as the plain version; each
    kernel counts its launches."""
    _build.check_operands("flash_attention_bwd_cuda", q, k, v, o, lse, dout)
    check_window(causal, sliding_window)
    check_softcap(logit_softcap)
    check_backward_shapes(q, k)
    q, k, v, o, dout = (t.contiguous() for t in (q, k, v, o, dout))
    check_attention_operands("flash_attention_bwd_cuda", q, k, v)
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if tuple(k.shape) != (B, S, KV, hd) or v.shape != k.shape:
        raise ValueError(f"k and v must be (B, S, KV, hd) = {tuple(k.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads do not split into {KV} kv heads")
    if (o.shape != q.shape or dout.shape != q.shape or o.dtype != q.dtype
            or dout.dtype != q.dtype):
        raise ValueError("o and dout must be q's shape and dtype")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be (B, H, S) = {(B, H, S)} float32")
    lse = lse.contiguous()
    if any(t.data_ptr() % 16 for t in (o, dout, lse)):
        raise ValueError("flash_attention_bwd_cuda takes 16-byte aligned "
                         "operands")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    for name, fn in _bwd_fns():
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S, H, KV, hd,
                int(causal), int(sliding_window), float(logit_softcap),
                DTYPE_CODES[q.dtype], 1.0 / math.sqrt(hd), stream)
        _build.check(rc, name)
        _build.LAUNCHES[name] += 1
    return dq, dk, dv


def flash_attention_meta(q, k, v, causal=True, sliding_window=0,
                         logit_softcap=0.0, with_lse=False):
    """Shapes alone (meta tensors): the outputs, empty."""
    out = torch.empty_like(q)
    if not with_lse:
        return out
    B, Sq, H, _ = q.shape
    return out, torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)


def flash_attention_bwd_meta(q, k, v, o, lse, dout, causal=True,
                             sliding_window=0, logit_softcap=0.0):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


FORWARD = {"cuda": flash_attention_cuda, "cpu": flash_attention_plain,
           "meta": flash_attention_meta}
BACKWARD = {"cuda": flash_attention_bwd_cuda, "cpu": flash_attention_bwd_plain,
            "meta": flash_attention_bwd_meta}


def forward(q, k, v, causal: bool = True, sliding_window: int = 0,
            logit_softcap: float = 0.0, with_lse: bool = False):
    """B5 on the route of q's device, its work counted in ``COSTS``."""
    _build.count("flash_attention", forward_cost(
        q.shape, k.shape, q.element_size(), causal, sliding_window, with_lse))
    return FORWARD[_build.route(q)](q, k, v, causal, sliding_window,
                                    logit_softcap, with_lse=with_lse)


def backward(q, k, v, o, lse, dout, causal: bool = True,
             sliding_window: int = 0, logit_softcap: float = 0.0):
    """B5's backward on the route of q's device, counted in ``COSTS``."""
    _build.count("flash_attention_bwd", backward_cost(
        q.shape, k.shape, q.element_size(), causal, sliding_window))
    return BACKWARD[_build.route(q)](q, k, v, o, lse, dout, causal,
                                     sliding_window, logit_softcap)


class FlashAttentionFn(torch.autograd.Function):
    """B5 with its gradient: the forward keeps its output and log-sum-exp,
    the backward runs ``flash_attention_bwd_*``.  Both go by the device:
    the kernels for CUDA tensors, the plain versions for CPU tensors,
    shapes alone on the meta device."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sliding_window: int,
                logit_softcap: float):
        out, lse = forward(q, k, v, causal, sliding_window, logit_softcap,
                           with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, sliding_window, logit_softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = backward(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None
