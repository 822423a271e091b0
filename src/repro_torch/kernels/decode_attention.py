"""Flash decode (one new token against a KV cache): the CUDA kernel's wrapper
and its plain version.

Replaces the TPU kernel ``repro/kernels/decode_attention.py ::
decode_attention_pallas``.  For each batch row b, query heads
n G .. n G + G - 1 (G = H // KV) of q (B, 1, H, hd) attend to the first
``kv_len[b]`` rows of kv head n; f32 softmax, output in q's dtype.  A row
with ``kv_len = 0`` gives zeros, as the TPU kernel's ``acc / max(l, 1e-30)``
does.  A logit soft-cap c > 0 replaces each scaled logit s by tanh(s / c) c,
as the JAX package's ``cache_attention`` does (the Pallas kernel has none).

Both versions here take the cache KV-major, (B, KV, S, hd), the layout the
LM keeps (``models/transformer.py::block_cache_init``), so the decode path
never transposes it; ``kernels/ops.py::decode_attention`` keeps the TPU
wrapper's (B, S, KV, hd) signature and transposes as that wrapper does.

The CUDA kernel (``csrc/decode_attention.cu``) runs in one launch: a
thread-block cluster of C CTAs per (batch row, kv head), whose ranks take
the cache's sub-tiles of T rows round-robin, stream their K and V rows
through a ring of bulk asynchronous copies, keep a running softmax over
them, and combine their partials in distributed shared memory in rank
order.  ``cluster_plan`` gives (C, T) from the shapes and the card's SMs,
never from the values of ``kv_len``, which the wrapper does not read on the
host.  It is bound by the bytes of the cache it reads (the source note
gives the numbers).  ``kernels/ops.py`` takes the plain version only for tensors on
the CPU; ``chip_smoke.py`` holds the kernel against it on the card.

``return_lse=True`` is the partial mode, for a cache whose rows are cut over
several ranks (``models/layers.py``'s decode on a sequence shard): the same
launch, whose combine writes the output in float32, not rounded to
q's dtype, beside each row's log-sum-exp ``lse`` (B, H) float32, m + log l of
the scaled (capped) logits over the live rows.  A row with ``kv_len = 0``
gives out = 0 and lse = -inf, so a rank whose rows hold no live key yet
weighs nothing when ``launch/collectives.py::combine_partials`` merges the
ranks' outputs and rounds them once.  It counts as
``decode_attention_lse`` in ``ops.LAUNCHES`` and ``ops.COSTS``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (DTYPE_CODES,
                                                 check_attention_operands,
                                                 check_softcap, softcap)

MAX_GROUP = 16                  # query heads per kv head the kernel takes
MAX_CLUSTER = 16                # CTAs a (batch row, kv head) at most
# The source's constants the plan takes (its decode_attention_geometry
# gives them; the wrapper raises if a built library's differ), here so that
# the plan runs without a build
SUBTILE_BYTES = 8192            # a sub-tile's K rows: kSubTileBytes
CTAS_PER_SM = 3                 # the launch bounds' CTAs an SM: kCtasPerSm
SMS = 132                       # an H100 SXM's SMs, where no card is asked


@functools.cache
def cluster_plan(B: int, KV: int, S: int, hd: int, esize: int,
                 sms: int = SMS, subtile_bytes: int = SUBTILE_BYTES,
                 ctas_per_sm: int = CTAS_PER_SM) -> Tuple[int, int]:
    """(C, T): the CTAs of the kernel's cluster for each (batch row, kv
    head), and the cache rows of a sub-tile (``subtile_bytes`` of K at
    ``esize`` bytes an element).  Rank r of a cluster takes sub-tiles r,
    r + C, r + 2C, ... of rows [0, S).  C is the largest power of two up to
    ``MAX_CLUSTER`` that keeps the grid's B KV C CTAs within
    ``ctas_per_sm`` on each of the card's ``sms`` SMs, and no larger than
    the sub-tiles.  A function of the shapes and the card only, so the grid
    never depends on ``kv_len``."""
    T = subtile_bytes // (hd * esize)
    subtiles = max(1, -(-S // T))
    C = 1
    while (2 * C <= min(MAX_CLUSTER, subtiles)
           and B * KV * 2 * C <= ctas_per_sm * sms):
        C *= 2
    return C, T


def library_geometry(lib) -> Tuple[int, int]:
    """(sub-tile bytes, CTAs an SM) of a built B6 library, as its source
    fixes them."""
    sub, per_sm = ctypes.c_int(), ctypes.c_int()
    lib.decode_attention_geometry(ctypes.byref(sub), ctypes.byref(per_sm))
    return sub.value, per_sm.value


@functools.cache
def _sms(device: torch.device) -> int:
    """The SMs of a card (``SMS`` for a device that is not one)."""
    if device.type != "cuda":
        return SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def cost(q_shape, cache_shape, esize: int, rows=None, return_lse=False):
    """(flop, bytes) of B6 over ``rows`` live cache rows of every batch row
    (the cache's capacity if unknown), or over a sequence of each batch
    row's: 4 hd flop a row and query head; the live K and V rows, q and the
    output (float32, and the float32 lse, in the partial mode), and kv_len
    moved once."""
    B, _, H, hd = q_shape
    KV, S = cache_shape[1], cache_shape[2]
    rows = S if rows is None else rows
    total = sum(rows) if hasattr(rows, "__len__") else B * rows
    flop = 4 * H * total * hd
    out = 4 * B * H * (hd + 1) if return_lse else esize * B * H * hd
    return flop, esize * (2 * KV * total * hd + B * H * hd) + out + 4 * B


def decode_attention_meta(q, ck, cv, kv_len, logit_softcap=0.0,
                          return_lse=False):
    """Shapes alone (meta tensors): the output (and lse), empty."""
    if return_lse:
        B, _, H, _ = q.shape
        return (torch.empty(q.shape, dtype=torch.float32, device=q.device),
                torch.empty((B, H), dtype=torch.float32, device=q.device))
    return torch.empty_like(q)


def decode_attention_plain(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                           kv_len: torch.Tensor,
                           logit_softcap: float = 0.0, return_lse: bool = False):
    """q (B, 1, H, hd); ck, cv (B, KV, S, hd); kv_len (B,) -> (B, 1, H, hd)
    in q's dtype: the masked softmax over the live rows, zeros where
    ``kv_len`` is 0.  With ``return_lse`` (out in float32, lse (B, H)
    float32, -inf where ``kv_len`` is 0)."""
    check_softcap(logit_softcap)
    B, _, H, hd = q.shape
    KV, S = ck.shape[1], ck.shape[2]
    qg = q.float().reshape(B, KV, H // KV, hd)
    logits = softcap(torch.einsum("bngd,bnkd->bngk", qg, ck.float())
                     / math.sqrt(hd), logit_softcap)
    live = (torch.arange(S, device=q.device)[None, :]
            < kv_len.to(q.device)[:, None])[:, None, None, :]     # (B, 1, 1, S)
    logits = logits.masked_fill(~live, -torch.inf)
    m = logits.amax(dim=-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(logits - m)
    out = torch.einsum("bngk,bnkd->bngd", p, cv.float())
    l = p.sum(dim=-1, keepdim=True)
    out = out / l.clamp_min(1e-30)
    if return_lse:
        lse = torch.where(l > 0, m + torch.log(l), -torch.inf)
        return out.reshape(B, 1, H, hd), lse.reshape(B, H)
    return out.reshape(B, 1, H, hd).to(q.dtype)


def _bind(entry: str, n_out: int):
    lib = _build.library("decode_attention")
    if library_geometry(lib) != (SUBTILE_BYTES, CTAS_PER_SM):
        raise RuntimeError(f"decode_attention.cu fixes (sub-tile bytes, CTAs "
                           f"an SM) {library_geometry(lib)}; the plan here "
                           f"takes {(SUBTILE_BYTES, CTAS_PER_SM)}")
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * (4 + n_out) + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _fn():
    return _bind("decode_attention_fwd", 1)       # o


@functools.cache
def _fn_lse():
    return _bind("decode_attention_lse_fwd", 2)   # o, lse


def decode_attention_cuda(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                          kv_len: torch.Tensor,
                          logit_softcap: float = 0.0, return_lse: bool = False):
    """Launch the CUDA kernel on PyTorch's current stream.  Same contract as
    the plain version; at most ``MAX_GROUP`` query heads per kv head, and q,
    ck and cv 16-byte aligned (the bulk copies need it)."""
    _build.check_operands("decode_attention_cuda", q, ck, cv, kv_len)
    check_softcap(logit_softcap)
    q, ck, cv = q.contiguous(), ck.contiguous(), cv.contiguous()
    check_attention_operands("decode_attention_cuda", q, ck, cv)
    B, _, H, hd = q.shape
    KV, S = ck.shape[1], ck.shape[2]
    if tuple(q.shape) != (B, 1, H, hd) or tuple(ck.shape) != (B, KV, S, hd) \
            or cv.shape != ck.shape:
        raise ValueError("decode_attention_cuda takes q (B, 1, H, hd) and a "
                         f"KV-major cache (B, KV, S, hd); got {tuple(q.shape)}, "
                         f"{tuple(ck.shape)}, {tuple(cv.shape)}")
    if KV == 0 or H % KV or H // KV > MAX_GROUP:
        raise ValueError(f"{H} query heads over {KV} kv heads: the kernel takes "
                         f"whole groups of at most {MAX_GROUP}")
    if kv_len.dtype != torch.int32 or tuple(kv_len.shape) != (B,):
        raise TypeError("kv_len must be (B,) int32")
    kv_len = kv_len.contiguous()
    if return_lse:
        out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.empty((B, H), dtype=torch.float32, device=q.device)
        fn, outs, name = _fn_lse, (out.data_ptr(), lse.data_ptr()), \
            "decode_attention_lse"
    else:
        out = torch.empty_like(q)
        fn, outs, name = _fn, (out.data_ptr(),), "decode_attention"
    if B == 0:
        return (out, lse) if return_lse else out
    cluster, _ = cluster_plan(B, KV, S, hd, q.element_size(),
                              _sms(q.device))
    rc = fn()(q.data_ptr(), ck.data_ptr(), cv.data_ptr(), kv_len.data_ptr(),
              *outs, B, S, H, KV, hd, cluster, DTYPE_CODES[q.dtype],
              1.0 / math.sqrt(hd), float(logit_softcap),
              _build.current_stream(q.device))
    _build.check(rc, name)
    _build.LAUNCHES[name] += 1
    return (out, lse) if return_lse else out
