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

The CUDA kernel (``csrc/decode_attention.cu``) is split-KV: ``split_plan``
cuts the cache's capacity S into chunks, one CTA per (chunk, kv head, batch
row) writes an f32 partial (m, l, acc) over the live rows of its chunk into
scratch that the wrapper allocates, and a combine pass merges the partials
in a fixed order.  The grid depends on S and hd only, never on the values of
``kv_len``, which the wrapper does not read on the host.  It is bound by the
bytes of the cache it reads (the source note gives the numbers).
``kernels/ops.py`` takes the plain version only for tensors on the CPU;
``chip_smoke.py`` holds the kernel against it on the card.

``return_lse=True`` is the partial mode, for a cache whose rows are cut over
several ranks (``models/layers.py``'s decode on a sequence shard): the same
first pass, and a combine that writes the output in float32, not rounded to
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
CHUNK_ELEMS = 16384             # cache elements a CTA reads from K (and V)
CHUNK_MIN, CHUNK_MAX = 128, 512  # its rows: 128 at hd 128, 512 at hd 32


def split_plan(S: int, hd: int) -> Tuple[int, int]:
    """(chunk, n_splits): the cache rows each CTA of the kernel's first pass
    takes, and the number of such chunks that cover rows [0, S).  A function
    of the cache's shape only, so the grid never depends on ``kv_len``."""
    chunk = min(CHUNK_MAX, max(CHUNK_MIN, CHUNK_ELEMS // hd))
    return chunk, max(1, -(-S // chunk))


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
    fn = getattr(_build.library("decode_attention"), entry)
    fn.argtypes = [ctypes.c_void_p] * (4 + n_out) + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _fn():
    return _bind("decode_attention_fwd", 2)       # o, part


@functools.cache
def _fn_lse():
    return _bind("decode_attention_lse_fwd", 3)   # o, lse, part


def decode_attention_cuda(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                          kv_len: torch.Tensor,
                          logit_softcap: float = 0.0, return_lse: bool = False):
    """Launch the CUDA kernel on PyTorch's current stream.  Same contract as
    the plain version; at most ``MAX_GROUP`` query heads per kv head."""
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
    chunk, n_splits = split_plan(S, hd)
    part = torch.empty(B * H * n_splits * (hd + 2), dtype=torch.float32,
                       device=q.device)
    rc = fn()(q.data_ptr(), ck.data_ptr(), cv.data_ptr(), kv_len.data_ptr(),
              *outs, part.data_ptr(), B, S, H, KV, hd, chunk, n_splits,
              DTYPE_CODES[q.dtype], 1.0 / math.sqrt(hd), float(logit_softcap),
              torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, name)
    _build.LAUNCHES[name] += 1
    return (out, lse) if return_lse else out
