"""Int8 gradient compression with error feedback: the port of
``repro/optim/compress.py``, over a ``torch.distributed`` group.

``compressed_psum`` averages each rank's gradients over a data-parallel
group through an int8 payload: the ranks agree on a shared scale per block
of ``BLOCK`` elements (an all-reduce MAX of each block's local absmax, one
float32 a block), quantize locally (round half to even, as ``jnp.round``
and ``torch.round`` both do), all-reduce the payload as int32 (no overflow
below 2^24 ranks) and dequantize with the shared scale.  Each rank's
quantization residual goes to its error-feedback buffer and is added to
its next gradient, so the bias vanishes over steps; it is rounded to
float32 once, as the JAX package's fused ``blocks - q * scale`` is on
XLA.  Every leaf is padded to whole blocks on its own, as there; the
leaves' blocks then travel in one buffer, so a call makes two collectives
whatever the tree.  Divisors are
0-d tensors: PyTorch on CUDA divides by a Python number through its
reciprocal, which can miss the quotient by an ulp.

Wire bytes: about 1.0005 a gradient element (int8 plus one float32 scale
per 8192) against 4 for float32 (``wire_bytes_per_element``); the payload
is summed as int32, so on the wire of an all-reduce it is 4 bytes an
element unless the collective reduces int8 lanes into wider sums itself.
As in the JAX package, a library function: no step calls it.
"""
from __future__ import annotations

from typing import Any, List, Tuple

import torch
import torch.distributed as dist

from repro_torch.launch.collectives import all_reduce
from repro_torch.tree import tree_flatten, tree_map

BLOCK = 8192
INT8_MAX = 127.0


def _blocks(g: torch.Tensor, err: torch.Tensor) -> torch.Tensor:
    """A leaf's float32 values plus its error buffer, zero-padded to whole
    blocks, as (nb, BLOCK)."""
    flat = g.float().reshape(-1) + err
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, BLOCK)


def shared_scale(absmax: torch.Tensor) -> torch.Tensor:
    """Each block's scale from its (group-wide) absmax: absmax / 127, or 1
    for a block of zeros."""
    div = torch.tensor(INT8_MAX, dtype=torch.float32, device=absmax.device)
    return torch.where(absmax > 0, absmax / div, torch.ones_like(absmax))


def quantize(blocks: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The int8 payload of (nb, BLOCK) float32 blocks at their scales."""
    return torch.clamp(torch.round(blocks / scale[:, None]),
                       -INT8_MAX, INT8_MAX).to(torch.int8)


def compressed_psum(grads, err_state, group=None) -> Tuple[Any, Any]:
    """Error-feedback int8 mean of ``grads`` over the ranks of ``group``
    (the default group if None).  ``err_state``: one flat float32 buffer
    per leaf (``init_error_state``).  Returns (mean grads in each leaf's
    dtype and shape, new error state); every rank gets the same mean."""
    group = dist.group.WORLD if group is None else group
    n_dev = dist.get_world_size(group)
    flat_g, treedef = tree_flatten(grads)
    flat_e = tree_flatten(err_state)[0]
    if len(flat_e) != len(flat_g):
        raise ValueError("err_state must hold one buffer per gradient leaf")
    parts: List[torch.Tensor] = [_blocks(g, e) for g, e in zip(flat_g, flat_e)]
    blocks = torch.cat(parts) if len(parts) > 1 else parts[0]
    absmax = blocks.abs().amax(dim=1)
    all_reduce(absmax, group, "max")
    scale = shared_scale(absmax)
    q = quantize(blocks, scale)
    # the residual rounded once, as XLA's fused multiply-add rounds it: the
    # product of an int8 and a float32 is exact in float64, and so is its
    # difference from a value within half a step of it
    residual = (blocks.double() - q.double() * scale.double()[:, None]).float()
    qs = q.to(torch.int32)
    all_reduce(qs, group)
    ranks = torch.tensor(float(n_dev), dtype=torch.float32,
                         device=blocks.device)
    mean = qs.float() * scale[:, None] / ranks
    new_g, new_e = [], []
    at = 0
    for g, part in zip(flat_g, parts):
        nb, n = part.shape[0], g.numel()
        new_g.append(mean[at:at + nb].reshape(-1)[:n].reshape(g.shape)
                     .to(g.dtype))
        new_e.append(residual[at:at + nb].reshape(-1)[:n])
        at += nb
    return treedef.unflatten(new_g), treedef.unflatten(new_e)


def init_error_state(params):
    """A zero float32 error buffer, flat, for each leaf of ``params``."""
    return tree_map(lambda a: torch.zeros((a.numel(),), dtype=torch.float32,
                                          device=a.device), params)


def wire_bytes_per_element() -> float:
    """Bytes on the wire per gradient element (vs 4.0 uncompressed)."""
    return 1.0 + 4.0 / BLOCK
