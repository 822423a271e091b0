"""The shared layers the Swin slice needs (``repro/models/layers.py``).

Activations flow in float32; norm statistics are taken in float32.  The JAX
package's ``einsum32`` (an einsum with fp32 accumulation) is a plain fp32
``torch.matmul`` here: the package's fp32 policy keeps it off TF32.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Contract the last axis of ``x`` with the first of ``w`` (the JAX
    package's ``einsum32("...c,ck->...k")``), in float32."""
    return torch.matmul(x.float(), w.float())


def init_dense(generator: torch.Generator, shape: Sequence[int],
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal(0, scale^2) weights, ``scale`` = fan_in^-1/2 by default, drawn
    from ``generator`` on its device."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    if scale is None:
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    return torch.randn(tuple(shape), generator=generator,
                       dtype=torch.float32) * scale


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Biased variance and rsqrt, math in float32, as the JAX package."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)
