"""Step builders (``repro/launch/steps.py``): the train step, prefill and
decode_step as plain functions on one device.

The JAX package builds jitted steps with shardings over a mesh; the port
runs eagerly on one card, so a builder returns the function itself.  The
mesh, the sharding rules and int8 gradient compression around an
all-reduce wait for ROADMAP A9b.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamW
from repro_torch.tree import tree_flatten, tree_map


def value_and_grad(cfg: ModelConfig, params, batch):
    """(loss, grads) of ``loss_fn`` at ``params``: each gradient in its
    parameter's dtype, zeros for a parameter the loss does not read (as
    ``jax.grad`` gives)."""
    leaves, treedef = tree_flatten(params)
    xs = [leaf.detach().requires_grad_(True) for leaf in leaves]
    loss = T.loss_fn(cfg, treedef.unflatten(xs), batch)
    grads = torch.autograd.grad(loss, xs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(xs, grads)]
    return loss.detach(), treedef.unflatten(grads)


def build_train_step(cfg: ModelConfig, shape: InputShape, *,
                     opt: Optional[AdamW] = None,
                     grad_accum: int = 1) -> Callable:
    """train_step(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm", "lr"}): one ``value_and_grad`` of the loss, then
    ``opt.update``.  With ``grad_accum`` > 1 the batch splits on its leading
    axis into that many micro-batches, run in order; their gradients are
    summed in float32 and, with the loss, divided by ``grad_accum``."""
    opt = opt or AdamW()
    if shape.global_batch % grad_accum:
        raise ValueError(f"batch {shape.global_batch} does not split into "
                         f"{grad_accum} micro-batches")

    def train_step(params, opt_state, batch):
        if grad_accum == 1:
            loss, grads = value_and_grad(cfg, params, batch)
        else:
            micro = {k: a.reshape((grad_accum, a.shape[0] // grad_accum)
                                  + tuple(a.shape[1:]))
                     for k, a in batch.items()}
            dev = next(iter(batch.values())).device
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = tree_map(lambda a: torch.zeros(
                a.shape, dtype=torch.float32, device=a.device), params)
            for i in range(grad_accum):
                li, gi = value_and_grad(cfg, params,
                                        {k: a[i] for k, a in micro.items()})
                loss = loss + li
                tree_map(lambda a, b: a.add_(b), grads, gi)   # b in f32
            # a tensor divisor: the card divides by a Python number through
            # its reciprocal
            n = torch.tensor(float(grad_accum), device=dev)
            loss = loss / n
            grads = tree_map(lambda g: g / n, grads)
        params, opt_state, metrics = opt.update(grads, opt_state, params)
        return params, opt_state, dict(metrics, loss=loss)

    return train_step


def build_prefill(cfg: ModelConfig, shape: InputShape, *,
                  max_len: Optional[int] = None) -> Callable:
    """prefill(params, batch) -> (last-position logits, decode caches of
    ``max_len`` rows, ``shape.seq_len`` by default)."""
    max_len = max_len or shape.seq_len

    def prefill(params, batch):
        return T.prefill(cfg, params, batch, max_len)

    return prefill


def build_decode_step(cfg: ModelConfig) -> Callable:
    """decode_step(params, caches, batch, cache_index) -> (logits (B, 1, V),
    or (B, 1, ncb, V) with codebooks, caches): one new token against the
    caches ``build_prefill`` made."""

    def decode_step(params, caches, batch, cache_index: int):
        return T.decode_step(cfg, params, caches, batch, cache_index)

    return decode_step
