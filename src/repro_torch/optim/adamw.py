"""AdamW with a warmup-cosine schedule: ``repro/optim/adamw.py`` as plain
functions on tensor trees.

bf16 parameters with float32 first and second moments; the update is
computed in float32 and cast back to each parameter's dtype, with the JAX
package's arithmetic: a global-norm clip in float32, bias corrections and
the schedule computed in float32 on the parameters' device from the step
count (never in Python's float64), weight decay on the float32 parameter.
Every divisor is a tensor, so the card divides as the CPU does (PyTorch on
CUDA divides by a Python scalar through its reciprocal).  Parameters,
gradients and moments are trees of ``repro_torch.tree`` (dicts, lists,
tuples); ``AdamWState`` flattens as the JAX package's NamedTuple does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.tree import tree_flatten, tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor          # () int32
    m: Any
    v: Any


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    max_grad_norm: float = 1.0

    def schedule(self, step: torch.Tensor) -> torch.Tensor:
        """The learning rate at ``step`` (a tensor), float32: linear warmup
        to ``lr`` over ``warmup_steps``, then a cosine to ``min_lr_frac`` of
        it at ``total_steps``."""
        dev = step.device
        step = step.float()
        warm = torch.clamp(step / _f32(max(self.warmup_steps, 1), dev), max=1.0)
        prog = torch.clamp((step - self.warmup_steps)
                           / _f32(max(self.total_steps - self.warmup_steps, 1),
                                  dev), 0.0, 1.0)
        cos = self.min_lr_frac + (1 - self.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return self.lr * warm * cos

    def init(self, params) -> AdamWState:
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else torch.device("cpu")

        def zeros(p):
            return tree_map(lambda a: torch.zeros(a.shape, dtype=torch.float32,
                                                  device=a.device), p)
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          m=zeros(params), v=zeros(params))

    @staticmethod
    def global_norm(g32, model_sharded: Sequence[bool] = (),
                    group=None) -> torch.Tensor:
        """The float32 norm of a list of float32 gradients, as a whole.
        With ``group`` (a mesh's ``model`` group) the leaves flagged in
        ``model_sharded`` are this rank's shards: their squares are summed
        over the group, and every other leaf, whole on each rank, is
        counted once."""
        if group is None or not any(model_sharded):
            return torch.sqrt(sum(torch.sum(g * g) for g in g32))
        from repro_torch.launch.collectives import all_reduce
        sq = [torch.sum(g * g) for g in g32]
        mine = all_reduce(sum(q for q, s in zip(sq, model_sharded) if s),
                          group)
        return torch.sqrt(mine + sum(q for q, s in zip(sq, model_sharded)
                                     if not s))

    def update(self, grads, state: AdamWState, params,
               grad_norm: Optional[torch.Tensor] = None
               ) -> Tuple[Any, AdamWState, dict]:
        """One step: returns (new params, new state, {"grad_norm", "lr"}).
        ``grad_norm``: the gradient's global norm, for a caller that passes
        only its shards of the gradient (else computed from ``grads``)."""
        dev = state.step.device
        step = state.step + 1
        g32, treedef = tree_flatten(tree_map(lambda g: g.float(), grads))
        gnorm = self.global_norm(g32) if grad_norm is None else grad_norm
        scale = torch.clamp(_f32(self.max_grad_norm, dev) / (gnorm + 1e-9),
                            max=1.0)
        g32 = [g * scale for g in g32]
        m = [self.b1 * mm + (1 - self.b1) * g
             for mm, g in zip(tree_leaves(state.m), g32)]
        v = [self.b2 * vv + (1 - self.b2) * g * g
             for vv, g in zip(tree_leaves(state.v), g32)]
        bc1 = 1 - torch.pow(_f32(self.b1, dev), step.float())
        bc2 = 1 - torch.pow(_f32(self.b2, dev), step.float())
        lr = self.schedule(step)

        def upd(p, mm, vv):
            u = (mm / bc1) / (torch.sqrt(vv / bc2) + self.eps)
            u = u + self.weight_decay * p.float()
            return (p.float() - lr * u).to(p.dtype)

        new_params = treedef.unflatten(
            [upd(p, mm, vv) for p, mm, vv in zip(tree_leaves(params), m, v)])
        return new_params, AdamWState(step=step, m=treedef.unflatten(m),
                                      v=treedef.unflatten(v)), {
            "grad_norm": gnorm, "lr": lr}
