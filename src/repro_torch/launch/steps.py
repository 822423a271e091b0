"""Step builders (``repro/launch/steps.py``): the train step, prefill and
decode_step, on one device or data-parallel over a mesh.

Without a mesh a builder returns the step function itself, run eagerly on
the tensors' device.  With a mesh (``launch/mesh.py``) it returns a
``BuiltStep``: the same computation on each rank's rows of the batch, the
batch split over the mesh's batch axes as ``batch_shardings`` places it.
The parameters and AdamW's moments are ``DTensor``s in the placements the
rules give (FSDP: the "embed" dim over "data"; replicated with
``ShardingRules(fsdp=False)``); ``BuiltStep.place`` puts full trees there
and ``sharding.gather`` takes them back.  For the compute each rank
gathers the whole parameters into plain tensors (the hand-written kernels
take plain tensors, never a DTensor), so a gather on axes of size one is
no copy.  A train step then averages the loss and the float32 gradients
over the batch group (an all-reduce), clips by the norm of the whole
averaged gradient and lets AdamW update each rank's shards.

What a mesh does not do: a "model" axis over 1 (heads, MLP and vocab
split over ranks) would need the kernels run under ``local_map`` on their
shards; the builders raise ``ValueError`` for it.  On a 1 x 1 mesh every
placement is whole on its rank, and the step computes the mesh-free
step's numbers bit for bit.  Gradient compression
(``optim/compress.py``) is a library function here as in the JAX package,
wired into no step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch.mesh import batch_axes, batch_index, batch_ranks
from repro_torch.launch.sharding import (ShardingRules, batch_shardings,
                                         distribute, fit_pspec, gather, local,
                                         local_chunk,
                                         opt_state_shardings, param_shardings)
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.tree import tree_flatten, tree_map


def logits_pspec(mesh, cfg: ModelConfig, batch: int, seq: int = 1):
    """The logits' spec: rows over the batch axes, vocab over "model"."""
    ba = batch_axes(mesh)
    ba = ba[0] if len(ba) == 1 else ba
    if cfg.n_codebooks:
        return fit_pspec(mesh, (ba, None, None, "model"),
                         (batch, seq, cfg.n_codebooks, cfg.vocab_size))
    return fit_pspec(mesh, (ba, None, "model"), (batch, seq, cfg.vocab_size))


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


def _loss_and_grads(cfg: ModelConfig, params, batch, grad_accum: int):
    """The batch's mean loss and gradients: one ``value_and_grad``, or with
    ``grad_accum`` > 1 that many micro-batches (the leading axis split) run
    in order, their gradients summed in float32 and, with the loss, divided
    by ``grad_accum``."""
    if grad_accum == 1:
        return value_and_grad(cfg, params, batch)
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
    # a tensor divisor: the card divides by a Python number through its
    # reciprocal
    n = torch.tensor(float(grad_accum), device=dev)
    return loss / n, tree_map(lambda g: g / n, grads)


# ---------------------------------------------------------------------------
# steps over a mesh
# ---------------------------------------------------------------------------

def _check_mesh(mesh) -> None:
    if mesh.shape.get("model", 1) != 1:
        raise ValueError(
            f"a mesh with a model axis of {mesh.shape['model']}: the port "
            "runs data-parallel only (tensor parallelism over 'model' needs "
            "the kernels under local_map: ROADMAP.md, A9c)")


def _rows(mesh, batch, specs):
    """This rank's rows of each batch leaf that its spec splits."""
    r, n = batch_index(mesh)
    out = {}
    for k, a in batch.items():
        if specs[k] and specs[k][0] is not None:
            m = a.shape[0] // n
            a = a[r * m:(r + 1) * m]
        out[k] = a
    return out


def _gather_rows(mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``x``, in rank order (none to fetch from a
    batch group of one)."""
    n = batch_ranks(mesh)
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def _as_dtensors(local_tree, like_tree):
    from torch.distributed.tensor import DTensor
    return tree_map(lambda x, like: DTensor.from_local(
        x, like.device_mesh, like.placements, run_check=False,
        shape=like.shape, stride=like.stride()), local_tree, like_tree)


@dataclass
class BuiltStep:
    """A step over a mesh: ``fn`` with the specs of its placed arguments
    (``in_specs``, one per argument, None where it is not placed)."""
    fn: Callable
    mesh: Any
    in_specs: tuple

    def __call__(self, *args):
        return self.fn(*args)

    def place(self, *trees):
        """The full trees, each as DTensors in its argument's placements
        (one tree per placed argument, in order)."""
        specs = [s for s in self.in_specs if s is not None]
        out = tuple(distribute(t, s, self.mesh) for t, s in zip(trees, specs))
        return out[0] if len(out) == 1 else out


def _param_specs(cfg: ModelConfig, mesh, rules: ShardingRules):
    model = get_model(cfg, "cpu")
    return param_shardings(rules, model.spec(), model.abstract_params(), mesh)


def build_train_step(cfg: ModelConfig, shape: InputShape, *, mesh=None,
                     rules: Optional[ShardingRules] = None,
                     opt: Optional[AdamW] = None, grad_accum: int = 1):
    """train_step(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm", "lr"}): the loss and gradients of the batch (with
    ``grad_accum`` > 1 its leading axis split into that many micro-batches,
    run in order, their gradients summed in float32 and, with the loss,
    divided by ``grad_accum``), then ``opt.update``.

    With ``mesh`` a ``BuiltStep``: each rank takes its rows of the global
    batch, every rank's mean loss and float32 gradients are averaged over
    the batch group, AdamW clips by the averaged gradient's global norm and
    updates each rank's shards of the parameters and moments (DTensors in
    the ``rules``' placements, ``BuiltStep.place``)."""
    opt = opt or AdamW()
    if shape.global_batch % grad_accum:
        raise ValueError(f"batch {shape.global_batch} does not split into "
                         f"{grad_accum} micro-batches")
    if mesh is None:
        def train_step(params, opt_state, batch):
            loss, grads = _loss_and_grads(cfg, params, batch, grad_accum)
            params, opt_state, metrics = opt.update(grads, opt_state, params)
            return params, opt_state, dict(metrics, loss=loss)
        return train_step

    _check_mesh(mesh)
    rules = rules or ShardingRules()
    model = get_model(cfg, "cpu")
    pspecs = _param_specs(cfg, mesh, rules)
    ospecs = opt_state_shardings(rules, model.spec(),
                                 opt.init(model.abstract_params()), mesh)
    bspecs = batch_shardings(mesh, model.train_inputs(shape))
    n = batch_ranks(mesh)
    if (shape.global_batch // n) % grad_accum and any(
            s and s[0] is not None for s in bspecs.values()):
        raise ValueError(f"a rank's {shape.global_batch // n} rows do not "
                         f"split into {grad_accum} micro-batches")

    def train_step(params, opt_state, batch):
        full = gather(params)
        loss, grads = _loss_and_grads(cfg, full, _rows(mesh, batch, bspecs),
                                      grad_accum)
        del full
        dev = loss.device
        grads, treedef = tree_flatten(tree_map(lambda g: g.float(), grads))
        for g in grads + [loss]:
            dist.all_reduce(g)
        ranks = torch.tensor(float(n), device=dev)
        loss = loss / ranks
        grads = [g / ranks for g in grads]
        # the norm of the whole averaged gradient, before any shard is cut
        g_norm = opt.global_norm(grads)
        grads = tree_map(lambda g, p: local_chunk(g, p.placements,
                                                  p.device_mesh),
                         treedef.unflatten(grads), params)
        new_p, new_s, metrics = opt.update(
            grads, AdamWState(step=local(opt_state.step), m=local(opt_state.m),
                              v=local(opt_state.v)),
            local(params), grad_norm=g_norm)
        new_s = AdamWState(step=_as_dtensors(new_s.step, opt_state.step),
                           m=_as_dtensors(new_s.m, opt_state.m),
                           v=_as_dtensors(new_s.v, opt_state.v))
        return (_as_dtensors(new_p, params), new_s, dict(metrics, loss=loss))

    return BuiltStep(train_step, mesh, (pspecs, ospecs, None))


def build_prefill(cfg: ModelConfig, shape: InputShape, *, mesh=None,
                  rules: Optional[ShardingRules] = None,
                  max_len: Optional[int] = None):
    """prefill(params, batch) -> (last-position logits, decode caches of
    ``max_len`` rows, ``shape.seq_len`` by default).  With ``mesh`` a
    ``BuiltStep`` over placed parameters: each rank prefills its rows of
    the batch; the logits come back whole (gathered over the batch group),
    the caches hold the rank's rows (``cache_shardings``' batch dim)."""
    max_len = max_len or shape.seq_len
    if mesh is None:
        def prefill(params, batch):
            return T.prefill(cfg, params, batch, max_len)
        return prefill

    _check_mesh(mesh)
    rules = rules or ShardingRules()
    bspecs = batch_shardings(mesh, get_model(cfg, "cpu").prefill_inputs(shape))

    def prefill(params, batch):
        logits, caches = T.prefill(cfg, gather(params),
                                   _rows(mesh, batch, bspecs), max_len)
        return _gather_rows(mesh, logits), caches

    return BuiltStep(prefill, mesh, (_param_specs(cfg, mesh, rules), None))


def build_decode_step(cfg: ModelConfig, shape: Optional[InputShape] = None,
                      *, mesh=None, rules: Optional[ShardingRules] = None):
    """decode_step(params, caches, batch, cache_index) -> (logits (B, 1, V),
    or (B, 1, ncb, V) with codebooks, caches): one new token against the
    caches ``build_prefill`` made.  With ``mesh`` (and the decode ``shape``)
    a ``BuiltStep``: each rank decodes its rows into its caches, and the
    logits come back whole."""
    if mesh is None:
        def decode_step(params, caches, batch, cache_index: int):
            return T.decode_step(cfg, params, caches, batch, cache_index)
        return decode_step

    _check_mesh(mesh)
    if shape is None:
        raise ValueError("a decode step over a mesh needs its shape")
    rules = rules or ShardingRules()
    bspecs = batch_shardings(mesh, get_model(cfg, "cpu").decode_inputs(shape))

    def decode_step(params, caches, batch, cache_index: int):
        logits, caches = T.decode_step(cfg, gather(params), caches,
                                       _rows(mesh, batch, bspecs), cache_index)
        return _gather_rows(mesh, logits), caches

    return BuiltStep(decode_step, mesh,
                     (_param_specs(cfg, mesh, rules), None, None, None))


BUILDERS = {
    "train": build_train_step,
    "prefill": build_prefill,
    "decode": build_decode_step,
}


def build_step(cfg: ModelConfig, shape: InputShape, **kw):
    """The builder of ``shape.kind`` ("train", "prefill" or "decode")."""
    return BUILDERS[shape.kind](cfg, shape, **kw)
