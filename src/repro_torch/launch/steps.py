"""Step builders (``repro/launch/steps.py``): the train step, prefill and
decode_step, on one device or over a (data, model) mesh.

Without a mesh a builder returns the step function itself, run eagerly on
the tensors' device.  With a mesh (``launch/mesh.py``) it returns a
``BuiltStep``: the same computation on each rank's rows of the batch (the
batch split over the mesh's batch axes as ``batch_shardings`` places it)
and on its shards of the weights.  The parameters and AdamW's moments are
``DTensor``s in the placements the rules give (FSDP: the "embed" dim over
"data"; replicated with ``ShardingRules(fsdp=False)``; heads, MLP, expert
hidden dims, vocab and SSM inner dims over "model"); ``BuiltStep.place``
puts full trees there and ``sharding.gather`` takes them back.
``BuiltStep.local_fn`` is the step on this rank's plain chunks (what the
dry-run counts on the meta device).

For the compute each rank gathers its chunks whole over the batch axes
(``gather_batch``; no copy on axes of size one) and keeps its ``model``
shards: the layers run tensor-parallel on them inside
``collectives.model_parallel`` (``models/layers.py``, ``models/ssm.py``,
``models/transformer.py``), and the hand-written kernels get plain local
tensors, a rank's heads, never a DTensor.  The train step's default
(``seq_shard=True``, the JAX package's) is sequence parallelism where the
residual's spec (``ActivationShardings.for_mesh``) keeps "model" on its
sequence: between layers each rank holds its chunk of the sequence, and
each layer gathers it at its entry and reduce-scatters at its exit
(``collectives.model_parallel(..., seq=True)``).  A train step then sums
the loss and the float32 gradients over the batch group (an all-reduce)
and divides by its size, clips by the norm of the whole averaged gradient
(the squares of the model shards summed over the model group, a replicated
leaf counted once) and lets AdamW update each rank's shards.  The prefill returns the
logits whole (gathered over "model" by the unembedding, over the batch
group here) and its caches placed as ``cache_shardings`` places them for
``max_len`` rows (the JAX package's ``out_shardings``): each leaf's rows of
the batch and its chunk of the dim the rule cuts (an attention cache's
sequence, or its head_dim where that is longer; a recurrent state's widest
inner dim), as ``DTensor``s, ``local_fn`` giving the plain chunks.  The
decode step takes and returns the caches in that placement for its shape
(``in_specs`` carry their specs, so ``BuiltStep.place`` and
``sharding.gather`` move whole caches in and out), and runs under the model
group too: attention on a rank's rows with B6's partial mode and a combine
across the ranks that hold the others (flash decode), as
``models/layers.py`` and ``models/ssm.py`` say.  On a 1 x 1 mesh every
placement is whole on its rank, no collective runs, and the step computes
the mesh-free step's numbers bit for bit.  Gradient compression
(``optim/compress.py``) is a library function here as in the JAX package,
wired into no step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch import collectives as C
from repro_torch.launch.mesh import batch_axes, batch_index, batch_ranks
from repro_torch.launch.sharding import (ActivationShardings, ShardingRules,
                                         batch_chunk, batch_shardings,
                                         cache_cuts,
                                         cache_shardings, distribute,
                                         entry_axes, fit_pspec, gather_batch,
                                         local, opt_state_shardings,
                                         param_shardings, placements)
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.tree import spec_map, tree_flatten, tree_map


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


def _gather_rows(mesh, x: torch.Tensor, specs) -> torch.Tensor:
    """Every rank's rows of ``x`` over the batch group, in rank order, where
    the batch's specs split its rows (none to fetch from a batch group of
    one, nor where every rank holds every row)."""
    if not any(s and s[0] is not None for s in specs.values()):
        return x
    return C.all_gather(x, mesh.group("batch"), 0)


def _cache_placement(cfg: ModelConfig, mesh, batch: int, max_len: int):
    """(the specs ``cache_shardings`` gives the caches of ``batch`` rows and
    ``max_len`` rows, this rank's ``Cut`` of each leaf, the global
    caches on the meta device)."""
    abstract = get_model(cfg, "cpu").abstract_cache(batch, max_len)
    specs = cache_shardings(mesh, abstract)
    return specs, cache_cuts(mesh, specs, abstract), abstract


def _as_dtensors(local_tree, like_tree):
    from torch.distributed.tensor import DTensor
    return tree_map(lambda x, like: DTensor.from_local(
        x, like.device_mesh, like.placements, run_check=False,
        shape=like.shape, stride=like.stride()), local_tree, like_tree)


def _placed_dtensors(mesh, local_tree, specs, abstract):
    """This rank's chunks as ``DTensor``s in their specs' placements, of
    the global shapes ``abstract`` (meta tensors) gives."""
    from torch.distributed.tensor import DTensor
    return spec_map(lambda sp, x, like: DTensor.from_local(
        x, mesh.device_mesh, placements(sp, mesh), run_check=False,
        shape=like.shape, stride=like.stride()), specs, local_tree, abstract)


@dataclass
class BuiltStep:
    """A step over a mesh: ``fn`` with the specs of its placed arguments
    (``in_specs``, one per argument, None where it is not placed), and
    ``local_fn``, the same step on this rank's plain chunks of the placed
    arguments and its rows of the batch."""
    fn: Callable
    mesh: Any
    in_specs: tuple
    local_fn: Optional[Callable] = None

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


def _model_sharded(spec) -> bool:
    return any("model" in entry_axes(e) for e in spec)


def seq_cut(mesh, cfg: ModelConfig, shape: InputShape, grad_accum: int = 1,
            seq_shard: bool = True) -> bool:
    """Whether the train step over ``mesh`` cuts the residual stream on its
    sequence over "model": the spec ``ActivationShardings.for_mesh`` gives
    a micro-batch's (B, S, d) keeps "model" on S (``fit_pspec`` drops it
    where S does not divide), as the JAX package's step constrains it."""
    act = ActivationShardings.for_mesh(
        mesh, shape.global_batch // grad_accum, shape.seq_len, cfg.d_model,
        seq_shard=seq_shard)
    return "model" in entry_axes(act.residual[1])


def build_train_step(cfg: ModelConfig, shape: InputShape, *, mesh=None,
                     rules: Optional[ShardingRules] = None,
                     opt: Optional[AdamW] = None, grad_accum: int = 1,
                     seq_shard: bool = True):
    """train_step(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm", "lr"}): the loss and gradients of the batch (with
    ``grad_accum`` > 1 its leading axis split into that many micro-batches,
    run in order, their gradients summed in float32 and, with the loss,
    divided by ``grad_accum``), then ``opt.update``.

    With ``mesh`` a ``BuiltStep``: each rank takes its rows of the global
    batch and computes on its model shards, every rank's mean loss and
    float32 gradients are averaged over the batch group, AdamW clips by the
    averaged gradient's global norm and updates each rank's shards of the
    parameters and moments (DTensors in the ``rules``' placements,
    ``BuiltStep.place``).  ``seq_shard`` (the JAX package's default): the
    residual stream between layers is each rank's chunk of the sequence
    over "model" where the sequence divides (``seq_cut``); otherwise, and
    with ``seq_shard=False``, whole on each rank (Megatron-TP alone).  Over
    a "model" axis of one rank both are the same step."""
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
    sharded = tree_flatten(spec_map(_model_sharded, pspecs))[0]
    seq = seq_cut(mesh, cfg, shape, grad_accum, seq_shard)

    def local_step(params, opt_state, rows):
        """The step on this rank's chunks (plain tensors) and rows."""
        full = gather_batch(params, pspecs, mesh)
        with C.model_parallel(mesh.group("model"), mesh.group("batch"),
                              seq=seq):
            loss, grads = _loss_and_grads(cfg, full, rows, grad_accum)
        del full
        dev = loss.device
        grads, treedef = tree_flatten(tree_map(lambda g: g.float(), grads))
        for g in grads + [loss]:
            C.all_reduce(g, mesh.group("batch"))
        ranks = torch.tensor(float(n), device=dev)
        loss = loss / ranks
        grads = [g / ranks for g in grads]
        # the norm of the whole averaged gradient, before any batch-axis
        # chunk is cut
        g_norm = opt.global_norm(grads, sharded, mesh.group("model"))
        grads = spec_map(lambda sp, g: batch_chunk(g, sp, mesh), pspecs,
                         treedef.unflatten(grads))
        new_p, new_s, metrics = opt.update(grads, opt_state, params,
                                           grad_norm=g_norm)
        return new_p, new_s, dict(metrics, loss=loss)

    def train_step(params, opt_state, batch):
        new_p, new_s, metrics = local_step(
            local(params), AdamWState(step=local(opt_state.step),
                                      m=local(opt_state.m),
                                      v=local(opt_state.v)),
            _rows(mesh, batch, bspecs))
        new_s = AdamWState(step=_as_dtensors(new_s.step, opt_state.step),
                           m=_as_dtensors(new_s.m, opt_state.m),
                           v=_as_dtensors(new_s.v, opt_state.v))
        return _as_dtensors(new_p, params), new_s, metrics

    return BuiltStep(train_step, mesh, (pspecs, ospecs, None), local_step)


def build_prefill(cfg: ModelConfig, shape: InputShape, *, mesh=None,
                  rules: Optional[ShardingRules] = None,
                  max_len: Optional[int] = None):
    """prefill(params, batch) -> (last-position logits, decode caches of
    ``max_len`` rows, ``shape.seq_len`` by default).  With ``mesh`` a
    ``BuiltStep`` over placed parameters: each rank prefills its rows of
    the batch on its model shards; the logits come back whole (gathered
    over "model" and over the batch group), the caches placed as
    ``cache_shardings`` places them for ``max_len`` rows (DTensors;
    ``local_fn`` gives this rank's plain chunks)."""
    max_len = max_len or shape.seq_len
    if mesh is None:
        def prefill(params, batch):
            return T.prefill(cfg, params, batch, max_len)
        return prefill

    rules = rules or ShardingRules()
    bspecs = batch_shardings(mesh, get_model(cfg, "cpu").prefill_inputs(shape))
    pspecs = _param_specs(cfg, mesh, rules)
    cspecs, cuts, abstract = _cache_placement(cfg, mesh, shape.global_batch,
                                              max_len)

    def local_prefill(params, rows):
        full = gather_batch(params, pspecs, mesh)
        with C.model_parallel(mesh.group("model")):
            logits, caches = T.prefill(cfg, full, rows, max_len, cuts=cuts)
        return _gather_rows(mesh, logits, bspecs), caches

    def prefill(params, batch):
        logits, caches = local_prefill(local(params),
                                       _rows(mesh, batch, bspecs))
        return logits, _placed_dtensors(mesh, caches, cspecs, abstract)

    return BuiltStep(prefill, mesh, (pspecs, None), local_prefill)


def build_decode_step(cfg: ModelConfig, shape: Optional[InputShape] = None,
                      *, mesh=None, rules: Optional[ShardingRules] = None):
    """decode_step(params, caches, batch, cache_index) -> (logits (B, 1, V),
    or (B, 1, ncb, V) with codebooks, caches): one new token against the
    caches ``build_prefill`` made.  With ``mesh`` (and the decode ``shape``,
    whose ``seq_len`` is the caches' rows) a ``BuiltStep``: the caches come
    in and go out placed as ``cache_shardings`` places them (DTensors; in
    ``local_fn`` this rank's plain chunks, updated in place), each rank
    decodes its rows on its model shards, and the logits come back
    whole."""
    if mesh is None:
        def decode_step(params, caches, batch, cache_index: int):
            return T.decode_step(cfg, params, caches, batch, cache_index)
        return decode_step

    if shape is None:
        raise ValueError("a decode step over a mesh needs its shape")
    rules = rules or ShardingRules()
    bspecs = batch_shardings(mesh, get_model(cfg, "cpu").decode_inputs(shape))
    pspecs = _param_specs(cfg, mesh, rules)
    cspecs, cuts, abstract = _cache_placement(cfg, mesh, shape.global_batch,
                                              shape.seq_len)

    def local_decode(params, caches, rows, cache_index: int):
        full = gather_batch(params, pspecs, mesh)
        with C.model_parallel(mesh.group("model"), mesh.group("batch")):
            logits, caches = T.decode_step(cfg, full, caches, rows,
                                           cache_index, cuts=cuts)
        return _gather_rows(mesh, logits, bspecs), caches

    def decode_step(params, caches, batch, cache_index: int):
        logits, new = local_decode(local(params), local(caches),
                                   _rows(mesh, batch, bspecs), cache_index)
        return logits, _placed_dtensors(mesh, new, cspecs, abstract)

    return BuiltStep(decode_step, mesh, (pspecs, cspecs, None, None),
                     local_decode)


BUILDERS = {
    "train": build_train_step,
    "prefill": build_prefill,
    "decode": build_decode_step,
}


def build_step(cfg: ModelConfig, shape: InputShape, **kw):
    """The builder of ``shape.kind`` ("train", "prefill" or "decode")."""
    return BUILDERS[shape.kind](cfg, shape, **kw)
