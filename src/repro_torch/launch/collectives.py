"""Every collective of the port's mesh code, over an explicit group, and
the tensor-parallel operators the models call on the ``model`` axis.

Plain collectives (``all_reduce``, ``all_gather``) take a process group or
None; None, and a group of one rank, mean no collective at all (nothing is
issued, so nothing is counted).  They go through ``torch.distributed``'s
c10d operations, which ``launch/cost.py`` counts at dispatch, on the meta
device too (the dry-run's stand-in process group).

Tensor parallelism (Megatron-LM's scheme) keeps the residual stream whole
and equal on every rank of the ``model`` group.  A layer whose weights the
rules split over ``model`` runs on the rank's shard between two conjugate
operators:

* ``copy_to_model`` (Megatron's f): identity forward, an all-reduce of the
  gradient backward.  It goes in front of every column-parallel input, and
  on every replicated weight or activation that the rank then uses for its
  own shard only, so that the partial gradients of the ranks are summed.
* ``reduce_from_model`` (g): an all-reduce forward, identity backward.  It
  goes after every row-parallel output, where the layer's result enters
  the whole residual stream again.

Inside a layer a value that is made whole and then used for the rank's
shard again takes both (``reduce_mid``: an all-reduce each way), and an
activation cut in the packed layout of a weight is gathered whole
(``gather_from_model``, backward the rank's own chunk; ``gather_mid`` sums
the gradients first).  ``model_parallel`` sets the group the models see;
outside it, or on a group of one rank, every operator is the identity.

Sequence parallelism (Megatron-SP; ``model_parallel(..., seq=True)``, the
train step's default): the residual stream between layers is each rank's
chunk of the sequence (dim 1, in ``torch.chunk`` order), and the conjugate
pair moves to the sequence:

* ``gather_seq``: an all-gather of the chunks forward, a reduce-scatter of
  the gradient backward.  It takes f's place at the entry of a layer split
  over ``model``, whose gradient of its input is a partial sum on each rank.
* ``scatter_seq``: a reduce-scatter forward (the partial sums summed, each
  rank keeping its chunk), an all-gather of the gradient backward.  It
  takes g's place after a row-parallel product.
* A layer whole on every rank (its heads do not divide the group) computes
  the same whole gradient on each: its input comes through
  ``gather_seq_whole`` (backward the rank's own chunk) and its output goes
  back through ``split_seq`` (the rank's chunk; backward an all-gather).
  A reduce-scatter there would count the gradient once a rank.
* ``seq_weight``: f on a replicated weight used on the rank's chunk (the
  norms between layers), whose gradient is a sum over the rank's positions.

``layer_in`` and ``layer_out`` pick a layer's pair from whether it splits,
under either scheme.  The sequence operators are the identity unless the
sequence is cut (``seq_sharded``).

Decode over a mesh (flash decode across ranks): a cache leaf placed as
``sharding.cache_shardings`` places it is cut on one dim over the ranks of
a group (``Cut``: its dim, the group, this rank's chunk).  A rank's rows of
a sequence-cut cache give a partial attention, (out in float32, its
log-sum-exp); ``combine_partials`` all-gathers them over the cut's group
and ``merge_partials`` merges them in rank order, the same order on every
rank, so the replicated activations stay bitwise equal across the ranks.
``to_local`` and ``to_placed`` move a recurrent state between its placed
chunk and the chunk a layer computes on (its model shard or the whole).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``x`` summed (or its maximum or minimum taken, ``op="max"`` or
    ``"min"``) over the ranks of ``group``, in place; ``x`` itself."""
    if group_size(group) > 1:
        dist.all_reduce(x, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX,
                               "min": dist.ReduceOp.MIN}[op], group=group)
    return x


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` of ``group``, concatenated along ``dim`` in rank
    order (``x`` itself on a group of one rank)."""
    n = group_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


# torch's name for it where it has one (``reduce_scatter_tensor``, its
# older name, warns that it is deprecated there)
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """``x`` summed over the ranks of ``group``, and this rank's chunk of
    the sum along ``dim`` (``torch.chunk``'s order; ``x`` itself on a group
    of one rank)."""
    n = group_size(group)
    if n == 1:
        return x
    parts = x.unflatten(dim, (n, x.shape[dim] // n)).movedim(dim, 0)
    out = parts.new_empty(parts.shape[1:])
    # the chunks concatenated on dim 0, the layout every backend takes
    _REDUCE_SCATTER(out, parts.contiguous().flatten(0, 1), group=group)
    return out


def all_gather_object(obj, group) -> list:
    """Every rank's picklable ``obj`` of ``group``, in rank order."""
    n = group_size(group)
    if n == 1:
        return [obj]
    out = [None] * n
    dist.all_gather_object(out, obj, group=group)
    return out


# ---------------------------------------------------------------------------
# the model group the layers see
# ---------------------------------------------------------------------------

_MODEL: Optional[tuple] = None        # (group, rank in it, its size)
_BATCH = None                         # the batch group, over one rank
_SEQ = False                          # the residual cut on its sequence


@contextlib.contextmanager
def model_parallel(group, batch_group=None, seq: bool = False):
    """While open, the models split their layers over ``group`` (the
    mesh's ``model`` axis; None or one rank: no split), statistics of the
    whole batch (the MoE load-balance term) are summed over
    ``batch_group`` (the ranks that hold the other rows), and with ``seq``
    the residual stream between layers is the rank's chunk of the
    sequence (over a group of one rank it stays whole)."""
    global _MODEL, _BATCH, _SEQ
    outer = _MODEL, _BATCH, _SEQ
    n = group_size(group)
    _MODEL = (group, dist.get_rank(group), n) if n > 1 else None
    _BATCH = batch_group if group_size(batch_group) > 1 else None
    _SEQ = seq and _MODEL is not None
    try:
        yield
    finally:
        _MODEL, _BATCH, _SEQ = outer


def seq_sharded() -> bool:
    """Whether the residual stream is the rank's chunk of the sequence."""
    return _SEQ


def model_size() -> int:
    return 1 if _MODEL is None else _MODEL[2]


def model_rank() -> int:
    return 0 if _MODEL is None else _MODEL[1]


def split(local: int, full: int) -> bool:
    """Whether a dim of ``full`` that a leaf holds ``local`` of is split
    over the model group (the rules leave a dim whole where the group's
    size does not divide it)."""
    return _MODEL is not None and local != full


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.n, ctx.n), None, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """f: identity forward, the gradient summed over the model group."""
    return x if _MODEL is None else _Copy.apply(x, _MODEL[0])


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """g: ``x`` summed over the model group, the gradient passed as it is
    (the value goes on whole, so each rank's gradient is the whole one)."""
    return x if _MODEL is None else _Reduce.apply(x, _MODEL[0])


def reduce_mid(x: torch.Tensor) -> torch.Tensor:
    """g then f: the sum over the model group of a value that the rank
    then uses for its own shard again, so its gradient is summed too."""
    return copy_to_model(reduce_from_model(x))


def gather_from_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Every rank's shard of ``x`` along ``dim``, whole; the gradient is
    the whole one on every rank, and each takes its own chunk."""
    if _MODEL is None:
        return x
    return _Gather.apply(x, _MODEL[0], dim % x.dim())


def gather_mid(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``gather_from_model`` for a value that the rank then uses for its
    own shard only: the ranks' gradients are summed before the chunk."""
    return copy_to_model(gather_from_model(x, dim))


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = group_size(group)
        # a copy: a view would keep the whole tensor alive wherever the
        # chunk is saved (remat keeps each layer's input)
        return x.chunk(n, dim)[dist.get_rank(group)].clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


def gather_seq(x: torch.Tensor) -> torch.Tensor:
    """The whole sequence from every rank's chunk of ``x`` (B, S/n, ...):
    an all-gather forward, and backward a reduce-scatter, which sums the
    partial gradients of a layer split over the model group and gives each
    rank its chunk.  The identity unless the sequence is cut."""
    return _GatherSeq.apply(x, _MODEL[0], 1) if _SEQ else x


def scatter_seq(x: torch.Tensor) -> torch.Tensor:
    """The rank's chunk of the sequence of the sum over the model group of
    ``x`` (B, S, ...), the partial sums of a row-parallel product: a
    reduce-scatter forward, an all-gather of the gradient backward.  The
    identity unless the sequence is cut."""
    return _ScatterSeq.apply(x, _MODEL[0], 1) if _SEQ else x


def gather_seq_whole(x: torch.Tensor) -> torch.Tensor:
    """``gather_seq`` for a value that every rank then uses whole and
    alike: the gradient is the whole one on every rank, and each takes its
    own chunk of it (no reduction)."""
    return _Gather.apply(x, _MODEL[0], 1) if _SEQ else x


def split_seq(x: torch.Tensor) -> torch.Tensor:
    """The rank's chunk of the sequence of ``x`` (B, S, ...), whole and
    equal on every rank; backward the chunks' gradients all-gathered.  The
    identity unless the sequence is cut."""
    return _SplitSeq.apply(x, _MODEL[0], 1) if _SEQ else x


def seq_weight(w: torch.Tensor) -> torch.Tensor:
    """A replicated weight used on the rank's chunk of the sequence (a norm
    between layers): f, so that the gradients of the ranks' positions are
    summed.  As it is unless the sequence is cut."""
    return _Copy.apply(w, _MODEL[0]) if _SEQ else w


def layer_in(x: torch.Tensor, split: bool) -> torch.Tensor:
    """A layer's input ``x`` from the residual stream, whole along the
    sequence: ``split`` (the layer runs on the rank's shard of its
    weights) f, or ``gather_seq`` where the sequence is cut; a layer whole
    on every rank takes ``x`` as it is, or ``gather_seq_whole``."""
    if _SEQ:
        return gather_seq(x) if split else gather_seq_whole(x)
    return copy_to_model(x) if split else x


def layer_out(y: torch.Tensor, split: bool) -> torch.Tensor:
    """A layer's output ``y`` (whole along the sequence) into the residual
    stream: ``split`` (partial sums of the ranks) g, or ``scatter_seq``
    where the sequence is cut; a whole output as it is, or ``split_seq``."""
    if _SEQ:
        return scatter_seq(y) if split else split_seq(y)
    return reduce_from_model(y) if split else y


class _SumBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


def batch_ranks() -> int:
    """The ranks that hold the batch's rows (1 outside a batch group)."""
    return group_size(_BATCH)


def sum_over_batch(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the batch group, and its gradient too: the
    statistic enters every rank's loss whole, and the step averages the
    ranks' gradients, so each rank's share is the sum of theirs."""
    return x if _BATCH is None else _SumBoth.apply(x, _BATCH)


def max_over_model(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum over the model group (no gradient)."""
    if _MODEL is None:
        return x
    return all_reduce(x.detach().contiguous().clone(), _MODEL[0], "max")


# ---------------------------------------------------------------------------
# caches cut over a group: flash decode across ranks
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Cut:
    """Where this rank's chunk of a cache leaf lies: dim ``dim`` of the
    layer's leaf (batch rows at 0; the stacked layer dim not counted) cut
    into ``n`` equal chunks over ``group`` (the mesh axes ``axes``, in
    chunk order), this rank's the ``index``-th, ``size`` long."""
    dim: int
    axes: Tuple[str, ...]
    group: Any
    index: int
    n: int
    size: int

    @property
    def start(self) -> int:
        return self.index * self.size

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's chunk, whole (in chunk order)."""
        return all_gather(x, self.group, self.dim)

    def chunk(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of the whole ``x`` (a view)."""
        return x.narrow(self.dim, self.start, self.size)

    def model_shard(self, dim: Optional[int]) -> bool:
        """Whether the chunk is the model group's shard of ``dim``."""
        return (dim == self.dim and self.axes == ("model",)
                and self.n == model_size())


def merge_partials(outs: torch.Tensor, lses: torch.Tensor,
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Partial attentions over disjoint key sets merged into the attention
    over their union: ``outs`` (n, ..., d) float32, each normalized over its
    keys, ``lses`` (n, ...) their log-sum-exps (-inf: no key, weight 0).
    With M = max lse, out = sum_r e^(lse_r - M) out_r / sum_r e^(lse_r - M),
    summed in index order; rounded once to ``dtype`` (float32 if None)."""
    top = lses.amax(0)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    w = torch.exp(lses - top)                       # e^-inf = 0
    num, den = outs[0] * w[0, ..., None], w[0]
    for r in range(1, outs.shape[0]):
        num = num + outs[r] * w[r, ..., None]
        den = den + w[r]
    out = num / den.clamp_min(1e-30)[..., None]
    return out if dtype is None else out.to(dtype)


def combine_partials(out: torch.Tensor, lse: torch.Tensor, group,
                     dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The attention over every rank's keys of ``group`` from this rank's
    partial (``out`` (..., d) float32, ``lse`` (...) float32): one
    all-gather of (out, lse) over the group, then ``merge_partials`` in
    rank order, every rank the same bits; rounded once to ``dtype``."""
    packed = torch.cat([out.float(), lse.float()[..., None]], dim=-1)
    parts = all_gather(packed[None], group, 0)
    return merge_partials(parts[..., :-1], parts[..., -1], dtype)


def model_chunk(x: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """This rank's chunk of ``x`` along ``dim`` over the model group (``x``
    where ``dim`` is None or no group splits)."""
    if dim is None or _MODEL is None:
        return x
    return x.chunk(_MODEL[2], dim)[_MODEL[1]]


def to_local(x: torch.Tensor, cut: Optional[Cut],
             dim: Optional[int]) -> torch.Tensor:
    """A placed chunk ``x`` (``cut``; None: whole) as the chunk a layer
    computes on: its model shard along ``dim``, or whole where ``dim`` is
    None.  As it is where the placement is that shard; else gathered whole
    over the cut's group and cut to the layer's shard."""
    if (cut is None and (dim is None or _MODEL is None)) or (
            cut is not None and cut.model_shard(dim)):
        return x
    return model_chunk(x if cut is None else cut.gather(x), dim)


def to_placed(y: torch.Tensor, cut: Optional[Cut],
              dim: Optional[int]) -> torch.Tensor:
    """``to_local``'s inverse: the layer's chunk ``y`` (its model shard
    along ``dim``, or whole) as the placed chunk, gathered whole over the
    model group where it is a shard and cut as ``cut`` cuts it."""
    if (cut is None and (dim is None or _MODEL is None)) or (
            cut is not None and cut.model_shard(dim)):
        return y
    whole = y if dim is None or _MODEL is None else all_gather(
        y, _MODEL[0], dim)
    return whole if cut is None else cut.chunk(whole)
