"""Logical-axis sharding rules: the port of ``repro/launch/sharding.py``.

Parameters carry logical axis names (the models' ``*_spec`` trees); the
rules map each name to mesh axes, falling back to replication where a dim
does not divide.  The same engine places AdamW's moments (as their
parameters), decode caches (by dim size), batches (rows over the batch
axes), the vectorized MAC's cell axis, and the residual stream.

A spec is a tuple with one entry per dim: ``None``, a mesh axis name, or a
tuple of names, as JAX's ``PartitionSpec`` holds them (one name alone is the
name).  The rules are pure Python on a mesh's ``axis_names`` and ``shape``
(``launch/mesh.py``'s ``Mesh``, or any stand-in with those attributes).
``placements`` turns a spec into ``torch.distributed.tensor`` placements on
a ``Mesh``; ``distribute`` and ``gather`` move trees in and out of them.
The steps compute on plain tensors: ``shard`` cuts a rank's chunks of full
trees by their specs, ``gather_batch`` makes them whole over the batch axes
(FSDP's ``"embed"`` shards) and keeps the ``model`` shards, and
``batch_chunk`` cuts the batch axes again.  Every collective goes through
``launch/collectives.py``.  ``cache_cuts`` reads a decode cache's placement
for the layers: where each leaf's chunk lies on the dim ``cache_shardings``
cuts beside the batch rows, and over which group.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from repro_torch.launch import collectives as C
from repro_torch.launch.mesh import batch_axes, batch_ranks
from repro_torch.tree import spec_map, tree_map

# logical axis -> preferred mesh axes, in priority order.  FSDP = "embed"
# over the data axes; TP = heads/mlp/vocab over "model".
DEFAULT_RULES: Dict[Optional[str], Tuple[str, ...]] = {
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "expert_mlp": ("model",),
    "inner": ("model",),         # SSM expanded dim
    "inner_out": ("model",),
    "embed": ("data",),          # FSDP shard of the non-TP dim
    "experts": (),               # EP fallback (40/64 don't divide 16)
    "kv_lora": (),
    "layers": (),                # the stacked layer dim stays whole
    "head_dim": (),
    "conv": (),
    "state": (),
    None: (),
}

Spec = Tuple[Any, ...]


def _entry(axes: Tuple[str, ...]):
    """A spec entry as ``PartitionSpec`` normalizes it."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes one entry of a spec names, in order."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclass(frozen=True)
class ShardingRules:
    rules: Dict[Optional[str], Tuple[str, ...]] = field(
        default_factory=lambda: dict(DEFAULT_RULES))
    fsdp: bool = True            # False -> params replicated over data

    def mesh_axes_for(self, logical: Optional[str]) -> Tuple[str, ...]:
        axes = self.rules.get(logical, ())
        if not self.fsdp and axes == ("data",):
            return ()
        return axes

    def pspec(self, spec: Tuple[Optional[str], ...], shape: Tuple[int, ...],
              mesh) -> Spec:
        """One leaf's logical spec as a spec on ``mesh``: each dim takes the
        first of its preferred axes that the mesh has, that no earlier dim
        took, and whose size divides it; else it is replicated."""
        used = set()
        out = []
        for logical, dim in zip(spec, shape):
            placed = None
            for ax in self.mesh_axes_for(logical):
                if ax in used or ax not in mesh.axis_names:
                    continue
                if dim % mesh.shape[ax] == 0:
                    placed = ax
                    used.add(ax)
                    break
            out.append(placed)
        return tuple(out)


def fit_pspec(mesh, pspec: Spec, shape: Tuple[int, ...]) -> Spec:
    """Drop the mesh axes of each entry whose running product does not
    divide the dim."""
    out = []
    for i, entry in enumerate(pspec):
        if entry is None or i >= len(shape):
            out.append(None)
            continue
        keep = []
        prod = 1
        for a in entry_axes(entry):
            if shape[i] % (prod * mesh.shape[a]) == 0:
                keep.append(a)
                prod *= mesh.shape[a]
        out.append(_entry(tuple(keep)))
    return tuple(out)


def param_shardings(rules: ShardingRules, spec_tree, abstract_params, mesh):
    """The spec of every parameter (the spec tree mirrors the parameter
    tree; its leaves are tuples of logical names)."""
    def one(spec, leaf):
        if len(spec) != leaf.dim():
            raise ValueError(f"spec {spec} vs shape {tuple(leaf.shape)}")
        return rules.pspec(spec, tuple(leaf.shape), mesh)
    return spec_map(one, spec_tree, abstract_params)


def opt_state_shardings(rules: ShardingRules, spec_tree, abstract_opt, mesh):
    """AdamW's state: m and v as their parameters, the step replicated."""
    from repro_torch.optim.adamw import AdamWState
    return AdamWState(
        step=(), m=param_shardings(rules, spec_tree, abstract_opt.m, mesh),
        v=param_shardings(rules, spec_tree, abstract_opt.v, mesh))


def batch_shardings(mesh, abstract_batch):
    """Input batches (a dict of tensors or ``TensorSpec``s): dim 0 over the
    batch axes where they divide it, else replicated."""
    ba = batch_axes(mesh)

    def one(leaf):
        if len(leaf.shape) == 0:
            return ()
        if leaf.shape[0] % batch_ranks(mesh) == 0:
            return (_entry(ba),)
        return ()
    return {k: one(v) for k, v in abstract_batch.items()}


def cell_axis_sharding(mesh, n_cells: int) -> Spec:
    """The vectorized MAC's stacked per-cell state: cells over the batch
    axes where their count divides (the slot step is elementwise across
    cells, so no collective runs inside a step), else replicated."""
    ba = batch_axes(mesh)
    if ba and n_cells % batch_ranks(mesh) == 0:
        return (_entry(ba),)
    return ()


def cache_shardings(mesh, abstract_caches):
    """Decode caches, by a rule on each leaf (stacked layers lead): the
    batch dim (1) over the batch axes where it divides; the largest other
    dim over "model"; where the batch could not split (a batch of one),
    that dim takes the batch axes too where it divides."""
    ba = batch_axes(mesh)
    n_batch = batch_ranks(mesh)

    def one(leaf):
        shape = tuple(leaf.shape)
        if len(shape) <= 2:
            return ()
        spec: list = [None] * len(shape)
        batch_ok = shape[1] % n_batch == 0
        if batch_ok:
            spec[1] = _entry(ba)
        rest = sorted(((d, i) for i, d in enumerate(shape) if i >= 2),
                      reverse=True)
        for d, i in rest:
            if d % mesh.shape["model"] == 0:
                if not batch_ok and d % (mesh.shape["model"] * n_batch) == 0:
                    spec[i] = ba + ("model",)
                else:
                    spec[i] = "model"
                break
        return tuple(spec)

    return tree_map(one, abstract_caches)


def cache_cuts(mesh, cache_specs, abstract_caches):
    """Each stacked cache leaf's ``collectives.Cut`` on this rank, from its
    ``cache_shardings`` spec and its global shape: the dim cut beside the
    batch rows (dim 1, whose chunk is the rank's rows of the batch), counted
    in the layer's leaf (the stacked dim 0 dropped), over the group of the
    mesh axes its entry names (``Mesh.group_over``), this rank's chunk in
    ``torch.chunk`` order; None where no such dim is cut over a group of
    more than one rank."""
    coord = mesh.coordinate()

    def one(spec, leaf):
        for d, entry in enumerate(spec):
            axes = tuple(a for a in entry_axes(entry) if mesh.shape[a] > 1)
            if d < 2 or not axes:
                continue
            n, index = 1, 0
            for a in axes:
                n *= mesh.shape[a]
                index = index * mesh.shape[a] + coord[a]
            return C.Cut(dim=d - 1, axes=axes, group=mesh.group_over(axes),
                         index=index, n=n, size=leaf.shape[d] // n)
        return None
    return spec_map(one, cache_specs, abstract_caches)


@dataclass(frozen=True)
class ActivationShardings:
    """The residual stream's spec between blocks (B, S, d); with sequence
    parallelism its sequence dim rides "model"."""
    residual: Optional[Spec] = None

    @staticmethod
    def for_mesh(mesh, batch: int, seq: int, d_model: int, *,
                 seq_shard: bool = True,
                 decode: bool = False) -> "ActivationShardings":
        ba = _entry(batch_axes(mesh))
        if decode or not seq_shard:
            res = (ba, None, None)
        else:
            res = (ba, "model", None)
        return ActivationShardings(
            residual=fit_pspec(mesh, res, (batch, seq, d_model)))


# ---------------------------------------------------------------------------
# specs as torch.distributed.tensor placements
# ---------------------------------------------------------------------------

def placements(spec: Spec, mesh) -> list:
    """One placement per mesh axis: ``Shard(d)`` where dim d of the spec
    names the axis, ``Replicate()`` elsewhere.  Several axes on one dim
    shard it in the mesh's axis order."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in mesh.axis_names]
    for d, entry in enumerate(spec):
        for a in entry_axes(entry):
            out[mesh.axis_names.index(a)] = Shard(d)
    return out


def local_chunk(t, placements_, device_mesh):
    """This rank's chunk of the full tensor ``t`` in ``placements_``
    (``torch.chunk`` order, as ``DTensor`` lays shards out): ``t`` itself
    where every axis it is sharded over has size one, else a copy."""
    from torch.distributed.tensor import Shard
    coord = device_mesh.get_coordinate()
    out = t
    for i, p in enumerate(placements_):
        if isinstance(p, Shard) and device_mesh.size(i) > 1:
            out = out.chunk(device_mesh.size(i), p.dim)[coord[i]]
    return out if out is t else out.clone()


def distribute(tree, spec_tree, mesh):
    """Each full tensor of ``tree`` as a ``DTensor`` in its spec's
    placements on ``mesh``.  Every rank holds the same full tensors and
    keeps its own chunk: no communication, and on axes of size one the
    chunk is the tensor itself (no copy)."""
    from torch.distributed.tensor import DTensor

    def one(spec, t):
        pl = placements(spec, mesh)
        return DTensor.from_local(
            local_chunk(t, pl, mesh.device_mesh), mesh.device_mesh, pl,
            run_check=False, shape=t.shape, stride=t.stride())
    return spec_map(one, spec_tree, tree)


def _gather_dtensor(x):
    """A DTensor's full tensor: its local chunk gathered over every mesh
    axis that shards it, the last axis first (``local_chunk``'s inverse)."""
    from torch.distributed.tensor import Shard
    dm = x.device_mesh
    t = x.to_local()
    for i in reversed(range(dm.ndim)):
        p = x.placements[i]
        if isinstance(p, Shard) and dm.size(i) > 1:
            t = C.all_gather(t, dm.get_group(i), p.dim)
    return t


def gather(tree):
    """Each ``DTensor`` of ``tree`` as its full tensor (all-gathers, none on
    axes of size one); other leaves as they are."""
    from torch.distributed.tensor import DTensor
    return tree_map(lambda x: _gather_dtensor(x) if isinstance(x, DTensor)
                    else x, tree)


def gather_batch(tree, spec_tree, mesh):
    """This rank's chunks of a tree (plain tensors) gathered whole over the
    batch axes their specs name (FSDP's ``"embed"`` dims), innermost axis
    first (``torch.chunk`` order's inverse), each rank keeping its
    ``model`` shards.  A dim that a batch axis and "model" shard together
    raises ``ValueError`` (the rules make none)."""
    ba = batch_axes(mesh)

    def one(spec, x):
        for d, entry in enumerate(spec):
            axes = [a for a in entry_axes(entry) if mesh.shape[a] > 1]
            if any(a in ba for a in axes) and any(a not in ba for a in axes):
                raise ValueError(f"{spec} shards a dim over batch and model "
                                 "axes together")
            for a in reversed([a for a in axes if a in ba]):
                x = C.all_gather(x, mesh.group(a), d)
        return x
    return spec_map(one, spec_tree, tree)


def _chunk(t, spec: Spec, mesh, keep) -> "torch.Tensor":
    coord = mesh.coordinate()
    for d, entry in enumerate(spec):
        for a in entry_axes(entry):
            if keep(a) and mesh.shape[a] > 1:
                t = t.chunk(mesh.shape[a], d)[coord[a]]
    return t


def batch_chunk(t, spec: Spec, mesh):
    """This rank's chunk of ``t`` over the batch axes of ``spec`` (the
    inverse of ``gather_batch``; a view)."""
    ba = batch_axes(mesh)
    return _chunk(t, spec, mesh, lambda a: a in ba)


def shard(tree, spec_tree, mesh):
    """This rank's chunk of each full tensor of ``tree`` by its spec, in
    ``torch.chunk`` order (views)."""
    return spec_map(lambda spec, t: _chunk(t, spec, mesh, lambda a: True),
                    spec_tree, tree)


def local(tree):
    """Each ``DTensor`` of ``tree`` as this rank's chunk."""
    from torch.distributed.tensor import DTensor
    return tree_map(lambda x: x.to_local() if isinstance(x, DTensor) else x,
                    tree)
