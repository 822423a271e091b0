"""Device meshes over a ``torch.distributed`` process group: the port of
``repro/launch/mesh.py``.

A ``Mesh`` names its axes (``("data", "model")`` or ``("pod", "data",
"model")``) and their sizes, and holds the ``DeviceMesh`` that
``torch.distributed.device_mesh.init_device_mesh`` built over the ranks of
the process group.  The sharding rules (``launch/sharding.py``) read only
``axis_names`` and ``shape``, so a stand-in with those two attributes
works there too.

Every function here starts from a process group: ``ensure_process_group``
starts a one-rank group where none exists (NCCL on a card, gloo on the
CPU, or the backend asked for; its rendezvous in a ``HashStore`` inside
this process, so no network), or joins the group ``torchrun`` describes in
its environment, each rank on the card ``LOCAL_RANK`` names.  A mesh also
holds the groups its collectives run over (``Mesh.group``): one per axis,
and ``"batch"``, the batch axes together.  Nothing is started when the
module is imported.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device

# -- hardware constants: one NVIDIA H100 80GB HBM3 (SXM), NVIDIA's data
# sheet, dense rates at the card's full 700 W power limit (a card set lower
# runs slower: read nvidia-smi's power.limit beside any measurement) -------
PEAK_FLOPS_BF16 = 989e12          # FLOP/s on the tensor cores
HBM_BW = 3.35e12                  # bytes/s of device memory
HBM_BYTES = 80e9                  # bytes of device memory

BATCH_AXES = ("pod", "data")      # the axes a batch's rows split over


@dataclass(frozen=True)
class Mesh:
    """Named mesh axes over the process group's ranks."""
    device_mesh: object               # torch.distributed DeviceMesh
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    groups: Dict[str, Any] = field(default_factory=dict)

    def group(self, name: str):
        """The process group of axis ``name``, or of ``"batch"`` (the batch
        axes together) or ``"mesh"`` (every rank); None where it holds one
        rank."""
        return self.groups.get(name)

    def group_over(self, axes) -> Any:
        """The group of the ranks that share every index but those on
        ``axes``, in the order ``torch.chunk`` deals a dim cut over them
        (the axes' sizes over one count): one axis's group, the batch axes'
        together, or every rank; None where they hold one rank (or on a
        stand-in mesh, which holds no groups)."""
        live = tuple(a for a in self.axis_names
                     if a in tuple(axes) and self.shape[a] > 1)
        if not live:
            return None
        if len(live) == 1:
            return self.group(live[0])
        if live == tuple(a for a in self.axis_names if self.shape[a] > 1):
            return self.group("mesh")
        if all(a in BATCH_AXES for a in live):
            return self.group("batch")
        raise ValueError(f"no group over the axes {axes} of {self.shape}")

    @property
    def device(self) -> torch.device:
        """The device this rank computes on."""
        if self.device_mesh.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.device_mesh.device_type)

    def coordinate(self) -> Dict[str, int]:
        """This rank's index on each axis (0 on a stand-in of one rank,
        which has no device mesh)."""
        if self.device_mesh is None:
            return {a: 0 for a in self.axis_names}
        return dict(zip(self.axis_names, self.device_mesh.get_coordinate()))


def ensure_process_group(device="cuda", backend=None) -> None:
    """Join or start the process group the meshes span.  Under ``torchrun``
    (``WORLD_SIZE`` in the environment) every rank joins its group through
    ``env://`` and takes the card ``LOCAL_RANK`` names; otherwise, where
    no group exists, a group of one rank starts here with a ``HashStore``.  The backend is ``backend``, by default NCCL for a
    CUDA device (which must exist: no card raises) and gloo for the CPU.
    A group that exists is kept."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if dist.is_initialized():
        return
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
        return
    # a rank alone: NCCL's bootstrap listens on loopback, reaching no host
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def _groups(dm, shape: Tuple[int, ...], axes: Tuple[str, ...]) -> dict:
    """Each axis's group (the device mesh's), ``"mesh"`` (every rank, where
    two axes or more are over one), and ``"batch"``: the ranks
    that share every other index, over the batch axes together (one axis
    over one rank alone: its group).  Every rank makes every batch group,
    in one order, as ``new_group`` asks; a group of one rank is left out
    (``Mesh.group`` gives None)."""
    import numpy as np
    groups = {a: dm.get_group(a) for a, n in zip(axes, shape) if n > 1}
    if len(groups) > 1:
        groups["mesh"] = dist.group.WORLD      # the mesh spans every rank
    batch = [a for a in axes if a in BATCH_AXES and a in groups]
    if len(batch) == 1:
        groups["batch"] = groups[batch[0]]
    elif batch:
        rest = [i for i, a in enumerate(axes) if a not in BATCH_AXES]
        ranks = np.moveaxis(np.arange(int(np.prod(shape))).reshape(shape),
                            rest, list(range(len(axes) - len(rest),
                                             len(axes))))
        n_rest = int(np.prod([shape[i] for i in rest]))
        groups["batch"], _ = dist.new_subgroups_by_enumeration(
            [list(map(int, r)) for r in ranks.reshape(-1, n_rest).T])
    return groups


def _mesh(device, shape: Tuple[int, ...], axes: Tuple[str, ...]) -> Mesh:
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    ensure_process_group(dev)
    dm = init_device_mesh(dev.type, shape, mesh_dim_names=axes)
    return Mesh(dm, axes, dict(zip(axes, shape)), _groups(dm, shape, axes))


def make_production_mesh(*, multi_pod: bool = False, strict: bool = False,
                         device="cuda") -> Mesh:
    """The production layout, 16 x 16 ranks (2 x 16 x 16 with
    ``multi_pod``), over the process group's ranks.

    A group with fewer ranks than the layout degrades as the JAX package's
    does: the same axis names, every rank on the data axis and the model
    and pod axes of size 1, so the rules still resolve.  ``strict`` raises
    instead."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    ensure_process_group(device)
    n = 1
    for d in shape:
        n *= d
    world = dist.get_world_size()
    if world != n:
        if strict:
            raise RuntimeError(f"need {n} ranks for mesh {shape}, the process "
                               f"group has {world}")
        shape = (1, world, 1) if multi_pod else (world, 1)
    return _mesh(device, shape, axes)


def make_host_mesh(model_parallel: int = 1, device="cuda") -> Mesh:
    """Every rank of the process group, as (data, model) with
    ``model_parallel`` ranks on the model axis where it divides the world
    (else 1): one card alone is the 1 x 1 mesh."""
    ensure_process_group(device)
    n = dist.get_world_size()
    mp = model_parallel if n % model_parallel == 0 else 1
    return _mesh(device, (n // mp, mp), ("data", "model"))


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device="cuda") -> Mesh:
    """The mesh ``shape`` over the process group's ranks, which must number
    its product (the dry-run's stand-in group has as many as it names)."""
    return _mesh(device, tuple(shape), tuple(axes))


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in BATCH_AXES)


def batch_ranks(mesh) -> int:
    """The ranks over the batch axes: the ways a batch splits."""
    n = 1
    for a in batch_axes(mesh):
        n *= mesh.shape[a]
    return n


def batch_index(mesh) -> Tuple[int, int]:
    """(this rank's index over the batch axes, their size): where its rows
    (or cells) lie in a split over the batch axes."""
    coord = mesh.coordinate()
    r = 0
    for a in batch_axes(mesh):
        r = r * mesh.shape[a] + coord[a]
    return r, batch_ranks(mesh)


def all_ranks(mesh, local: bool) -> bool:
    """True where ``local`` holds on every rank of the mesh (an all-reduce
    of one flag on the mesh's device)."""
    from repro_torch.launch.collectives import all_reduce
    t = torch.tensor([int(local)], dtype=torch.int32, device=mesh.device)
    return bool(all_reduce(t, dist.group.WORLD, "min").item())
