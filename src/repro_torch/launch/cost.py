"""The operations, bytes and peak memory of an eager step: the role of
``repro/launch/hlo_cost.py``, which counts them in compiled XLA HLO.

The port compiles nothing, so it counts a step as it runs, usually on the
meta device (shapes and dtypes, no storage, nothing computed):

* ``torch.utils.flop_counter.FlopCounterMode``'s formulas count the aten
  operations (matrix products, convolutions; ``matmul_flops`` are those
  of ``mm``, ``bmm``, ``addmm`` and ``baddbmm``), in one dispatch mode
  (``StepCounter``) with the two counts below: the three as separate modes
  cost three times the host time an operation.
* A hand-written kernel's launch is no aten operation, so each kernel
  adds its own count to ``kernels.ops.COSTS`` on every route, from its
  operands' shapes (the counts its bound in ``PERF.md`` is taken from): B5
  4 hd flop a live (query, key) pair and head, its backward 10 hd, B6 4 hd
  a live cache row and head; B1-B4 by bytes.
* ``StepCounter`` follows every storage an operation creates and frees
  (the meta device keeps their sizes), so its peak is the most bytes live
  at once, the step's arguments included; the caching allocator's rounding
  and the kernels' scratch are not in it.
* The collectives a step makes are counted where they dispatch, the
  in-place ``c10d`` operations (``launch/collectives.py``) and the
  functional ``_c10d_functional`` ones (DTensor's) alike, per kind in the
  units of the JAX package's ``hlo_cost.py``: an all-reduce twice its
  bytes (a ring goes both ways), an all-gather its output's bytes, a
  reduce-scatter its input's, an all-to-all its bytes.  On the meta device
  they run on a stand-in process group (the dry-run's), which moves
  nothing.

Python loops (a recurrent layer's time loop, grad_accum's micro-batches)
and remat's recompute in the backward are counted as they run, which is
what "loop-aware" meant for HLO.
"""
from __future__ import annotations

import weakref
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels._build import COSTS
from repro_torch.tree import tree_leaves

MATMUL_OPS = ("mm", "bmm", "addmm", "baddbmm")
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
# (kind, which bytes count, and how many times) of each collective op
_COLLECTIVE_OPS = {
    "allreduce_": ("all-reduce", "in", 2),
    "allreduce_coalesced_": ("all-reduce", "in", 2),
    "all_reduce": ("all-reduce", "in", 2),
    "all_reduce_": ("all-reduce", "in", 2),
    "all_reduce_coalesced": ("all-reduce", "in", 2),
    "allgather_": ("all-gather", "out", 1),
    "_allgather_base_": ("all-gather", "out", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", "out", 1),
    "all_gather_into_tensor": ("all-gather", "out", 1),
    "all_gather_into_tensor_coalesced": ("all-gather", "out", 1),
    "reduce_scatter_": ("reduce-scatter", "in", 1),
    "_reduce_scatter_base_": ("reduce-scatter", "in", 1),
    "reduce_scatter_tensor": ("reduce-scatter", "in", 1),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", "in", 1),
    "alltoall_": ("all-to-all", "in", 1),
    "alltoall_base_": ("all-to-all", "in", 1),
    "all_to_all_single": ("all-to-all", "in", 1),
}


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(a) for a in x)
    return 0


def collective_cost(func, args, out):
    """(kind, bytes) of one collective operation in ``hlo_cost.py``'s
    units, or None for any other operation.  The c10d in-place operations
    take their outputs first and their inputs second (all-reduce: the
    tensors), the functional ones their input first and return the
    output."""
    if func.namespace not in ("c10d", "_c10d_functional",
                              "c10d_functional"):
        return None
    got = _COLLECTIVE_OPS.get(func._overloadpacket.__name__)
    if got is None:
        return None
    kind, which, times = got
    if func.namespace == "c10d":
        if kind == "all-reduce":
            ins = outs = args[0]
        else:
            outs, ins = args[0], args[1]
    else:
        ins, outs = args[0], out
    return kind, times * _tensor_bytes(ins if which == "in" else outs)


def _key(x):
    """A hashable description of an operation's argument: a tensor by its
    layout (shape, strides, dtype, device), containers by their items."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype, x.device.type,
                x.storage_offset())
    if isinstance(x, (list, tuple)):
        return tuple(_key(a) for a in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _key(v)) for k, v in x.items()))
    if x is None or isinstance(x, (bool, int, float, str, torch.dtype,
                                   torch.device, torch.layout,
                                   torch.memory_format)):
        return (type(x), x)
    raise TypeError


def _layout(out):
    """The layouts of an operation's meta outputs (a tensor or a flat
    tuple or list of them), or None to run it again next time."""
    if isinstance(out, torch.Tensor):
        if out.device.type != "meta":
            return None
        return ("t", tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (tuple, list)) and all(
            isinstance(o, torch.Tensor) and o.device.type == "meta"
            for o in out):
        return (type(out), tuple(_layout(o) for o in out))
    return None


def _fresh(layout):
    if layout[0] == "t":
        _, shape, stride, dtype = layout
        return torch.empty_strided(shape, stride, dtype=dtype, device="meta")
    kind, parts = layout
    return kind(_fresh(p) for p in parts)


class StepCounter(TorchDispatchMode):
    """One dispatch mode that counts what a step runs: the FLOPs of each
    aten operation by ``FlopCounterMode``'s formulas (its
    ``flop_registry``), and the bytes of live storages and their peak
    (``track`` adds tensors made before it, the step's arguments).

    On the meta device it also remembers shapes: a functional operation
    (no view, nothing mutated) met again with arguments of the same
    layouts returns fresh empty outputs of the layouts its meta kernel gave
    before, without running that kernel again.  A time loop meets the same
    operations on the same shapes at every step, and the meta kernels of
    elementwise operations run in Python, so a full-length recurrent layer
    counts in seconds, not hours; the outputs are the meta kernel's (meta
    tensors hold no values)."""

    def __init__(self):
        super().__init__()
        self.flop_registry = FlopCounterMode(display=False).flop_registry
        self.flops: Dict[Any, int] = {}
        self.live = 0
        self.peak = 0
        self._storages: "weakref.WeakKeyDictionary" = (
            weakref.WeakKeyDictionary())
        self._shapes: Dict[Any, Any] = {}
        self.coll_bytes: Dict[str, int] = {k: 0 for k in COLLECTIVES}
        self.coll_count: Dict[str, int] = {k: 0 for k in COLLECTIVES}

    def track(self, tree) -> None:
        for x in tree_leaves(tree):
            if isinstance(x, torch.Tensor):
                self._add(x)

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._storages:
            return
        n = st.nbytes()
        self._storages[st] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def _run(self, func, args, kwargs):
        if func.is_view or func._schema.is_mutable:
            return func(*args, **kwargs)
        try:
            key = (func, _key(args), _key(kwargs))
        except TypeError:
            return func(*args, **kwargs)
        hit = self._shapes.get(key)
        if hit is not None:
            return _fresh(hit)
        out = func(*args, **kwargs)
        layout = _layout(out)
        if layout is not None:
            self._shapes[key] = layout
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs)
        coll = collective_cost(func, args, out)
        if coll is not None:
            self.coll_bytes[coll[0]] += coll[1]
            self.coll_count[coll[0]] += 1
        packet = func._overloadpacket
        if packet in self.flop_registry:
            if func._overloadname == "dtype":
                # mm.dtype / bmm.dtype: the output dtype comes third, where
                # the formulas (shape-wrapped) take no positional argument
                args = args[:2]
            self.flops[packet] = self.flops.get(packet, 0) + int(
                self.flop_registry[packet](*args, **kwargs, out_val=out))
        for x in tree_leaves(out) if isinstance(out, (list, tuple)) else [out]:
            if isinstance(x, torch.Tensor):
                self._add(x)
        return out


def count(fn, *args, track=None) -> Dict[str, Any]:
    """Run ``fn(*args)`` once and count it: {"flops": every counted flop
    (aten and kernels), "aten_flops", "matmul_flops" (aten's matrix
    products), "kernels": {name: {"flop", "bytes"}} from ``COSTS``,
    "kernel_flops", "peak_bytes" (live storages at most, ``track``'s trees
    included), "collective_bytes" and "collective_count" (per kind),
    "total_collective_bytes", "out": fn's result}."""
    before = dict(COSTS)
    counter = StepCounter()
    counter.track(track if track is not None else args)
    with counter:
        out = fn(*args)
    aten = int(sum(counter.flops.values()))
    matmul = int(sum(v for op, v in counter.flops.items()
                     if op.__name__ in MATMUL_OPS))
    kernels: Dict[str, Dict[str, int]] = {}
    for (name, what), v in COSTS.items():
        d = v - before.get((name, what), 0)
        if d:
            kernels.setdefault(name, {"flop": 0, "bytes": 0})[what] = int(d)
    kflops = sum(k["flop"] for k in kernels.values())
    return {"flops": aten + kflops, "aten_flops": aten,
            "matmul_flops": matmul, "kernels": kernels,
            "kernel_flops": kflops, "peak_bytes": int(counter.peak),
            "collective_bytes": dict(counter.coll_bytes),
            "collective_count": dict(counter.coll_count),
            "total_collective_bytes": int(sum(counter.coll_bytes.values())),
            "out": out}


def tree_bytes(tree) -> int:
    """The bytes of every tensor of a tree, as laid out (shapes only)."""
    return int(sum(x.numel() * x.element_size() for x in tree_leaves(tree)
                   if isinstance(x, torch.Tensor)))
