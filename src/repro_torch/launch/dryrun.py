"""Dry-run: build every (arch x shape) step on the meta device and record
what it costs one card of a mesh, before any run.  The port of
``repro/launch/dryrun.py``, with ``launch/cost.py`` in place of compiling
and reading HLO.

For each cell the mesh step (``build_step(mesh=...)``'s ``local_fn``)
runs once on meta tensors, with rank 0's view of a stand-in process group
of every rank of the mesh (torch's ``"fake"`` backend: its collectives
move nothing): its chunks of the parameters and AdamW's moments by the
sharding rules, its rows of the batch.  Shapes and dtypes only, no storage
and nothing computed, so a full-size cell takes seconds and no device
memory.  Per device it records the parameters and active parameters, the
tokens, the FLOPs (aten's counted by ``FlopCounterMode``, the hand-written
kernels' from their own cost functions), the argument and output bytes
from the shapes, the peak of live storages, whether that peak fits the
card (``launch/mesh.py``'s H100), and the collectives the step makes, in
the JAX dry-run's keys and units (``collective_bytes`` and
``collective_count`` per kind, ``total_collective_bytes``).
``long_500k`` is built for the sub-quadratic families and skipped for the
rest, as the JAX dry-run does; a failing cell keeps its error and
traceback.  A decode cell takes the rank's chunks of the caches as
``cache_shardings`` places them (over "model", an attention cache on its
rows, so B6's partial mode counts the rank's rows and the combine its
all-gather).

A train cell counts the JAX package's default step, sequence-parallel
over "model" (``seq_shard``, recorded in the cell): each layer's
all-gather of the sequence at its entry and reduce-scatter at its exit,
and their conjugates in the backward, remat's replays included;
``--no-seq-shard`` counts the Megatron-TP step (the all-reduces of f and
g) instead.

``--out`` is rewritten as each cell completes (a crash keeps partial
results), and ``--resume`` keeps the cells already OK or SKIP there, keyed
by (arch, shape, mesh) as the JAX dry-run keys them, and counts only the
rest.  The JAX dry-run's ``--keep-hlo``, ``--hlo-dir`` and ``--reanalyze``
store and re-read XLA's HLO; the port compiles none, so they have no
counterpart.

``--mesh single|multi|both`` takes the production layouts, 16 x 16
(data, model) and 2 x 16 x 16 (pod, data, model), as the JAX dry-run
does; ``--mesh-shape`` any other (data,model or pod,data,model); without
either the card's own 1 x 1 mesh.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --jobs 4 --out build/dryrun.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
        --shape train_4k --mesh single
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

SKIP_REASON = ("full-attention arch at 524k decode is the quadratic regime "
               "the assignment excludes (DESIGN.md §4)")


MESHES = {"single": (16, 16), "multi": (2, 16, 16)}


def mesh_name(shape: Tuple[int, ...]) -> str:
    """A record's ``mesh``, as the JAX dry-run names it: "16x16"."""
    return "x".join(str(d) for d in shape)


def mesh_axes(shape: Tuple[int, ...]) -> Tuple[str, ...]:
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def _stand_in_mesh(shape: Tuple[int, ...]):
    """The mesh ``shape`` over a stand-in process group of its ranks, seen
    from rank 0 (torch's ``"fake"`` backend: collectives return at once and
    move nothing), and whether a group was started (the caller destroys
    it).  A mesh of one rank needs no group: every collective of its step
    is skipped."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import Mesh, make_mesh
    axes = mesh_axes(shape)
    n = 1
    for d in shape:
        n *= d
    if n == 1:
        return Mesh(None, axes, dict(zip(axes, shape))), False
    if dist.is_initialized():
        raise RuntimeError("the dry-run starts its own stand-in process "
                           "group over a mesh of several ranks; this process "
                           "has a group already (run the cell in a fresh "
                           "process: run_cells with jobs > 1)")
    dist.init_process_group("fake", rank=0, world_size=n, store=FakeStore())
    return make_mesh(shape, axes, device="cpu"), True


def _meta_like(tree):
    """A fresh meta tensor (storage of its own size) for each leaf."""
    import torch

    from repro_torch.models.registry import META
    from repro_torch.tree import tree_map
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device=META), tree)


def run_cell(arch: str, shape, *, mesh_shape: Tuple[int, ...] = (1, 1),
             grad_accum: int = 1, seq_shard: bool = True, fsdp: bool = True,
             reduced: bool = False) -> Dict[str, Any]:
    """One cell: ``shape`` an ``InputShape`` or its name in
    ``SHAPES_BY_NAME``; ``mesh_shape`` (data, model) or (pod, data,
    model); ``seq_shard`` the train step's (``build_train_step``).
    Returns the cell's record, status OK, SKIP or FAIL."""
    import torch.distributed as dist

    from repro_torch.configs import (SHAPES_BY_NAME, count_active_params,
                                     count_params, get_config,
                                     get_reduced_config)
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import cost
    from repro_torch.launch.mesh import HBM_BYTES, batch_ranks
    from repro_torch.launch.sharding import (ShardingRules, batch_shardings,
                                             cache_shardings, param_shardings,
                                             shard)
    from repro_torch.launch.steps import build_step
    from repro_torch.models.registry import META, MetaGenerator, get_model
    from repro_torch.optim.adamw import AdamW

    cfg = get_reduced_config(arch) if reduced else get_config(arch)
    if isinstance(shape, str):
        shape = SHAPES_BY_NAME[shape]
    mesh_shape = tuple(mesh_shape)
    n_dev = 1
    for d in mesh_shape:
        n_dev *= d
    cell: Dict[str, Any] = {
        "arch": arch, "shape": shape.name,
        "mesh": mesh_name(mesh_shape),
        "kind": shape.kind, "status": "UNKNOWN", "grad_accum": grad_accum,
        "seq_shard": seq_shard, "fsdp": fsdp, "reduced": reduced}
    if shape.name == "long_500k" and not cfg.sub_quadratic():
        cell.update(status="SKIP", reason=SKIP_REASON)
        return cell
    t0 = time.time()
    started = False
    try:
        mesh, started = _stand_in_mesh(mesh_shape)
        rules = ShardingRules(fsdp=fsdp)
        model = get_model(cfg, META)
        full = model.abstract_params()
        pspecs = param_shardings(rules, model.spec(), full, mesh)
        params = _meta_like(shard(full, pspecs, mesh))
        del full
        bspecs = batch_shardings(mesh, model.train_inputs(shape))
        split = any(s and s[0] is not None for s in bspecs.values())
        rows = (shape.global_batch // batch_ranks(mesh) if split
                else shape.global_batch)
        local = InputShape(shape.name, shape.seq_len, rows, shape.kind)
        gen = MetaGenerator()
        if shape.kind == "train":
            opt = AdamW()
            opt_state = opt.init(params)
            batch = model.concrete(model.train_inputs(local), gen)
            step = build_step(cfg, shape, mesh=mesh, rules=rules, opt=opt,
                              grad_accum=grad_accum, seq_shard=seq_shard)
            args = (params, opt_state, batch)
            tokens = shape.global_batch * shape.seq_len
        elif shape.kind == "prefill":
            batch = model.concrete(model.prefill_inputs(local), gen)
            step = build_step(cfg, shape, mesh=mesh, rules=rules)
            args = (params, batch)
            tokens = shape.global_batch * shape.seq_len
        else:
            step = build_step(cfg, shape, mesh=mesh, rules=rules)
            full_caches = model.abstract_cache(shape.global_batch,
                                               shape.seq_len)
            caches = _meta_like(shard(full_caches, cache_shardings(
                mesh, full_caches), mesh))
            del full_caches
            batch = model.concrete(model.decode_inputs(local), gen)
            args = (params, caches, batch, shape.seq_len - 1)
            tokens = shape.global_batch
        tracked = args[:-1] if shape.kind == "decode" else args
        arg_bytes = cost.tree_bytes(tracked)
        got = cost.count(step.local_fn, *args, track=tracked)
        out = got.pop("out")
        if shape.kind == "train":
            out_bytes = (arg_bytes - cost.tree_bytes(batch)
                         + cost.tree_bytes(out[2]))
        else:
            out_bytes = cost.tree_bytes(out)
        cell.update(
            status="OK", seconds=round(time.time() - t0, 2), n_devices=n_dev,
            params=int(count_params(cfg)),
            active_params=int(count_active_params(cfg)),
            tokens=int(tokens), local_batch=rows,
            flops=got["flops"], aten_flops=got["aten_flops"],
            matmul_flops=got["matmul_flops"],
            kernel_flops=got["kernel_flops"], kernels=got["kernels"],
            memory={"argument_bytes": int(arg_bytes),
                    "output_bytes": int(out_bytes),
                    "peak_bytes": got["peak_bytes"]},
            fits_card=bool(got["peak_bytes"] <= HBM_BYTES),
            collective_bytes=got["collective_bytes"],
            collective_count=got["collective_count"],
            total_collective_bytes=got["total_collective_bytes"])
    except Exception as e:  # a failure here is a fault of the port
        cell.update(status="FAIL", error=f"{type(e).__name__}: {e}",
                    traceback=traceback.format_exc()[-2000:],
                    seconds=round(time.time() - t0, 2))
    finally:
        if started:
            dist.destroy_process_group()
    return cell


def cells(arch_ids, reduced: bool = False) -> List[Tuple[str, str]]:
    """Every (arch, shape name) the dry-run builds: a config's shapes, and
    ``long_500k`` for the rest (skipped)."""
    from repro_torch.configs import get_config, get_reduced_config
    out = []
    for arch in arch_ids:
        cfg = get_reduced_config(arch) if reduced else get_config(arch)
        names = [s.name for s in cfg.shapes()]
        if not cfg.sub_quadratic():
            names.append("long_500k")
        out += [(arch, n) for n in names]
    return out


def _init_worker(nice: int) -> None:
    import torch
    torch.set_num_threads(1)
    os.nice(nice)


def submit_cells(todo, jobs: int, nice: int = 0, **kw):
    """Start ``run_cell`` on every (arch, shape[, keywords]) of ``todo`` in
    a pool of ``jobs`` spawned processes, one thread each, niced by
    ``nice`` (to count beside other work on idle cores); the recurrent
    family's long time loops go first.  Returns (pool, futures in
    ``todo``'s order).  The caller reads every future and shuts the pool
    down."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.configs import get_config
    pool = ProcessPoolExecutor(jobs, mp_context=mp.get_context("spawn"),
                               initializer=_init_worker, initargs=(nice,))
    order = sorted(range(len(todo)),
                   key=lambda i: get_config(todo[i][0]).family != "ssm")
    futs = {i: pool.submit(run_cell, *todo[i][:2],
                           **{**kw, **(todo[i][2] if len(todo[i]) > 2 else {})})
            for i in order}
    return pool, [futs[i] for i in range(len(todo))]


def run_cells(todo, jobs: int = 1, on_done=None,
              **kw) -> List[Dict[str, Any]]:
    """``run_cell`` on every (arch, shape[, keywords]) of ``todo``, in this
    process or in a pool of ``jobs``; records in ``todo``'s order.
    ``on_done(i, record)`` is called as each cell completes, ``i`` its
    index in ``todo``."""
    out: List[Optional[Dict[str, Any]]] = [None] * len(todo)

    def done(i, cell):
        out[i] = cell
        if on_done is not None:
            on_done(i, cell)
    if jobs <= 1:
        for i, c in enumerate(todo):
            done(i, run_cell(*c[:2], **{**kw, **(c[2] if len(c) > 2 else {})}))
        return out
    from concurrent.futures import as_completed
    pool, futs = submit_cells(todo, jobs, **kw)
    index = {f: i for i, f in enumerate(futs)}
    with pool:
        for f in as_completed(futs):
            done(index[f], f.result())
    return out


def cell_key(cell: Dict[str, Any]) -> Tuple[str, str, str]:
    """A record's key, as the JAX dry-run keys ``--resume``: (arch, shape
    name, mesh)."""
    return cell["arch"], cell["shape"], cell["mesh"]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    help="the production layouts: 16x16, 2x16x16, or both")
    ap.add_argument("--mesh-shape", default=None,
                    help="data,model or pod,data,model: another mesh the "
                         "numbers are per device of (default 1,1)")
    ap.add_argument("--out", default="build/dryrun.json")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--no-seq-shard", action="store_true",
                    help="train cells without sequence parallelism (the "
                         "residual whole on each rank of \"model\")")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells counted at once, one process each")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells already OK/SKIP in --out")
    args = ap.parse_args(argv)

    from repro_torch.configs import ARCH_IDS
    if args.mesh and args.mesh_shape:
        ap.error("--mesh and --mesh-shape exclude each other")
    if args.mesh:
        meshes = [MESHES[m] for m in (("single", "multi")
                                      if args.mesh == "both" else (args.mesh,))]
    else:
        meshes = [tuple(int(x) for x in (args.mesh_shape or "1,1").split(","))]
    if any(len(m) not in (2, 3) for m in meshes):
        ap.error("--mesh-shape takes data,model or pod,data,model")
    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    todo = [(a, s, {"mesh_shape": m}) for m in meshes
            for a, s in cells(archs) if args.shape in ("all", s)]
    prior: Dict[Tuple[str, str, str], Dict[str, Any]] = {}
    if args.resume and os.path.exists(args.out):
        with open(args.out) as f:
            prior = {cell_key(c): c for c in json.load(f)}
    results: List[Optional[Dict[str, Any]]] = []
    for a, s, kw in todo:
        c = prior.get((a, s, mesh_name(kw["mesh_shape"])))
        results.append(c if c and c["status"] in ("OK", "SKIP") else None)
    rest = [i for i, c in enumerate(results) if c is None]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    def done(j, cell):
        """Record a completed cell and rewrite --out (a crash keeps partial
        results): the cells done so far, in ``todo``'s order."""
        results[rest[j]] = cell
        print(f"[{cell['status']:4s}] {cell['arch']:24s} {cell['shape']:12s} "
              f"{cell['mesh']:8s} t={cell.get('seconds', 0):6.2f}s "
              f"coll={cell.get('total_collective_bytes', 0):.3e}B "
              f"{cell.get('error', '')[:80]}", flush=True)
        with open(args.out, "w") as f:
            json.dump([c for c in results if c is not None], f, indent=1)
    t0 = time.time()
    run_cells([todo[i] for i in rest], args.jobs, on_done=done,
              grad_accum=args.grad_accum, seq_shard=not args.no_seq_shard,
              fsdp=not args.no_fsdp)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    n = {k: sum(c["status"] == k for c in results)
         for k in ("OK", "SKIP", "FAIL")}
    print(f"\ndry-run: {n['OK']} OK, {n['SKIP']} SKIP, {n['FAIL']} FAIL in "
          f"{time.time() - t0:.1f} s -> {args.out}")
    return 1 if n["FAIL"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
