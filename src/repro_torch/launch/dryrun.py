"""Dry-run: build every (arch x shape) step on the meta device and record
what it costs one card, before any run.  The port of
``repro/launch/dryrun.py``, with ``launch/cost.py`` in place of compiling
and reading HLO.

For each cell the step (``build_step``) runs once on meta tensors: shapes
and dtypes, no storage and nothing computed, so a full-size cell takes
seconds and no device memory.  Per device it records the parameters and
active parameters, the tokens, the FLOPs (aten's counted by
``FlopCounterMode``, the hand-written kernels' from their own cost
functions), the argument and output bytes from the shapes, the peak of
live storages, and whether that peak fits the card (``launch/mesh.py``'s
H100).  ``long_500k`` is built for the sub-quadratic families and skipped
for the rest, as the JAX dry-run does; a failing cell keeps its error and
traceback.

``--mesh-shape data,model`` sets the mesh the numbers are per device of:
a rank's rows of the batch and its shards of the parameters and AdamW's
moments by the sharding rules.  The default is the card's own 1 x 1
mesh; ``model`` must be 1 (the port runs data-parallel only).  No process
group is started: the rules take the shape alone.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --jobs 4 --out build/dryrun.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
        --shape train_4k --mesh-shape 8,1
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


def _per_device_bytes(tree, specs, mesh) -> int:
    """The bytes of a tree's leaves on one rank, each divided by the mesh
    axes its spec shards it over."""
    from repro_torch.launch.sharding import entry_axes
    from repro_torch.tree import spec_map
    sizes = []

    def one(spec, x):
        n = x.numel() * x.element_size()
        for entry in spec:
            for a in entry_axes(entry):
                n //= mesh.shape[a]
        sizes.append(n)
    spec_map(one, specs, tree)
    return int(sum(sizes))


def run_cell(arch: str, shape, *, mesh_shape: Tuple[int, int] = (1, 1),
             grad_accum: int = 1, fsdp: bool = True,
             reduced: bool = False) -> Dict[str, Any]:
    """One cell: ``shape`` an ``InputShape`` or its name in
    ``SHAPES_BY_NAME``.  Returns the cell's record, status OK, SKIP or
    FAIL."""
    import torch
    from repro_torch.configs import (SHAPES_BY_NAME, count_active_params,
                                     count_params, get_config,
                                     get_reduced_config)
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import cost
    from repro_torch.launch.mesh import HBM_BYTES, Mesh
    from repro_torch.launch.sharding import (ShardingRules, batch_shardings,
                                             opt_state_shardings,
                                             param_shardings)
    from repro_torch.launch.steps import build_step
    from repro_torch.models.registry import META, MetaGenerator, get_model
    from repro_torch.optim.adamw import AdamW

    cfg = get_reduced_config(arch) if reduced else get_config(arch)
    if isinstance(shape, str):
        shape = SHAPES_BY_NAME[shape]
    data, model_par = mesh_shape
    cell: Dict[str, Any] = {
        "arch": arch, "shape": shape.name, "mesh": f"{data}x{model_par}",
        "kind": shape.kind, "status": "UNKNOWN", "grad_accum": grad_accum,
        "fsdp": fsdp, "reduced": reduced}
    if shape.name == "long_500k" and not cfg.sub_quadratic():
        cell.update(status="SKIP", reason=SKIP_REASON)
        return cell
    t0 = time.time()
    try:
        if model_par != 1:
            raise ValueError("the port runs data-parallel only: model must "
                             "be 1")
        # the rules read the axes' names and sizes only: no ranks
        mesh = Mesh(None, ("data", "model"), {"data": data,
                                              "model": model_par})
        rules = ShardingRules(fsdp=fsdp)
        model = get_model(cfg, META)
        params = model.abstract_params()
        pspecs = param_shardings(rules, model.spec(), params, mesh)
        bspecs = batch_shardings(mesh, model.train_inputs(shape))
        split = any(s and s[0] is not None for s in bspecs.values())
        rows = shape.global_batch // data if split else shape.global_batch
        local = InputShape(shape.name, shape.seq_len, rows, shape.kind)
        gen = MetaGenerator()
        if shape.kind == "train":
            opt = AdamW()
            opt_state = opt.init(params)
            ospecs = opt_state_shardings(rules, model.spec(), opt_state, mesh)
            batch = model.concrete(model.train_inputs(local), gen)
            step = build_step(cfg, local, opt=opt, grad_accum=grad_accum)
            args = (params, opt_state, batch)
            arg_bytes = (_per_device_bytes(params, pspecs, mesh)
                         + _per_device_bytes(opt_state, ospecs, mesh)
                         + cost.tree_bytes(batch))
            tokens = shape.global_batch * shape.seq_len
        elif shape.kind == "prefill":
            batch = model.concrete(model.prefill_inputs(local), gen)
            step = build_step(cfg, local)
            args = (params, batch)
            arg_bytes = (_per_device_bytes(params, pspecs, mesh)
                         + cost.tree_bytes(batch))
            tokens = shape.global_batch * shape.seq_len
        else:
            caches = model.abstract_cache(rows, shape.seq_len)
            batch = model.concrete(model.decode_inputs(local), gen)
            step = build_step(cfg, local)
            args = (params, caches, batch, shape.seq_len - 1)
            arg_bytes = (_per_device_bytes(params, pspecs, mesh)
                         + cost.tree_bytes(caches) + cost.tree_bytes(batch))
            tokens = shape.global_batch
        got = cost.count(step, *args, track=args[:-1]
                         if shape.kind == "decode" else args)
        out = got.pop("out")
        if shape.kind == "train":
            out_bytes = (arg_bytes - cost.tree_bytes(batch)
                         + cost.tree_bytes(out[2]))
        else:
            out_bytes = cost.tree_bytes(out)
        cell.update(
            status="OK", seconds=round(time.time() - t0, 2), n_devices=data,
            params=int(count_params(cfg)),
            active_params=int(count_active_params(cfg)),
            tokens=int(tokens), local_batch=rows,
            flops=got["flops"], aten_flops=got["aten_flops"],
            matmul_flops=got["matmul_flops"],
            kernel_flops=got["kernel_flops"], kernels=got["kernels"],
            memory={"argument_bytes": int(arg_bytes),
                    "output_bytes": int(out_bytes),
                    "peak_bytes": got["peak_bytes"]},
            fits_card=bool(got["peak_bytes"] <= HBM_BYTES))
    except Exception as e:  # a failure here is a fault of the port
        cell.update(status="FAIL", error=f"{type(e).__name__}: {e}",
                    traceback=traceback.format_exc()[-2000:],
                    seconds=round(time.time() - t0, 2))
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


def run_cells(todo, jobs: int = 1, **kw) -> List[Dict[str, Any]]:
    """``run_cell`` on every (arch, shape) of ``todo``, in this process or
    in a pool of ``jobs``; records in ``todo``'s order."""
    if jobs <= 1:
        return [run_cell(*c, **kw) for c in todo]
    pool, futs = submit_cells(todo, jobs, **kw)
    with pool:
        return [f.result() for f in futs]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh-shape", default="1,1",
                    help="data,model: the mesh the numbers are per device of")
    ap.add_argument("--out", default="build/dryrun.json")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells counted at once, one process each")
    args = ap.parse_args(argv)

    from repro_torch.configs import ARCH_IDS
    mesh_shape = tuple(int(x) for x in args.mesh_shape.split(","))
    if len(mesh_shape) != 2:
        ap.error("--mesh-shape takes data,model")
    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    todo = [(a, s) for a, s in cells(archs)
            if args.shape in ("all", s)]
    t0 = time.time()
    results = run_cells(todo, args.jobs, mesh_shape=mesh_shape,
                        grad_accum=args.grad_accum, fsdp=not args.no_fsdp)
    for cell in results:
        print(f"[{cell['status']:4s}] {cell['arch']:24s} {cell['shape']:12s} "
              f"{cell['mesh']:6s} t={cell.get('seconds', 0):6.2f}s "
              f"{cell.get('error', '')[:90]}", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    n = {k: sum(c["status"] == k for c in results)
         for k in ("OK", "SKIP", "FAIL")}
    print(f"\ndry-run: {n['OK']} OK, {n['SKIP']} SKIP, {n['FAIL']} FAIL in "
          f"{time.time() - t0:.1f} s -> {args.out}")
    return 1 if n["FAIL"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
