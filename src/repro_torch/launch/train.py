"""Training driver: the port of ``repro/launch/train.py`` on one device,
with asynchronous checkpoints, restart and the straggler monitor.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --reduced --device cpu --steps 20 --seq 64 --batch 8
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --steps 20 --seq 2048 --batch 8 --grad-accum 2

The options are the JAX driver's, plus ``--device`` (the card by default;
it raises without one).  Weights are random, from a generator seeded with 0
on the run's device; batches come from the synthetic ``TokenStream`` (seed
0).  The optimizer warms up over max(steps // 20, 5) steps.  Each step line
reads ``step N loss L gnorm G lr R T ms``, with the host time of the step,
which ends in a device synchronize; then come the run's tokens a second
and, last, the kernel launches the run made by kernel
(``kernels/ops.LAUNCHES``; none on the CPU) as ``kernel launches: {JSON}``.

Two choices differ from the JAX driver, so that a resumed run continues the
straight one: a checkpoint is labelled with the number of steps it holds
(the JAX driver labels a periodic save with the index of the step just
run, which a resume then runs again), and a resumed run skips the batches
its checkpoint has consumed.  The on-disk layout is the JAX package's.

The run goes through ``make_host_mesh()``, as the JAX driver's does: a
one-rank group starts where none exists, and under ``torchrun`` every rank
of its group takes its rows of each batch (data-parallel; rank 0 prints
and writes the checkpoints).  On one card the mesh is 1 x 1 and the step
is the mesh-free step.

``main(argv)`` returns the run to a caller: {"steps": one dict per step
(step, loss, grad_norm, lr, ms), "tok_s", "checkpoint": the final path or
None, "params", "opt_state", "launches"}.
"""
from __future__ import annotations

import argparse
import collections
import itertools
import json
import time
from typing import Dict, Optional

SEED = 0


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    import torch
    import torch.distributed as dist

    from repro_torch import resolve_device
    from repro_torch.checkpoint import store as CK
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import ShardingRules, gather
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.registry import get_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.failures import StragglerMonitor

    dev = resolve_device(args.device)
    mesh = make_host_mesh(device=dev)
    lead = dist.get_rank() == 0
    before = collections.Counter(ops.LAUNCHES)

    def clock() -> float:
        """Host time after the device has finished the work queued so far."""
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    cfg = (get_reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    model = get_model(cfg, dev)
    shape = InputShape("cli", seq_len=args.seq, global_batch=args.batch,
                       kind="train")
    opt = AdamW(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                total_steps=args.steps)
    step_fn = build_train_step(cfg, shape, mesh=mesh, opt=opt,
                               grad_accum=args.grad_accum,
                               rules=ShardingRules())

    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    opt_state = opt.init(params)
    start = 0
    ckpt: Optional[CK.AsyncCheckpointer] = None
    if args.ckpt:
        ckpt = CK.AsyncCheckpointer(args.ckpt)
        if args.resume:
            last = CK.latest_step(args.ckpt)
            if last is not None:
                params, opt_state = CK.restore(args.ckpt, last,
                                               (params, opt_state), dev)
                start = last
                if lead:
                    print(f"resumed from step {last}")
    params, opt_state = step_fn.place(params, opt_state)

    stream = TokenStream(cfg, seq_len=args.seq, batch=args.batch, seed=SEED)
    straggler = StragglerMonitor(n_workers=1)
    steps = []
    t_start = clock()
    for step, batch in zip(range(start, args.steps),
                           itertools.islice(stream, start, None)):
        t0 = clock()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        dt = clock() - t0
        straggler.record(0, dt)
        steps.append({"step": step, "ms": dt * 1e3,
                      **{k: float(metrics[k]) for k in ("loss", "grad_norm",
                                                        "lr")}})
        if lead and (step % args.log_every == 0 or step == args.steps - 1):
            m = steps[-1]
            print(f"step {step:5d} loss {m['loss']:.4f} "
                  f"gnorm {m['grad_norm']:.3f} lr {m['lr']:.2e} "
                  f"{dt * 1e3:.0f} ms", flush=True)
        done = step + 1
        if ckpt and done % args.ckpt_every == 0 and done < args.steps:
            state = gather((params, opt_state))
            if lead:
                ckpt.save_async(state, done)
    params, opt_state = gather((params, opt_state))
    if ckpt and lead:
        ckpt.save_async((params, opt_state), args.steps)
        ckpt.wait()
        print(f"final checkpoint: {ckpt.last_path}")
    toks = (args.steps - start) * args.batch * args.seq
    tok_s = toks / (clock() - t_start)
    launches = dict(collections.Counter(ops.LAUNCHES) - before)
    if lead:
        print(f"done: {tok_s:.0f} tok/s")
        print(f"kernel launches: {json.dumps(launches, sort_keys=True)}")
    return {"steps": steps, "tok_s": tok_s,
            "checkpoint": ckpt.last_path if ckpt else None,
            "params": params, "opt_state": opt_state, "launches": launches}


if __name__ == "__main__":
    main()
