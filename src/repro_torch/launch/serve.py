"""Serving driver: batched prefill + greedy KV-cache decode, optionally split
across a simulated UE/edge boundary with the paper's codec on the handoff.
The port of ``repro/launch/serve.py``, on one device.

The driver feeds a ``MetricsRegistry`` (``core/telemetry.py``): prefill and
decode latency histograms, token and boundary-byte counters, and with
``--split`` a ``split_s`` histogram of the one-shot head + codec + tail;
``nonfinite_logits_total`` counts NaN or infinite logits, which a healthy
run keeps at 0.
``status(registry)`` is the dict a /status endpoint would serve;
``serve`` adds ``launches``, the kernel launches the run made by kernel
(``kernels/ops.LAUNCHES``; none on the CPU), and ``--status-out
status.json`` writes it after the run.  Weights and prompt
inputs are random, from a generator seeded with 0 on the run's device: token
ids, or for the stub frontends precomputed embeddings (musicgen's frames;
InternVL's ``n_frontend_tokens`` patches, counted in ``--prompt-len``, before
its text tokens).  A codebook model's greedy token is one per codebook, the
argmax of each head, fed back as (B, 1, ncb).  Every clock read that closes
device work follows a device synchronize.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --prompt-len 2048 --gen 32 --batch 4 --split 0.5
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-26b \\
        --prompt-len 2048 --gen 32 --batch 4 --split 0.5
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --reduced --device cpu --prompt-len 16 --gen 4 --batch 2 --split 0.5
"""
from __future__ import annotations

import argparse
import collections
import json
import time
from typing import Dict

SEED = 0


def make_registry():
    """The serving plane's registry: fixed-edge latency histograms (seconds)
    plus throughput counters.  Callers pass measured durations in; the
    registry itself never reads a clock."""
    from repro_torch.core.telemetry import MetricsRegistry

    reg = MetricsRegistry()
    reg.histogram("prefill_s")       # default fixed LATENCY_EDGES_S buckets
    reg.histogram("decode_step_s")
    reg.counter("tokens_generated_total")
    reg.counter("requests_total")
    reg.counter("boundary_raw_bytes_total")
    reg.counter("boundary_compressed_bytes_total")
    reg.counter("nonfinite_logits_total")
    return reg


def status(registry) -> Dict:
    """The status-path payload: run metadata + the full registry snapshot.
    JSON-serializable by construction."""
    snap = registry.snapshot()
    toks = snap["counters"].get("tokens_generated_total", 0)
    return {"status": "ok", "metrics": snap, "tokens_generated": toks}


def serve(args, registry=None) -> Dict:
    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.configs.base import InputShape
    from repro_torch.core.compression import ActivationCodec
    from repro_torch.core.splitting import LMSplitPlan, Workload, split_option
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_decode_step, build_prefill
    from repro_torch.models.registry import get_model

    dev = resolve_device(args.device)
    mesh = make_host_mesh(device=dev)
    before = collections.Counter(ops.LAUNCHES)

    def clock() -> float:
        """Host time after the device has finished the work queued so far."""
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    reg = registry if registry is not None else make_registry()

    def count_nonfinite(logits):
        reg.counter("nonfinite_logits_total").inc(
            int((~torch.isfinite(logits)).sum()))

    cfg = (get_reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    model = get_model(cfg, dev)
    max_len = args.prompt_len + args.gen
    shape = InputShape("cli", seq_len=args.prompt_len,
                       global_batch=args.batch, kind="prefill")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = model.init(gen)
    batch = model.concrete(model.prefill_inputs(shape), gen)
    reg.counter("requests_total").inc(args.batch)

    with torch.no_grad():
        if args.split > 0:
            # the paper's technique on the LM: head layers on the UE, the
            # boundary activation through the INT8+zlib codec, tail on the edge
            l = max(1, int(cfg.n_layers * args.split))
            plan = LMSplitPlan(cfg, params, candidates=(l,),
                               workload=Workload(n_tokens=args.prompt_len),
                               device=dev)
            codec = ActivationCodec(device=dev)
            t0 = clock()
            payload, _ = plan.head(batch, split_option(l))
            comp = codec.compress(payload)
            logits = plan.tail(codec.decompress(comp), split_option(l))
            dt = clock() - t0
            reg.histogram("split_s").observe(dt)
            count_nonfinite(logits)
            reg.counter("boundary_raw_bytes_total").inc(comp.raw_bytes)
            reg.counter("boundary_compressed_bytes_total").inc(
                comp.compressed_bytes)
            print(f"split at layer {l}/{cfg.n_layers}: boundary "
                  f"{comp.raw_bytes / 1e6:.2f} MB -> "
                  f"{comp.compressed_bytes / 1e6:.2f} MB "
                  f"({100 * (1 - comp.ratio):.1f}% reduction), "
                  f"one-shot latency {dt * 1e3:.0f} ms")

        prefill = build_prefill(cfg, shape, mesh=mesh, max_len=max_len)
        decode = build_decode_step(cfg, InputShape(
            "cli", seq_len=max_len, global_batch=args.batch, kind="decode"),
            mesh=mesh)
        placed = prefill.place(params)

        t0 = clock()
        logits, caches = prefill(placed, batch)
        t_prefill = clock() - t0
        reg.histogram("prefill_s").observe(t_prefill)
        count_nonfinite(logits)
        # (B, 1), or one token per codebook (B, 1, ncb) from (B, 1, ncb, V)
        tok = logits[:, -1:].argmax(dim=-1).to(torch.int32)
        outs = []
        t0 = clock()
        for i in range(args.gen):
            ts = clock()
            logits, caches = decode(placed, caches, {"tokens": tok},
                                    args.prompt_len + i)
            tok = logits[:, -1:].argmax(dim=-1).to(torch.int32)
            outs.append(tok[:, 0])
            reg.histogram("decode_step_s").observe(clock() - ts)
            count_nonfinite(logits)
            reg.counter("tokens_generated_total").inc(args.batch)
        t_dec = clock() - t0
    print(f"prefill {args.batch}x{args.prompt_len}: {t_prefill * 1e3:.0f} ms; "
          f"decode {args.gen} steps: {t_dec / max(args.gen, 1) * 1e3:.1f} ms/tok")
    if outs:
        print("sample tokens:", torch.stack(outs)[:8, 0].tolist())
    return {**status(reg),
            "launches": dict(collections.Counter(ops.LAUNCHES) - before)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--split", type=float, default=0.0,
                    help="fraction of layers on the UE side (0 = no split)")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: cuda (the kernels) or cpu "
                         "(their plain versions)")
    ap.add_argument("--status-out", default=None, metavar="STATUS.JSON",
                    help="write the status-path payload (metrics-registry "
                         "snapshot) here after the run")
    args = ap.parse_args(argv)

    payload = serve(args)
    if args.status_out:
        with open(args.status_out, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        print(f"status -> {args.status_out} "
              f"({payload['tokens_generated']} tokens)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
