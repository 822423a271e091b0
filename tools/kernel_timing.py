#!/usr/bin/env python3
"""Time one group of kernels of one checkout of the port on the card, at the
sizes ``chip_smoke.py`` times them.

    python3 tools/kernel_timing.py codec                  # this checkout
    python3 tools/kernel_timing.py attention --src build/parent/src
    python3 tools/kernel_timing.py backward --src build/parent/src
    python3 tools/kernel_timing.py window --src build/parent/src

``codec``: B2 (encode) and B3 (decode), then the quant pair B4a (quant) and
B4b (dequant).  For each of ``chip_smoke.CODEC_LENGTHS`` (one split-1 UE
frame, the qwen3-1.7b split handoff, an 8-UE split2 cell group) it makes a
stream of normals (numpy, seed 0, times 3) and times B2 and B3 with delta
off through the checkout's wrappers, as ``chip_smoke.codec_times`` does:
back to back, each launch alone after a cold L2 (L2_FLUSH_BYTES written
before it, as in chip_smoke.py), and the wrapper's host time a call, beside
the byte bound at 3.35 TB/s.  Then it makes the split-1 payload's two leaves
(``chip_smoke.SPLIT1_LEAVES``, normals from the same generator, times 3)
and times B4a and B4b over them, one launch per leaf, as
``chip_smoke.quant_times`` does (also cold with the card held after the
flush, so that no host time enters), and reads the kernels' own device time
from a torch.profiler trace, warm and after the flush.

``attention``: B5 (flash attention) at qwen3-1.7b's prefill shape (q (4,
2048, 16, 128), kv 8 heads, bf16, causal) and B6 (flash decode) at its
decode shape (q (4, 1, 16, 128) against a (4, 8, 2080, 128) bf16 cache at
kv_len 2048), on normals from a torch generator seeded with 0: back to back
(``chip_smoke.cuda_ms``), B6 also with each launch alone after a cold L2,
and each kernel's own device time in a trace (B6's the sum over its
kernels: two a call before its one-launch body).  Where the checkout's
wrappers take ``logit_softcap``, the same with a cap of 50.0.  Where B6's
wrapper takes ``return_lse`` (its partial mode), that mode on the first
half of ``chip_smoke.b6_partial_inputs``' cache as a rank of (1, 2) holds
it, beside the default mode on the whole: back to back, device alone (warm,
and cold for the partial mode), and each wrapper's host time a call
(``chip_smoke.host_us``).

``backward``: B5's backward (its three kernels: D, dK/dV, dQ) at phase 17
(e)'s shape, smollm-360m's train shape (q (8, 2048, 15, 64), kv 5 heads,
bf16, causal), on normals from a torch generator seeded with 0 and the
kernel's own forward output and log-sum-exp: the three back to back
(``chip_smoke.cuda_ms``), each kernel's own device time from one trace,
beside SDPA's backward through autograd at the same shape (the forward
outside the timed window, as phase 17 (e) times it) and the bound (10 flop
a live pair per hd at 989 TFLOP/s).

``window``: B1 (fused window attention) per frame, the 12 calls of one
Swin-T forward (``chip_smoke.b1_frame``: each stage's unshifted and shifted
blocks with their masks), at batch 1 (a UE's head) and 4 (a batched tail),
f32 and bf16, on normals from a torch generator seeded with 0: back to back
(``chip_smoke.cuda_ms``), queued behind a spin so that no host time enters
(``chip_smoke.cuda_ms(queued=True)``), the kernel's own device time in a trace, each
call alone after a cold L2, and the wrapper's host time a call (stage 3,
shifted), beside the bound (bytes at 3.35 TB/s, by ``fused_cost``).

To compare two checkouts, run both in turns in one call on one card
(parent, change, change, parent): numbers from different calls may come
from different cards.  Prints one line per size or case and kernel, the
card's name and power limit, and a JSON object last.  Needs an NVIDIA card;
builds the checkout's kernels into its own build/.
"""
from __future__ import annotations

import argparse
import importlib
import inspect
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402  (its helpers; it imports no package)

ROUNDS = 20                 # rounds of the calls in a device-time trace
CAP = 50.0                  # Gemma 2's attn_logit_softcapping
# B5's bf16 kernel by name: the wgmma body, and the mma.sync body of a
# checkout from before it (so that --src may name either)
B5_BF16_KERNELS = ("flash_attention_wgmma_kernel", "flash_attention_tc_kernel")


def device_ms(fns, match, before=None) -> float:
    """The device time of the events whose name holds ``match`` (a string,
    or a tuple of strings any of which may match) in one round of ``fns``
    (each after ``before()`` if given): their durations in a torch.profiler
    trace of ROUNDS rounds, over ROUNDS.  No launch latency and no host time
    enters."""
    matches = (match,) if isinstance(match, str) else tuple(match)

    def rounds():
        for _ in range(ROUNDS):
            for f in fns:
                if before is not None:
                    before()
                f()
    _, _, by_name = CS.traced_busy_ms(matches[0], rounds)
    return sum(ms for name, ms in by_name.items()
               if any(m in name for m in matches)) / ROUNDS


def codec(ck, qk, dev, flush) -> dict:
    import torch
    block = 8192
    rng = np.random.default_rng(CS.SEED)
    results = {}
    for what, total in CS.CODEC_LENGTHS.items():
        flat = torch.from_numpy(
            rng.standard_normal(total, dtype=np.float32) * 3).to(dev)
        nbytes = CS.codec_bytes(total, block)
        bound = nbytes / CS.HBM_BYTES_PER_S * 1e3
        t = CS.codec_times(ck, flat, block, flush)
        for name, r in t.items():
            print(f"{what} ({total} f32) B{2 if name == 'encode' else 3}: "
                  f"{r['ms']:.4f} ms back to back, {r['cold_ms']:.4f} ms cold "
                  f"L2 ({r['cold_ms'] / bound:.2f}x the bound), wrapper "
                  f"{r['host_us']:.1f} us a call; bound {bound:.4f} ms "
                  f"({nbytes} B)", flush=True)
        results[what] = dict(total=total, bound_ms=bound, **t)
    leaves = [torch.from_numpy(
        rng.standard_normal(shape, dtype=np.float32) * 3).to(dev)
        for shape in CS.SPLIT1_LEAVES]
    nbytes = CS.quant_bytes(leaves, block)
    bound = nbytes / CS.HBM_BYTES_PER_S * 1e3
    t = CS.quant_times(qk, leaves, block, flush)
    quantised = [qk.quant_cuda(x, block) for x in leaves]
    calls = {"quant": [lambda x=x: qk.quant_cuda(x, block) for x in leaves],
             "dequant": [lambda x=x, r=r: qk.dequant_cuda(*r, tuple(x.shape))
                         for x, r in zip(leaves, quantised)]}
    for name, fns in calls.items():
        match = f"::{name}_kernel("     # "quant_kernel" alone is in both
        t[name].update(device_ms=device_ms(fns, match),
                       device_cold_ms=device_ms(fns, match, before=flush))
    for name, r in t.items():
        print(f"split-1 leaves {CS.SPLIT1_LEAVES} "
              f"B4{'a' if name == 'quant' else 'b'}: {r['ms']:.4f} ms back to "
              f"back, {r['cold_ms']:.4f} ms cold L2, {r['held_ms']:.4f} ms "
              f"cold and held ({r['held_ms'] / bound:.2f}x the bound), "
              f"wrappers {r['host_us']:.1f} us for the leaves; the kernel "
              f"alone on the device (trace) {r['device_ms']:.4f} ms warm, "
              f"{r['device_cold_ms']:.4f} ms cold; bound {bound:.4f} ms "
              f"({nbytes} B)", flush=True)
    results["split-1 leaves"] = dict(shapes=CS.SPLIT1_LEAVES, bound_ms=bound,
                                     **t)
    return results


def attention(fa, da, dev, flush) -> dict:
    import torch
    g = torch.Generator().manual_seed(0)

    def rnd(shape):
        return torch.randn(shape, generator=g).to(dev, torch.bfloat16)

    B, S, H, KV, hd = CS.LM_BATCH, CS.LM_PROMPT, 16, 8, 128
    q, k, v = rnd((B, S, H, hd)), rnd((B, S, KV, hd)), rnd((B, S, KV, hd))
    qd = rnd((B, 1, H, hd))
    ck_, cv_ = rnd((B, KV, S + CS.LM_GEN, hd)), rnd((B, KV, S + CS.LM_GEN, hd))
    lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    capped = "logit_softcap" in inspect.signature(
        fa.flash_attention_cuda).parameters
    results = {}
    for cap in (0.0, CAP) if capped else (0.0,):
        kw = {"logit_softcap": cap} if cap else {}
        b5 = lambda: fa.flash_attention_cuda(q, k, v, True, **kw)
        b6 = lambda: da.decode_attention_cuda(qd, ck_, cv_, lens, **kw)
        name = f"cap {cap}" if cap else "no cap"
        r = {"b5_ms": CS.cuda_ms(b5),
             # the bf16 body's kernel by its name in this checkout or in
             # one before the wgmma body (--src of an older checkout)
             "b5_device_ms": device_ms([b5], B5_BF16_KERNELS),
             "b6_ms": CS.cuda_ms(b6),
             "b6_cold_ms": CS.cuda_ms(b6, before=flush),
             "b6_device_ms": device_ms([b6], "decode_"),
             "b6_cold_device_ms": device_ms([b6], "decode_", before=flush)}
        results[name] = r
        if "return_lse" in inspect.signature(
                da.decode_attention_cuda).parameters and not cap:
            r.update(b6_partial(da, dev, flush))
        print(f"B5 q {tuple(q.shape)} kv {tuple(k.shape)} bf16 causal, "
              f"{name}: {r['b5_ms']:.4f} ms back to back, device alone "
              f"{r['b5_device_ms']:.4f} ms", flush=True)
        print(f"B6 q {tuple(qd.shape)} cache {tuple(ck_.shape)} kv_len {S} "
              f"bf16, {name}: {r['b6_ms']:.4f} ms back to back, "
              f"{r['b6_cold_ms']:.4f} ms cold L2; device alone (every B6 "
              f"kernel) {r['b6_device_ms']:.4f} ms warm, "
              f"{r['b6_cold_device_ms']:.4f} ms cold", flush=True)
    return results


def b6_partial(da, dev, flush) -> dict:
    """B6's partial mode on the first half of phase 6's bf16 cache beside
    the default mode on the whole (``chip_smoke.b6_partial_inputs``)."""
    import torch
    q, ck_, cv_, lens, halves = CS.b6_partial_inputs(dev, torch.bfloat16)
    n = ck_.shape[2] // 2
    live = halves[0][1]
    k_, v_ = ck_[:, :, :n].contiguous(), cv_[:, :, :n].contiguous()
    part = lambda: da.decode_attention_cuda(q, k_, v_, live, 0.0, True)
    whole = lambda: da.decode_attention_cuda(q, ck_, cv_, lens)
    r = {"lse_ms": CS.cuda_ms(part), "lse_device_ms": device_ms([part],
                                                                "decode_"),
         "lse_cold_device_ms": device_ms([part], "decode_", before=flush),
         "lse_host_us": CS.host_us(part), "whole_ms": CS.cuda_ms(whole),
         "whole_device_ms": device_ms([whole], "decode_"),
         "whole_host_us": CS.host_us(whole)}
    print(f"B6 partial mode q {tuple(q.shape)} on {tuple(k_.shape)}, live "
          f"rows {live.tolist()} bf16: {r['lse_ms']:.4f} ms back to back, "
          f"device alone (every B6 kernel) {r['lse_device_ms']:.4f} ms warm, "
          f"{r['lse_cold_device_ms']:.4f} ms cold, wrapper "
          f"{r['lse_host_us']:.1f} us a call; the default mode on "
          f"{tuple(ck_.shape)}, live rows {lens.tolist()}: "
          f"{r['whole_ms']:.4f} ms, device alone {r['whole_device_ms']:.4f} "
          f"ms, wrapper {r['whole_host_us']:.1f} us", flush=True)
    return {f"b6_partial_{k}": v for k, v in r.items()}


def backward(fa, dev, flush) -> dict:
    import torch
    import torch.nn.functional as F
    g = torch.Generator().manual_seed(CS.SEED)
    B, S, H, KV, hd = CS.TRAIN_B, CS.TRAIN_S, 15, 5, 64
    bf16 = torch.bfloat16
    q, dout = (torch.randn((B, S, H, hd), generator=g).to(dev, bf16)
               for _ in range(2))
    k, v = (torch.randn((B, S, KV, hd), generator=g).to(dev, bf16)
            for _ in range(2))
    out, lse = fa.flash_attention_cuda(q, k, v, True, with_lse=True)
    flops, nbytes = fa.backward_cost(q.shape, k.shape, q.element_size())
    bwd = lambda: fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, True)
    r = {"ms": CS.cuda_ms(bwd),
         "bound_ms": max(flops / CS.BF16_FLOP_PER_S,
                         nbytes / CS.HBM_BYTES_PER_S) * 1e3}

    def rounds():
        for _ in range(ROUNDS):
            bwd()
    _, _, by_name = CS.traced_busy_ms("B5 backward", rounds)
    for name in fa.BWD_KERNELS:
        r[f"{name}_device_ms"] = sum(
            ms for ev, ms in by_name.items() if name in ev) / ROUNDS
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    o_sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                            enable_gqa=True)
    r["sdpa_ms"] = CS.cuda_ms(lambda: torch.autograd.grad(
        o_sdpa, (qt, kt, vt), dout.transpose(1, 2), retain_graph=True))
    print(f"B5 backward q {tuple(q.shape)} kv {tuple(k.shape)} bf16 causal: "
          f"{r['ms']:.4f} ms back to back (3 kernels); device alone "
          + ", ".join(f"{n.split('_')[-1]} {r[n + '_device_ms']:.4f} ms"
                      for n in fa.BWD_KERNELS)
          + f"; SDPA backward {r['sdpa_ms']:.4f} ms; bound "
          f"{r['bound_ms']:.4f} ms", flush=True)
    return r


def window(wa, dev, flush) -> dict:
    import functools
    import torch
    from repro_torch.configs.swin_t_detection import CONFIG as cfg
    g = torch.Generator().manual_seed(CS.SEED)
    w2 = cfg.window ** 2
    results = {}
    for dt in (torch.float32, torch.bfloat16):
        for B in (1, CS.N_UES):
            calls, nbytes, cold = [], 0, 0.0
            for s, Hp, Wp, C, nh, shift, mask, n in CS.b1_frame(cfg, dev):
                qkv = torch.randn((B, Hp, Wp, 3 * C), generator=g).to(dev, dt)
                bias = torch.randn((nh, w2, w2), generator=g).to(dev)
                call = functools.partial(wa.fused_window_attention_cuda, qkv,
                                         bias, mask, window=cfg.window,
                                         shift=shift, n_heads=nh)
                calls += [call] * n
                nbytes += n * wa.fused_cost(qkv.shape, qkv.element_size(), nh,
                                            cfg.window, mask is not None)[1]
                cold += n * CS.cuda_ms(call, before=flush)
            frame = lambda: [f() for f in calls]
            r = {"ms": CS.cuda_ms(frame),
                 "queued_ms": CS.cuda_ms(frame, queued=True),
                 "device_ms": device_ms([frame], "fused_window_attention"),
                 "cold_ms": cold, "host_us": CS.host_us(calls[-1]),
                 "bound_ms": nbytes / CS.HBM_BYTES_PER_S * 1e3}
            name = f"{str(dt).removeprefix('torch.')} batch {B}"
            results[name] = r
            print(f"B1 per frame ({len(calls)} calls), {name}: {r['ms']:.4f} ms "
                  f"back to back, {r['queued_ms']:.4f} ms queued behind a spin, "
                  f"device alone (trace) {r['device_ms']:.4f} ms, "
                  f"{r['cold_ms']:.4f} ms each call after a cold L2; wrapper "
                  f"{r['host_us']:.1f} us a call; bound {r['bound_ms']:.4f} ms "
                  f"({nbytes} B)", flush=True)
    return results


# group -> (wrapper modules, passed to the timing function in order;
#           csrc/*.cu sources to build; the timing function)
GROUPS = {"codec": (("codec", "quant"), ("codec",), codec),
          "attention": (("flash_attention", "decode_attention"),
                        ("flash_attention", "decode_attention"), attention),
          "backward": (("flash_attention",),
                       ("flash_attention", "flash_attention_bwd"), backward),
          "window": (("window_attention",), ("window_attention",), window)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("group", choices=sorted(GROUPS))
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory of the checkout to time")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_timing: needs an NVIDIA card", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build
    modules, sources, run = GROUPS[args.group]
    mods = [importlib.import_module(f"repro_torch.kernels.{m}")
            for m in modules]
    for mod in mods:
        if src not in Path(mod.__file__).resolve().parents:
            raise RuntimeError(f"imported {mod.__file__}, not from {src}")
    _build.build(sources)
    dev = torch.device("cuda")
    card = CS.gpu_name_and_limit()
    l2_flush = torch.empty(CS.L2_FLUSH_BYTES // 4, dtype=torch.float32,
                           device=dev)
    results = run(*mods, dev, lambda: l2_flush.fill_(1.0))
    print(card, flush=True)
    print(json.dumps({"src": str(src), "card": card, args.group: results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
