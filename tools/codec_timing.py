#!/usr/bin/env python3
"""Time the codec kernels B2 (encode) and B3 (decode) and the quant pair B4a
(quant) and B4b (dequant) of one checkout of the port on the card, at the
sizes ``chip_smoke.py`` times them.

    python3 tools/codec_timing.py                         # this checkout
    python3 tools/codec_timing.py --src build/parent/src  # another checkout's src/

For each of ``chip_smoke.CODEC_LENGTHS`` (one split-1 UE frame, the
qwen3-1.7b split handoff, an 8-UE split2 cell group) it makes a stream of
normals (numpy, seed 0, times 3) and times B2 and B3 with delta off through
the checkout's wrappers, as ``chip_smoke.codec_times`` does: back to back,
each launch alone after a cold L2 (L2_FLUSH_BYTES written before it, as in
chip_smoke.py), and the wrapper's host time a call, beside the byte bound at
3.35 TB/s.  Then it makes the split-1 payload's two leaves
(``chip_smoke.SPLIT1_LEAVES``, normals from the same generator, times 3)
and times B4a and B4b over them, one launch per leaf, as
``chip_smoke.quant_times`` does (also cold with the card held after the
flush, so that no host time enters), and reads the kernels' own device
time from a torch.profiler trace, warm and after the flush.  To compare two checkouts, run both in
turns in one call on one card (parent, change, change, parent): numbers
from different calls may come from different cards.  Prints one line per
size and kernel, the card's name and power limit, and a JSON object last.  Needs an NVIDIA card; builds
the checkout's kernels into its own build/.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402  (its helpers; it imports no package)

ROUNDS = 20                 # rounds over the leaves in a device-time trace


def kernel_device_ms(fns, kernel: str, before=None) -> float:
    """The device time of the kernel named ``kernel`` in one round of
    ``fns`` (each after ``before()`` if given): the durations of its events
    in a torch.profiler trace of ROUNDS rounds, over ROUNDS.  No launch
    latency and no host time enters."""
    def rounds():
        for _ in range(ROUNDS):
            for f in fns:
                if before is not None:
                    before()
                f()
    _, _, by_name = CS.traced_busy_ms(kernel, rounds)
    return sum(ms for name, ms in by_name.items()
               if f"::{kernel}(" in name) / ROUNDS


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory of the checkout to time")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("codec_timing: needs an NVIDIA card", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build
    from repro_torch.kernels import codec as ck
    from repro_torch.kernels import quant as qk
    for mod in (ck, qk):
        if src not in Path(mod.__file__).resolve().parents:
            raise RuntimeError(f"imported {mod.__file__}, not from {src}")
    _build.build(("codec",))
    dev = torch.device("cuda")
    card = CS.gpu_name_and_limit()
    block = 8192
    l2_flush = torch.empty(CS.L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    flush = lambda: l2_flush.fill_(1.0)
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
        t[name].update(device_ms=kernel_device_ms(fns, f"{name}_kernel"),
                       device_cold_ms=kernel_device_ms(
                           fns, f"{name}_kernel", before=flush))
    for name, r in t.items():
        print(f"split-1 leaves {CS.SPLIT1_LEAVES} "
              f"B4{'a' if name == 'quant' else 'b'}: {r['ms']:.4f} ms back to "
              f"back, {r['cold_ms']:.4f} ms cold L2, {r['held_ms']:.4f} ms "
              f"cold and held ({r['held_ms'] / bound:.2f}x the bound), wrappers "
              f"{r['host_us']:.1f} us for the leaves; the kernel alone on the "
              f"device (trace) {r['device_ms']:.4f} ms warm, "
              f"{r['device_cold_ms']:.4f} ms cold; bound {bound:.4f} ms "
              f"({nbytes} B)", flush=True)
    results["split-1 leaves"] = dict(shapes=CS.SPLIT1_LEAVES, bound_ms=bound, **t)
    print(card)
    print(json.dumps({"src": str(src), "card": card, "codec": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
