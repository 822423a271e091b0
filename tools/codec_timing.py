#!/usr/bin/env python3
"""Time the codec kernels B2 (encode) and B3 (decode) of one checkout of the
port on the card, at the stream lengths ``chip_smoke.py`` times them.

    python3 tools/codec_timing.py                         # this checkout
    python3 tools/codec_timing.py --src build/parent/src  # another checkout's src/

For each of ``chip_smoke.CODEC_LENGTHS`` (one split-1 UE frame, the
qwen3-1.7b split handoff, an 8-UE split2 cell group) it makes a stream of
normals (numpy, seed 0, times 3) and times B2 and B3 with delta off through
the checkout's wrappers, as ``chip_smoke.codec_times`` does: back to back,
each launch alone after a cold L2 (L2_FLUSH_BYTES written before it, as in
chip_smoke.py), and the wrapper's host time a call, beside the byte bound at
3.35 TB/s.  To compare two checkouts, run both in turns in one call on one card
(parent, change, change, parent): numbers from different calls may come
from different cards.  Prints one line per length and kernel, the card's
name and power limit, and a JSON object last.  Needs an NVIDIA card; builds
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
    if src not in Path(ck.__file__).resolve().parents:
        raise RuntimeError(f"imported {ck.__file__}, not from {src}")
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
    print(card)
    print(json.dumps({"src": str(src), "card": card, "codec": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
