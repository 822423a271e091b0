"""B5's bf16 kernel (the wgmma body) under other tiling constants, and two
probes of where its time goes: the measurements behind B5's chosen shape.

    python3 tools/b5_tiles.py          # from the root of a checkout, on a card

Writes copies of ``src/repro_torch/kernels/csrc/flash_attention.cu`` (with
``hopper.cuh`` beside them) with other constants of the wgmma body: kv rows
a tile (``kWgBlockKV``), stages of the K and V rings (``kStages``) and the
registers setmaxnreg gives the producer and the consumers.  Two probes
change what the kernel computes and are timed only, never checked: one
drops the P_lo.V product (what the hi/lo split of P costs), one drops the
softmax from the main loop (the products and their pipeline alone).  Each
copy is built with the repository's nvcc flags into ``build/b5_tiles/``
(one nvcc per copy, all started together); every tiling is held against
the plain version within 1e-2 of each row's max, at the full-width prefill
shapes of qwen3-1.7b (q (4, 2048, 16, 128), k and v (4, 2048, 8, 128)) and
musicgen-medium (q and kv (4, 2048, 24, 64)), bf16, causal; then all are
timed with CUDA events beside scaled dot-product attention, twice in turns.
It prints the card's name and power limit first and exits non-zero without
a card.
"""
from __future__ import annotations

import ctypes
import math
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
OUT = ROOT / "build" / "b5_tiles"
TOL = 1e-2
SHAPES = {"qwen3-1.7b": (16, 8, 128), "musicgen-medium": (24, 24, 64)}
# name: (source text, replacement) pairs; the first is the source as it is
TILINGS = {
    "kv128_s2_r24": (),
    "kv128_s3_r24": (("kStages = 2;", "kStages = 3;"),),
    "kv64_s2_r24": (("kWgBlockKV = 128;", "kWgBlockKV = 64;"),),
    "kv64_s3_r24": (("kWgBlockKV = 128;", "kWgBlockKV = 64;"),
                    ("kStages = 2;", "kStages = 3;")),
    "kv128_s2_r40": (("kProducerRegs = 24;", "kProducerRegs = 40;"),
                     ("kConsumerRegs = 240;", "kConsumerRegs = 232;")),
}
PROBES = {
    "probe_no_p_lo": (("        Wgmma<HD>::rs(acc, p_lo[kk], vd);\n", ""),),
    "probe_no_softmax": (("      softmax((t_begin + i) * kBN, corr);\n",
                          "      corr[0] = corr[1] = 1.f;\n"),),
}


def cuda_ms(torch, fn, reps=10, runs=7):
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def edited_source(src: str, edits) -> str:
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"flash_attention.cu has no '{old.strip()}' "
                               "to change")
        src = src.replace(old, new)
    return src


def main() -> int:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    if not torch.cuda.is_available():
        print("b5_tiles: no CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    shutil.copy(_build.CSRC / "hopper.cuh", OUT / "hopper.cuh")
    nvcc = _build._nvcc()
    src = (_build.CSRC / "flash_attention.cu").read_text()
    jobs = {**TILINGS, **PROBES}
    procs = {}
    for name, edits in jobs.items():
        (OUT / f"{name}.cu").write_text(edited_source(src, edits))
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"),
             str(OUT / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}.cu failed:\n{out}")

    g = torch.Generator().manual_seed(0)
    data = {}
    for shape, (H, KV, hd) in SHAPES.items():
        q, k, v = (torch.randn(s, generator=g).to("cuda", torch.bfloat16)
                   for s in ((4, 2048, H, hd), (4, 2048, KV, hd),
                             (4, 2048, KV, hd)))
        data[shape] = (q, k, v)
    fns = {}
    for name in jobs:
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for shape, (H, KV, hd) in SHAPES.items():
            q, k, v = data[shape]

            def call(fn=fn, q=q, k=k, v=v, H=H, KV=KV, hd=hd, name=name):
                o = torch.empty_like(q)
                # no log-sum-exp, causal, no window, no cap, bf16
                rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                        None, 4, 2048, 2048, H, KV, hd, 1, 0, 0.0, 1,
                        1 / math.sqrt(hd),
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"{name}: cudaError_t {rc}")
                return o
            fns[(name, shape)] = call
    for shape, (q, k, v) in data.items():
        ref = fa.flash_attention_plain(q, k, v, True).double()
        for name in TILINGS:
            o = fns[(name, shape)]()
            d = (o.double() - ref).abs().amax(-1)
            rel = float((d / ref.abs().amax(-1).clamp_min(1e-30)).max())
            if not rel <= TOL:
                raise AssertionError(f"{name} at {shape}: worst row {rel} of "
                                     "its max")
        del ref
    for turn in (1, 2):
        for shape, (q, k, v) in data.items():
            for name in jobs:
                print(f"turn {turn} {shape} B5 {name}: "
                      f"{cuda_ms(torch, fns[(name, shape)]):.4f} ms", flush=True)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            sdpa = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
            print(f"turn {turn} {shape} sdpa: {sdpa:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
