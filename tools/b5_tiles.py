"""B5's bf16 tensor-core kernel under other tilings, and the rate mma.sync
reaches on the card: the measurements behind B5's chosen shape.

    python3 tools/b5_tiles.py          # from the root of a checkout, on a card

Part 1 times a loop of independent mma.sync m16n8k16 bf16 products (the
instruction B5 issues) at 128 and 256 threads a CTA and 1, 2 or 4 CTAs an
SM, and prints TFLOP/s.  Part 2 writes copies of
``src/repro_torch/kernels/csrc/flash_attention.cu`` with other tiling
constants (warps a CTA, kv rows a tile, K/V ring stages, CTAs an SM), builds
each with the repository's nvcc flags into ``build/b5_tiles/`` (one nvcc per
copy, all started together), holds each against the plain version at the
full-width prefill shape of qwen3-1.7b (q (4, 2048, 16, 128), k and v
(4, 2048, 8, 128), bf16, causal) within 1e-2 of each row's max, and times
it with CUDA events beside scaled dot-product attention, twice in turns.
It prints the card's name and power limit first and exits non-zero
without a card.
"""
from __future__ import annotations

import ctypes
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
OUT = ROOT / "build" / "b5_tiles"
TOL = 1e-2
# (warps, kv rows a tile, stages, CTAs an SM); the first is the source as it is
TILINGS = ((4, 64, 2, 2), (8, 64, 2, 1), (4, 32, 3, 2), (4, 32, 4, 2),
           (8, 64, 3, 1), (4, 64, 3, 1), (8, 32, 4, 1))
MMA_LOOP = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int N>
__global__ void mma_loop(float* out, int iters) {
  uint32_t a[4] = {threadIdx.x, 3u, 5u, 7u}, b0 = threadIdx.x ^ 9u, b1 = 11u;
  float acc[N][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int n = 0; n < N; ++n)
      asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                   "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                   : "+f"(acc[n][0]), "+f"(acc[n][1]), "+f"(acc[n][2]), "+f"(acc[n][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  float s = 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) s += acc[n][0] + acc[n][1] + acc[n][2] + acc[n][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(float* out, int blocks, int threads, int iters) {
  mma_loop<16><<<blocks, threads>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


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


def tiled_source(src: str, warps: int, kv: int, stages: int, ctas: int) -> str:
    for old, new in (("kTcWarps = 4;", f"kTcWarps = {warps};"),
                     ("kTcBlockKV = 64;", f"kTcBlockKV = {kv};"),
                     ("kStages = 2;", f"kStages = {stages};"),
                     ("__launch_bounds__(kTcThreads, 2)",
                      f"__launch_bounds__(kTcThreads, {ctas})")):
        if old not in src:
            raise RuntimeError(f"flash_attention.cu has no '{old}' to retile")
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
    nvcc = _build._nvcc()
    src = (_build.CSRC / "flash_attention.cu").read_text()
    jobs = {"mma_loop": MMA_LOOP}
    jobs.update({f"w{w}_kv{kv}_s{s}_c{c}": tiled_source(src, w, kv, s, c)
                 for w, kv, s, c in TILINGS})
    procs = {}
    for name, text in jobs.items():
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"),
             str(OUT / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}.cu failed:\n{out}")

    lib = ctypes.CDLL(str(OUT / "mma_loop.so"))
    lib.run.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    buf = torch.empty(sms * 4 * 256, device="cuda")
    for threads in (128, 256):
        for per_sm in (1, 2, 4):
            blocks, iters = sms * per_sm, 4096
            ms = cuda_ms(torch, lambda: lib.run(buf.data_ptr(), blocks, threads,
                                                iters), reps=1, runs=5)
            flop = blocks * threads // 32 * iters * 16 * 2 * 16 * 8 * 16
            print(f"mma.sync m16n8k16 bf16: {threads} threads x {per_sm} CTAs "
                  f"an SM: {flop / ms / 1e9:.1f} TFLOP/s", flush=True)

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g).to("cuda", torch.bfloat16)
               for s in ((4, 2048, 16, 128), (4, 2048, 8, 128), (4, 2048, 8, 128)))
    ref = fa.flash_attention_plain(q, k, v, True)
    fns = {}
    for w, kv, s, c in TILINGS:
        name = f"w{w}_kv{kv}_s{s}_c{c}"
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def call(fn=fn):
            o = torch.empty_like(q)
            # no log-sum-exp, causal, no window, no cap, bf16
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    None, 4, 2048, 2048, 16, 8, 128, 1, 0, 0.0, 1,
                    1 / math.sqrt(128), torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{name}: cudaError_t {rc}")
            return o
        o = call()
        d = (o.double() - ref.double()).abs().amax(-1)
        rel = float((d / ref.double().abs().amax(-1).clamp_min(1e-30)).max())
        if not rel <= TOL:
            raise AssertionError(f"{name}: worst row {rel} of its max")
        fns[name] = call
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    for turn in (1, 2):
        for name, call in fns.items():
            print(f"turn {turn} B5 {name}: {cuda_ms(torch, call):.4f} ms",
                  flush=True)
        sdpa = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        print(f"turn {turn} sdpa: {sdpa:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
