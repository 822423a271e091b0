"""B5's bf16 backward kernels under other tilings: the measurements behind
the shape ``csrc/flash_attention_bwd.cu`` takes.

    python3 tools/b5b_tiles.py          # from the root of a checkout, on a card

Writes copies of ``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``
with other tiling constants (warps a CTA, q rows a dK/dV step at hd <= 64,
kv rows a dQ step, ring stages, and the CTAs an SM each kernel's register
budget is set for), builds each with the repository's nvcc flags into
``build/b5b_tiles/`` (one nvcc per copy, all started together), prints the
ptxas registers and spills of the hd 64 bf16 dK/dV and dQ kernels, holds
each copy against ``flash_attention_bwd_plain`` at smollm-360m's train
shape (q (8, 2048, 15, 64), kv 5 heads, bf16, causal; the kernel's own
forward output and log-sum-exp) within 1e-2 of each (batch row, head)
slice's max, and times it with CUDA events: the three kernels back to back,
and the dK/dV and dQ kernels each alone, twice in turns.  It prints the
card's name and power limit first and exits non-zero without a card.
"""
from __future__ import annotations

import ctypes
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402  (its helpers; it imports no package)

OUT = ROOT / "build" / "b5b_tiles"
# (warps, q rows a dK/dV step, kv rows a dQ step, stages, dK/dV CTAs an SM,
#  dQ CTAs an SM); the first is the source as it is
TILINGS = ((4, 64, 32, 2, 2, 4), (4, 64, 64, 2, 2, 2), (4, 64, 64, 3, 3, 3),
           (4, 48, 32, 2, 2, 4), (4, 48, 32, 2, 3, 4), (4, 48, 32, 3, 3, 4),
           (4, 32, 32, 2, 3, 3), (8, 64, 64, 2, 1, 1))


def tiled_source(src: str, warps: int, bq: int, kv: int, stages: int,
                 dkdv_ctas: int, dq_ctas: int) -> str:
    for old, new in (("kTcWarps = 4;", f"kTcWarps = {warps};"),
                     ("kDkdvBlockQ = 64;", f"kDkdvBlockQ = {bq};"),
                     ("kDqBlockKV = 32;", f"kDqBlockKV = {kv};"),
                     ("kStages = 2;", f"kStages = {stages};"),
                     ("kDkdvCtas = 2;", f"kDkdvCtas = {dkdv_ctas};"),
                     ("kDqCtas = 4;", f"kDqCtas = {dq_ctas};")):
        if old not in src:
            raise RuntimeError(f"flash_attention_bwd.cu has no '{old}' to retile")
        src = src.replace(old, new)
    return src


def main() -> int:
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    if not torch.cuda.is_available():
        print("b5b_tiles: no CUDA card", file=sys.stderr)
        return 2
    print(CS.gpu_name_and_limit(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    names = ["w{}_bq{}_kv{}_s{}_c{}_{}".format(*t) for t in TILINGS]
    procs = {}
    for name, tiling in zip(names, TILINGS):
        (OUT / f"{name}.cu").write_text(tiled_source(src, *tiling))
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"),
             str(OUT / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}.cu failed:\n{out}")
        for fn, (regs, st, ld) in CS.ptxas_usage(out).items():
            if re.search(r"_tc_kernelILi64ELb0E", fn):
                entry = CS.bwd_instantiation(fn)[0]
                print(f"{name} {entry}<bf16, hd 64>: {regs} registers, {st} B "
                      f"spill stores, {ld} B spill loads", flush=True)

    B, S, H, KV, hd = CS.TRAIN_B, CS.TRAIN_S, 15, 5, 64
    g = torch.Generator().manual_seed(CS.SEED)
    bf16 = torch.bfloat16
    q, dout = (torch.randn((B, S, H, hd), generator=g).to("cuda", bf16)
               for _ in range(2))
    k, v = (torch.randn((B, S, KV, hd), generator=g).to("cuda", bf16)
            for _ in range(2))
    out, lse = fa.flash_attention_cuda(q, k, v, True, with_lse=True)
    ref = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, True)
    delta = torch.empty((B, H, S), dtype=torch.float32, device="cuda")
    grads = [torch.empty_like(x) for x in (q, k, v)]
    stream = torch.cuda.current_stream().cuda_stream
    calls = {}
    for name in names:
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        fns = []
        for entry in fa.BWD_KERNELS:
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def launch(fn=fn, entry=entry):
                # causal, no window, no cap, bf16
                rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                        delta.data_ptr(), *(x.data_ptr() for x in grads), B,
                        S, H, KV, hd, 1, 0, 0.0, 1, 1 / math.sqrt(hd), stream)
                if rc:
                    raise RuntimeError(f"{name} {entry}: cudaError_t {rc}")
            fns.append(launch)
        for f in fns:
            f()
        torch.cuda.synchronize()
        errs = []
        for a, r in zip(grads, ref):
            d = (a.double() - r.double()).abs().amax(dim=(1, 3))
            top = r.double().abs().amax(dim=(1, 3)).clamp_min(1e-30)
            errs.append(float((d / top).max()))
        if not max(errs) <= CS.BF16_TOL:
            raise AssertionError(f"{name}: dq/dk/dv slice errors {errs}")
        calls[name] = fns
    for turn in (1, 2):
        for name, (d_pass, dkdv, dq) in calls.items():
            full = CS.cuda_ms(lambda: (d_pass(), dkdv(), dq()))
            print(f"turn {turn} B5 backward {name}: {full:.4f} ms back to back; "
                  f"dK/dV alone {CS.cuda_ms(dkdv):.4f} ms, dQ alone "
                  f"{CS.cuda_ms(dq):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
