"""B5's bf16 backward (the wgmma body) under other tiling constants: the
measurements behind the shape ``csrc/flash_attention_bwd.cu`` takes.

    python3 tools/b5b_tiles.py          # from the root of a checkout, on a card

Writes copies of ``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``
(with ``hopper.cuh`` beside them) with other constants of the wgmma body:
q rows a dK/dV step at hd <= 64 (``kDkdvBlockQ``), kv rows a dQ step
(``kDqBlockKV``), the stages of each ring (``kDkdvStages``,
``kDqStages``) and the registers setmaxnreg gives the producer and the
consumers.  Four probes change what the kernels compute or how they run
and are timed only, never checked (``PROBES``: what dK/dV's elementwise
work and its dK product cost, the consumers without their ping-pong, and
the grid in the other order).  Each copy is built with the repository's
nvcc flags into ``build/b5b_tiles/`` (one nvcc per copy, all started
together); the script prints the ptxas registers and spills of the hd 64 bf16 dK/dV and dQ
kernels and any note that ptxas serialised their wgmma, holds each copy
against ``flash_attention_bwd_plain`` at smollm-360m's train shape (q (8,
2048, 15, 64), kv 5 heads, bf16, causal; the kernel's own forward output
and log-sum-exp) within 1e-2 of each (batch row, head) slice's max, and
times it with CUDA events: the three kernels back to back, and the dK/dV
and dQ kernels each alone, twice in turns, beside SDPA's backward through
autograd.  It prints the card's name and power limit first and exits
non-zero without a card.
"""
from __future__ import annotations

import ctypes
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402  (its helpers; it imports no package)

OUT = ROOT / "build" / "b5b_tiles"
# name: (source text, replacement) pairs; the first is the source as it is
TILINGS = {
    "bq64_kv128_s3s4_r40": (),
    "bq64_kv64_s3s4_r40": (("kDqBlockKV = 128;", "kDqBlockKV = 64;"),),
    "bq32_kv128_s3s4_r40": (("kDkdvBlockQ = 64;", "kDkdvBlockQ = 32;"),),
    "bq64_kv128_s4s4_r40": (("kDkdvStages = 3;", "kDkdvStages = 4;"),),
    "bq64_kv128_s3s3_r40": (("kDqStages = 4;", "kDqStages = 3;"),),
    "bq64_kv128_s3s4_r24": (("kProducerRegs = 40;", "kProducerRegs = 24;"),
                            ("kConsumerRegs = 232;", "kConsumerRegs = 240;")),
}
# Probes change what the kernels compute or how they run and are timed only,
# never checked: dK/dV without its elementwise work, without the dK
# product; both kernels without the consumers' ping-pong, and with the
# grid's fastest dimension the tile index (each head's tiles side by side)
PROBES = {
    "probe_no_grads": (
        ("          s[4 * nb + e] = prob_ds<kCap>(s[4 * nb + e], e & 1 ? l2.y : l2.x, "
         "dp[4 * nb + e],\n                                        e & 1 ? d2.y : d2.x, "
         "sm_scale, softcap, ds);\n          dp[4 * nb + e] = ds;\n", ""),),
    "probe_no_dk": (
        ("        Wgmma<HD>::rs(dka, dsa[kk], smem_desc<kSw>(q_t + 16 * kk * kSw, "
         "Tile::kQBox, 8 * kSw));\n", ""),),
    "probe_no_pingpong": (
        ("bar_sync(my_turn, 256);", ""), ("bar_arrive(their_turn, 256);", ";"),
        ("bar_arrive(1, 256);", ";")),
    "probe_tiles_fastest": (
        ("const int j0 = blockIdx.z * kWgRows;", "const int j0 = blockIdx.x * kWgRows;"),
        ("(gridDim.z - 1 - blockIdx.z) * kWgRows;", "(gridDim.x - 1 - blockIdx.x) * kWgRows;"),
        ("  const int b = blockIdx.x;\n", "  const int b = blockIdx.z;\n"),
        ("const dim3 grid(a.B, a.KV, (a.S + kWgRows - 1) / kWgRows);",
         "const dim3 grid((a.S + kWgRows - 1) / kWgRows, a.KV, a.B);"),
        ("const dim3 grid(a.B, a.H, (a.S + kWgRows - 1) / kWgRows);",
         "const dim3 grid((a.S + kWgRows - 1) / kWgRows, a.H, a.B);")),
}


def edited_source(src: str, edits) -> str:
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"flash_attention_bwd.cu has no '{old}' to change")
        src = src.replace(old, new)
    return src


def main() -> int:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    if not torch.cuda.is_available():
        print("b5b_tiles: no CUDA card", file=sys.stderr)
        return 2
    print(CS.gpu_name_and_limit(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    shutil.copy(_build.CSRC / "hopper.cuh", OUT / "hopper.cuh")
    nvcc = _build._nvcc()
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
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
        serialised = set(re.findall(
            r"wgmma\.mma_async instructions are serialized.*?function "
            r"'([^']+)'", out))
        for fn, (regs, st, ld) in CS.ptxas_usage(out).items():
            if re.search(r"_wgmma_kernelILi64ELb0E", fn):
                entry = CS.bwd_instantiation(fn)[0]
                print(f"{name} {entry}<bf16, hd 64>: {regs} registers, {st} B "
                      f"spill stores, {ld} B spill loads"
                      + (", wgmma serialised" if fn in serialised else ""),
                      flush=True)

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
    for name in jobs:
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        fns = []
        for entry in fa.BWD_KERNELS:
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def launch(fn=fn, entry=entry, name=name):
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
        calls[name] = fns
        if name in PROBES:
            continue
        errs = []
        for a, r in zip(grads, ref):
            d = (a.double() - r.double()).abs().amax(dim=(1, 3))
            top = r.double().abs().amax(dim=(1, 3)).clamp_min(1e-30)
            errs.append(float((d / top).max()))
        if not max(errs) <= CS.BF16_TOL:
            raise AssertionError(f"{name}: dq/dk/dv slice errors {errs}")
    del ref
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    o_sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                            enable_gqa=True)
    go = dout.transpose(1, 2)
    for turn in (1, 2):
        for name, (d_pass, dkdv, dq) in calls.items():
            full = CS.cuda_ms(lambda: (d_pass(), dkdv(), dq()))
            print(f"turn {turn} B5 backward {name}: {full:.4f} ms back to back; "
                  f"dK/dV alone {CS.cuda_ms(dkdv):.4f} ms, dQ alone "
                  f"{CS.cuda_ms(dq):.4f} ms", flush=True)
        sdpa = CS.cuda_ms(lambda: torch.autograd.grad(
            o_sdpa, (qt, kt, vt), go, retain_graph=True))
        print(f"turn {turn} SDPA backward: {sdpa:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
