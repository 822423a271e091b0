"""B1's wgmma body (the persistent window-attention kernel) under other
values of its levers, three probes of where its time goes and a cycle count
of a tile's phases: the measurements behind B1's chosen shape.

    python3 tools/b1_tiles.py          # from the root of a checkout, on a card

Writes copies of ``src/repro_torch/kernels/csrc/window_attention.cu`` (with
``hopper.cuh`` beside them) into ``build/b1_tiles/`` with text of the body
replaced: the consumer warpgroups a CTA (``wg_consumers``), the CTAs an SM
(the launch bounds and the grid), the stages of each consumer's ring
(``kWgRing``; a layout past the shared memory a CTA may have is refused at
launch, and the variant is reported and dropped) and TMA boxes for the
windows that do not wrap against 16-byte cp.async pieces for every window
(``by_tma``).  Three probes change what the kernel computes and are timed
only, never checked: loads and stores alone, no bias or mask loads, no P.V.
A last copy counts the cycles of each phase of a consumer's tile
(``clock64`` marks summed over tiles and CTAs, read back through an extra C
entry point, ``b1_probe_clocks``).  Each copy is built with the
repository's nvcc flags (one nvcc per copy, all started together).  Every
variant that computes B1 is held against the plain version (f32 within
1e-4, bf16 within 1e-2 of each head's row max) at the batch-4 Swin-T stage
shapes, f32 and bf16; then all are timed with CUDA events, back to back,
over the 12 calls of one batch-4 forward (``chip_smoke.b1_frame``), twice
in turns (forward order, then reversed).  Prints the card's name and power
limit first, one line per variant and dtype, and a JSON object last; exits
non-zero without a card or if a variant disagrees.
"""
from __future__ import annotations

import ctypes
import json
import math
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402  (its helpers; it imports no package)

OUT = ROOT / "build" / "b1_tiles"
BATCH = 4
CONSUMERS = "  return sizeof(T) == 4 ? 2 : 3;\n"
RING = "constexpr int kWgRing = 2;"
TMA = "  return row0 + window <= Hp && col0 + window <= Wp;\n"
BOUNDS = "__launch_bounds__(wg_threads<T>(), 1)"
GRID = "const int grid = tiles < sms ? tiles : sms;"
BIAS = "    if (h != cur_h) {\n"
# name: (source text, replacement) pairs; the first is the source as it is
VARIANTS = {
    "as_built": (),
    "ring_1": ((RING, "constexpr int kWgRing = 1;"),),
    "ring_3": ((RING, "constexpr int kWgRing = 3;"),),
    "consumers_1": ((CONSUMERS, "  return 1;\n"),),
    "consumers_2": ((CONSUMERS, "  return 2;\n"),),
    "consumers_3": ((CONSUMERS, "  return 3;\n"),),
    "consumers_1_ctas_2": (
        (CONSUMERS, "  return 1;\n"),
        (BOUNDS, "__launch_bounds__(wg_threads<T>(), 2)"),
        (GRID, "const int grid = tiles < 2 * sms ? tiles : 2 * sms;")),
    "cp_async_only": ((TMA, "  return false;\n"),),
}
PROBES = {
    "probe_loads_and_stores": (
        (BIAS, "    if (false) {\n"),
        ("    // the mask: one bit for each logit of this thread it forbids\n",
         "    if (true) {\n      __syncwarp();\n"
         "      if (lane == 0) mbar_arrive(empty(st));\n    } else {\n"),
        ("    }\n\n    // O / sum straight from the registers",
         "    }\n    }\n\n    // O / sum straight from the registers")),
    "probe_no_bias_or_mask": (
        (BIAS, "    if (false) {\n"),
        ("      if (masked) {\n        // the window's w2 x w2 bytes",
         "      if (false) {\n        // the window's w2 x w2 bytes"),
        ("    if (masked) {\n      // bytes past the window's",
         "    if (false) {\n      // bytes past the window's")),
    "probe_no_pv": (
        ("      for (int it = wq; it < 2 * G::kPieces; it += 4) {",
         "      for (int it = wq; it < 0; it += 4) {"),
        ("        WgmmaTf32<HD>::rs(o, el[j], vh);\n"
         "        WgmmaTf32<HD>::rs(o, eh[j], vl);\n"
         "        WgmmaTf32<HD>::rs(o, eh[j], vh);\n", ""),
        ("        Wgmma<HD>::rs(o, eh[kk], vd);\n"
         "        Wgmma<HD>::rs(o, el[kk], vd);\n", "")),
}
# the clock probe: thread 0 of each consumer marks clock64 after each phase
# of a tile; the sums over tiles and CTAs, and the tiles, land in b1_clocks
CLOCK_DEFS = """__device__ unsigned long long b1_clocks[9];
#define B1_MARK(k)                     \\
  do {                                 \\
    if (tid == 0) {                    \\
      const long long now = clock64(); \\
      marks[k] += now - mark;          \\
      mark = now;                      \\
    }                                  \\
  } while (0)

"""
CLOCK_READ = """extern "C" int b1_probe_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, b1_clocks, sizeof(b1_clocks));
  if (err == cudaSuccess) {
    const unsigned long long zero[9] = {};
    err = cudaMemcpyToSymbol(b1_clocks, zero, sizeof(zero));
  }
  return static_cast<int>(err);
}

"""
STORE = ("        put2(dst + 8 * d, o[4 * d + 2 * e] * inv[e], "
         "o[4 * d + 2 * e + 1] * inv[e]);\n    }\n")
CLOCKS = (
    ("constexpr int kWgConsumers = 128;",
     CLOCK_DEFS + "constexpr int kWgConsumers = 128;"),
    ("  int cur_h = -1;\n",
     "  int cur_h = -1;\n  long long marks[8] = {};\n"
     "  long long mark = clock64();\n"),
    ("      fence_proxy_async();                  // cp.async rows before "
     "wgmma reads them\n",
     "      fence_proxy_async();\n    B1_MARK(0);\n"),
    ("    float s[N / 2];\n", "    B1_MARK(1);\n    float s[N / 2];\n"),
    ("      // q scaled by hd^-1/2 in f32 and split",
     "      B1_MARK(2);\n      // q scaled by hd^-1/2 in f32 and split"),
    ("      // S += Q K^T as 3xTF32",
     "      B1_MARK(3);\n      // S += Q K^T as 3xTF32"),
    ("    // the mask (-1e9, the reference's NEG_INF)",
     "    B1_MARK(4);\n    // the mask (-1e9, the reference's NEG_INF)"),
    ("      inv[r] = 1.f / t4;\n    }\n",
     "      inv[r] = 1.f / t4;\n    }\n    B1_MARK(5);\n"),
    ("    }\n\n    // O / sum straight from the registers",
     "    }\n    B1_MARK(6);\n\n    // O / sum straight from the registers"),
    (STORE + "  }\n}\n",
     STORE + "    B1_MARK(7);\n  }\n  if (tid == 0) {\n"
     "    for (int k = 0; k < 8; ++k)\n"
     "      atomicAdd(&b1_clocks[k], static_cast<unsigned long long>(marks[k]));\n"
     "    atomicAdd(&b1_clocks[8], static_cast<unsigned long long>("
     "(t_end - t_begin - cw + NC - 1) / NC));\n  }\n}\n"),
    ('extern "C" int window_attention_fwd(',
     CLOCK_READ + 'extern "C" int window_attention_fwd('),
)
PHASES = ("wait for the stage", "mask bits", "K, V split (f32)",
          "q fragments, release (f32)", "S", "softmax", "P.V", "stores")


def edited_source(src: str, edits) -> str:
    """src with each (old, new) replaced; old must occur once."""
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"window_attention.cu holds '{old.strip()}' "
                               f"{src.count(old)} times, not once")
        src = src.replace(old, new)
    return src


def build(jobs) -> dict:
    """One nvcc per copy, all at once; {name: library path or None}."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    shutil.copy(_build.CSRC / "hopper.cuh", OUT / "hopper.cuh")
    src = (_build.CSRC / "window_attention.cu").read_text()
    procs = {}
    for name, edits in jobs.items():
        cu, lib = OUT / f"{name}.cu", OUT / f"{name}.so"
        cu.write_text(edited_source(src, edits))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"{name}: nvcc failed\n{out[-4000:]}", flush=True)
            libs[name] = None
            continue
        for line in out.splitlines():
            if "serialized" in line or ("spill" in line and " 0 bytes spill" not in line):
                print(f"  {name}: {line.strip()[-160:]}", flush=True)
        libs[name] = lib
    return libs


def entry(lib: Path):
    fn = ctypes.CDLL(str(lib)).fused_window_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def call(fn, qkv, bias, mask, out, window, shift, nh):
    """The wrapper's launch, on a variant's library."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import window_attention as wa
    B, Hp, Wp, C3 = qkv.shape
    rc = fn(qkv.data_ptr(), bias.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(), B, Hp,
            Wp, C3 // 3, nh, window, shift, wa.WINDOW_DTYPE_CODES[qkv.dtype],
            1.0 / math.sqrt(C3 // 3 // nh), _build.current_stream(qkv.device))
    if rc != 0:
        raise RuntimeError(f"launch failed with cudaError_t {rc}")
    return out


def clocks(lib: Path, cases, window) -> dict:
    """Cycles of each phase of a consumer's tile a call, from the clock
    probe's library: {"stage/shift": {phase: cycles a tile}}."""
    import torch
    fn = entry(lib)
    read = ctypes.CDLL(str(lib)).b1_probe_clocks
    read.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * 9)()
    out = {}
    for s, qkv, bias, mask, o, shift, nh, _ in cases:
        call(fn, qkv, bias, mask, o, window, shift, nh)   # warm
        torch.cuda.synchronize()
        read(ctypes.addressof(buf))
        call(fn, qkv, bias, mask, o, window, shift, nh)
        torch.cuda.synchronize()
        if read(ctypes.addressof(buf)) != 0:
            raise RuntimeError("b1_probe_clocks failed")
        tiles = max(buf[8], 1)
        row = {ph: buf[k] / tiles for k, ph in enumerate(PHASES)}
        out[f"{s}/{shift}"] = row
        print(f"clocks {str(qkv.dtype)[6:]} stage {s} shift {shift} "
              f"({tiles} consumer tiles): " + ", ".join(
                  f"{ph} {c:.0f}" for ph, c in row.items())
              + f"; total {sum(row.values()):.0f} cycles a tile", flush=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("b1_tiles: needs an NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch.configs.swin_t_detection import CONFIG as cfg
    from repro_torch.kernels import window_attention as wa
    card = CS.gpu_name_and_limit()
    print(card, flush=True)
    libs = build({**VARIANTS, **PROBES, "probe_clocks": CLOCKS})
    clocks_lib = libs.pop("probe_clocks")
    dev = torch.device("cuda")
    frame = CS.b1_frame(cfg, dev)
    g = torch.Generator().manual_seed(CS.SEED)
    results, bad = {}, []
    for dt in (torch.float32, torch.bfloat16):
        name_dt = str(dt).removeprefix("torch.")
        cases = []
        for s, Hp, Wp, C, nh, shift, mask, n in frame:
            qkv = torch.randn((BATCH, Hp, Wp, 3 * C), generator=g).to(dev, dt)
            bias = torch.randn((nh, cfg.window ** 2, cfg.window ** 2),
                               generator=g).to(dev)
            out = torch.empty((BATCH, Hp, Wp, C), dtype=dt, device=dev)
            cases.append((s, qkv, bias, mask, out, shift, nh, n))
        fns = {name: entry(lib) for name, lib in libs.items() if lib}
        if clocks_lib:
            results[f"clocks {name_dt}"] = clocks(clocks_lib, cases, cfg.window)
        for name, fn in list(fns.items()):
            if name in PROBES:
                continue
            for s, qkv, bias, mask, out, shift, nh, _ in cases:
                kw = dict(window=cfg.window, shift=shift, n_heads=nh)
                ref = wa.fused_window_attention_plain(qkv, bias, mask, **kw)
                try:
                    got = call(fn, qkv, bias, mask, out, cfg.window, shift, nh)
                except RuntimeError as e:
                    print(f"{name} {name_dt}: {e}", flush=True)
                    del fns[name]
                    break
                d = (got.float() - ref.float()).unflatten(-1, (nh, -1)).abs()
                top = ref.float().unflatten(-1, (nh, -1)).abs().amax(-1)
                ok = (float(d.max()) <= CS.ATTN_TOL if dt == torch.float32
                      else float((d.amax(-1) / top.clamp_min(1e-30)).max())
                      <= CS.BF16_TOL)
                if not (ok and bool(torch.isfinite(got).all())):
                    bad.append(f"{name} {name_dt} stage {s} shift {shift}")
            torch.cuda.synchronize()
            print(f"checked {name} {name_dt}", flush=True)
        times = {name: [] for name in fns}
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                fn = fns[name]
                per_stage = {}
                for s, qkv, bias, mask, out, shift, nh, n in cases:
                    ms = CS.cuda_ms(lambda: call(fn, qkv, bias, mask, out,
                                                 cfg.window, shift, nh))
                    per_stage[f"{s}/{shift}"] = ms
                total = sum(c[7] * per_stage[f"{c[0]}/{c[5]}"] for c in cases)
                times[name].append(dict(frame_ms=total, stages=per_stage))
        for name, runs in times.items():
            frame_ms = [r["frame_ms"] for r in runs]
            results[f"{name} {name_dt}"] = dict(
                frame_ms=frame_ms, median_frame_ms=statistics.median(frame_ms),
                stages=runs[0]["stages"])
            print(f"{name} {name_dt} batch {BATCH}: per frame "
                  + " / ".join(f"{t:.4f}" for t in frame_ms) + " ms; stage ms "
                  + ", ".join(f"{k} {v:.4f}" for k, v in runs[0]["stages"].items()),
                  flush=True)
    if bad:
        print("disagree with the plain version: " + "; ".join(bad), flush=True)
    print(card, flush=True)
    print(json.dumps({"card": card, "batch": BATCH, "results": results,
                      "disagree": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
