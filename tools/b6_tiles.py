"""B6's one-launch body (the decode-attention cluster) under other values of
its levers, and three probes of where its time goes: the measurements behind
B6's chosen shape.

    python3 tools/b6_tiles.py          # from the root of a checkout, on a card

Writes copies of ``src/repro_torch/kernels/csrc/decode_attention.cu`` (with
``hopper.cuh`` beside them) into ``build/b6_tiles/`` with text of the body
replaced: the bytes of K a sub-tile (``kSubTileBytes``, which sets its rows
T), the ring's stages (``kRing``), the CTAs an SM of the launch bounds
and the plan (``kCtasPerSm``), the consumer warps (``kConsumerWarps``), one
16-byte piece of a row a lane where the body takes two (``kP``), musicgen's G = 1 on the
instantiation for two heads (a dead head slot, as before G = 1 had its
own) and, in place of the producer's two bulk copies a stage, 16-byte
cp.async pieces from all 32 of its lanes (the plain 16-byte loads).  A
layout past the shared memory a CTA may have is refused at launch, and the
variant is reported and dropped.  Three probes change what the kernel
computes and are timed only, never checked: the kernel returns at once
(the cluster launch alone), every row is taken as dead (no row loaded or
scored: the launch, the barriers and the combine alone), and the consumers
wait for each stage and release it without reading it (loads alone).  The
cluster size C is an argument of the C entry point, so every C (1, 2, 4, 8,
16) runs on the built copy as it is; each copy's own plan (the wrapper's
``cluster_plan`` with the copy's sub-tile bytes and CTAs an SM, as its
``decode_attention_geometry`` gives them) picks the C of its other runs.
Each copy is built with the repository's nvcc flags (one nvcc per copy, all
started together).

Four shapes, bf16, on normals from a torch generator seeded with 0:
qwen3-1.7b's decode (q (4, 1, 16, 128) against a (4, 8, 2080, 128) cache
at kv_len 2048), the partial mode on the first half of that cache (1040
rows, live rows 1040 / 1040 / 700 / 0, as ``chip_smoke.b6_partial_inputs``
cuts it), musicgen-medium's G = 1 (24 over 24 heads, hd 64, kv_len 2048)
and the examples' batch 2 with a short cache (40 rows, kv_len 36).  Every
variant that computes B6, and the copy as built at every C, is held against
the plain version (the default mode's worst row within 1e-2 of its max,
the partial mode's out and lse within 1e-4) and two launches must agree
bitwise; then each is timed twice in turns: with CUDA events, queued
behind a spin, so that no host time enters but the gap between launches
does (warm L2); each launch alone after 128 MB written (cold L2); and the
kernel's own device time in a torch.profiler trace (warm, no gap), beside
the bound (bytes at 3.35 TB/s, by the kernel's cost function).  Prints the card's name and
power limit first, one line per variant, shape and C, and a JSON object
last; exits non-zero without a card or if a variant disagrees.
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
import kernel_timing as KT  # noqa: E402  (its trace's device time)

OUT = ROOT / "build" / "b6_tiles"
CLUSTERS = (1, 2, 4, 8, 16)
# name: (B, H, KV, S, hd, kv_len per batch row, partial mode)
SHAPES = {
    "qwen3 decode": (4, 16, 8, 2080, 128, (2048,) * 4, False),
    "qwen3 partial half": (4, 16, 8, 1040, 128, (1040, 1040, 700, 0), True),
    "musicgen decode": (4, 24, 24, 2080, 64, (2048,) * 4, False),
    "examples batch 2": (2, 16, 8, 40, 128, (36, 36), False),
}
FILL = """  if (lane == 0) {
    mbar_arrive_expect_tx(full, 2 * bytes);
    bulk_load(dst, k, bytes, full);
    bulk_load(dst + kSubTileBytes, v, bytes, full);
  }
"""
CP_ASYNC_FILL = """  for (uint32_t p = lane; p < bytes / 16; p += 32) {
    cp_async16(dst + 16 * p, reinterpret_cast<const char*>(k) + 16 * p, 16);
    cp_async16(dst + kSubTileBytes + 16 * p, reinterpret_cast<const char*>(v) + 16 * p, 16);
  }
  cp_async_mbar_arrive(full);
"""
FULL_INIT = "mbar_init(full(st), 1);"
# name: (source text, replacement) pairs; the first is the source as it is
PIECES = "kP = kGW <= 2 && HD >= 2 * kE ? 2 : 1;"
VARIANTS = {
    "as_built": (),
    "subtile_4k": (("kSubTileBytes = 8192; ", "kSubTileBytes = 4096; "),),
    "subtile_16k": (("kSubTileBytes = 8192; ", "kSubTileBytes = 16384;"),),
    "ring_3": (("kRing = 2;", "kRing = 3;"),),
    "ring_4": (("kRing = 2;", "kRing = 4;"),),
    "ctas_2": (("kCtasPerSm = 3;", "kCtasPerSm = 2;"),),
    "consumers_8": (("kConsumerWarps = 4;", "kConsumerWarps = 8;"),),
    "one_piece_a_lane": ((PIECES, "kP = 1;"),),
    "g1_on_g2": (("B6_G(1) B6_G(2)", "B6_G(2)"),),
    "cp_async_16b": ((FILL, CP_ASYNC_FILL),
                     (FULL_INIT, "mbar_init(full(st), 32);")),
}
PROBES = {
    "probe_empty": (
        ("unsigned char smem[];\n",
         "unsigned char smem[];\n  if (S >= 0) return;\n"),),
    "probe_no_rows": (
        ("const int len = min(max(kv_len[b], 0), S);",
         "const int len = 0 * min(max(kv_len[b], 0), S);"),),
    "probe_loads_only": (
        ("for (int j0 = rs * SR + rw; j0 - rw < r_end; j0 += KB * RW) {",
         "for (int j0 = rs * SR + rw; j0 - rw < 0 * r_end; j0 += KB * RW) {"),),
}


def edited_source(src: str, edits) -> str:
    """src with each (old, new) replaced; old must occur once."""
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"decode_attention.cu holds '{old.strip()[:60]}' "
                               f"{src.count(old)} times, not once")
        src = src.replace(old, new)
    return src


def build(jobs) -> dict:
    """One nvcc per copy, all at once; {name: library path or None}."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    shutil.copy(_build.CSRC / "hopper.cuh", OUT / "hopper.cuh")
    src = (_build.CSRC / "decode_attention.cu").read_text()
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
        spills = [ln.strip() for ln in out.splitlines()
                  if "spill" in ln and " 0 bytes spill" not in ln]
        regs = sorted({int(w) for ln in out.splitlines() if "Used" in ln
                       for w in [ln.split("Used")[1].split()[0]]})
        print(f"built {name}: registers {regs[0]}-{regs[-1]}"
              + (f"; {len(spills)} spill lines, e.g. {spills[0][-120:]}"
                 if spills else "; no spills"), flush=True)
        libs[name] = lib
    return libs


def entries(lib: Path):
    """(default mode, partial mode) C entry points of a built copy, and its
    (sub-tile bytes, CTAs an SM)."""
    from repro_torch.kernels import decode_attention as da
    dll = ctypes.CDLL(str(lib))
    fns = [da.library_geometry(dll)]
    for name, n_out in (("decode_attention_fwd", 1),
                        ("decode_attention_lse_fwd", 2)):
        fn = getattr(dll, name)
        fn.argtypes = [ctypes.c_void_p] * (4 + n_out) + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns.append(fn)
    return fns


def call(fns, q, ck, cv, lens, outs, C):
    """One launch of a copy on the wrapper's arguments, at cluster size C."""
    from repro_torch.kernels import _build
    B, _, H, hd = q.shape
    KV, S = ck.shape[1], ck.shape[2]
    fn = fns[len(outs)]
    rc = fn(q.data_ptr(), ck.data_ptr(), cv.data_ptr(), lens.data_ptr(),
            *(o.data_ptr() for o in outs), B, S, H, KV, hd, C, 1,
            1.0 / math.sqrt(hd), 0.0, _build.current_stream(q.device))
    if rc != 0:
        raise RuntimeError(f"launch failed with cudaError_t {rc}")
    return outs


def agree(da, q, ck, cv, lens, outs, again, partial) -> float:
    """The worst error against the plain version (the partial mode's out
    and lse in absolute terms, the default mode's worst row over its max),
    or raises if it is past tolerance or two launches differ."""
    import torch
    if not all(torch.equal(a, b) for a, b in zip(outs, again)):
        raise AssertionError("two launches differ")
    if partial:
        ref, ref_lse = da.decode_attention_plain(q, ck, cv, lens, 0.0, True)
        fin = lens > 0
        err = max(float((outs[0] - ref).abs().max()),
                  float((outs[1][fin] - ref_lse[fin]).abs().max()))
        ok = (err <= CS.ATTN_TOL and bool(torch.isneginf(outs[1][~fin]).all())
              and not outs[0][~fin].any())
    else:
        ref = da.decode_attention_plain(q, ck, cv, lens).double()
        d = (outs[0].double() - ref).abs().amax(-1)
        err = float((d / ref.abs().amax(-1).clamp_min(1e-30)).max())
        ok = err <= CS.BF16_TOL
    if not ok:
        raise AssertionError(f"error {err} against the plain version")
    return err


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("b6_tiles: needs an NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import decode_attention as da
    card = CS.gpu_name_and_limit()
    print(card, flush=True)
    libs = build({**VARIANTS, **PROBES})
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    data = {}
    for shape, (B, H, KV, S, hd, lens, partial) in SHAPES.items():
        q = torch.randn((B, 1, H, hd), generator=g).to(dev, torch.bfloat16)
        ck, cv = (torch.randn((B, KV, S, hd), generator=g).to(dev, torch.bfloat16)
                  for _ in range(2))
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        nbytes = da.cost(q.shape, ck.shape, 2, list(lens), partial)[1]
        data[shape] = (q, ck, cv, kv_len, partial,
                       nbytes / CS.HBM_BYTES_PER_S * 1e3)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def plan(geometry, shape):
        """(C, T) of the wrapper's plan with a copy's own constants."""
        B, _, KV, S, hd = SHAPES[shape][:5]
        return da.cluster_plan(B, KV, S, hd, 2, sms, *geometry)

    def outs_for(q, partial):
        B, _, H, _ = q.shape
        if partial:
            return (torch.empty(q.shape, dtype=torch.float32, device=dev),
                    torch.empty((B, H), dtype=torch.float32, device=dev))
        return (torch.empty_like(q),)

    # (variant, shape, C) -> a launch
    runs, bad = {}, []
    fns = {name: entries(lib) for name, lib in libs.items() if lib}
    for name, f in fns.items():
        for shape, (q, ck, cv, kv_len, partial, _) in data.items():
            C_plan = plan(f[0], shape)[0]
            clusters = CLUSTERS if name == "as_built" else (C_plan,)
            for C in clusters:
                outs, again = outs_for(q, partial), outs_for(q, partial)
                try:
                    call(f, q, ck, cv, kv_len, outs, C)
                    call(f, q, ck, cv, kv_len, again, C)
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    print(f"{name} {shape} C {C}: {e}", flush=True)
                    continue
                if name not in PROBES:
                    try:
                        err = agree(da, q, ck, cv, kv_len, outs, again, partial)
                    except AssertionError as e:
                        bad.append(f"{name} {shape} C {C}: {e}")
                        continue
                    print(f"checked {name} {shape} C {C}: error {err:.3g}",
                          flush=True)
                runs[(name, shape, C)] = (
                    lambda f=f, q=q, ck=ck, cv=cv, kv_len=kv_len, outs=outs,
                    C=C: call(f, q, ck, cv, kv_len, outs, C))
    l2 = torch.empty(CS.L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    times = {key: {"warm": [], "cold": [], "trace": []} for key in runs}
    for order in (list(runs), list(runs)[::-1]):
        for key in order:
            fn = runs[key]
            times[key]["warm"].append(CS.cuda_ms(fn, queued=True))
            times[key]["cold"].append(CS.cuda_ms(fn, before=lambda: l2.fill_(1.0)))
            times[key]["trace"].append(KT.device_ms([fn], "decode_attention_kernel"))
    results = {}
    for (name, shape, C), t in times.items():
        bound = data[shape][5]
        C_plan, T = plan(fns[name][0], shape)
        mark = " (the plan's)" if C == C_plan else ""
        results[f"{name} | {shape} | C {C}"] = dict(
            warm_ms=t["warm"], cold_ms=t["cold"], trace_ms=t["trace"],
            bound_ms=bound, median_warm_ms=statistics.median(t["warm"]),
            median_cold_ms=statistics.median(t["cold"]))
        print(f"{name} {shape} C {C}{mark}: queued warm "
              + " / ".join(f"{x:.4f}" for x in t["warm"]) + " ms, cold "
              + " / ".join(f"{x:.4f}" for x in t["cold"]) + " ms, kernel "
              "alone in a trace " + " / ".join(f"{x:.4f}" for x in t["trace"])
              + f" ms; bound {bound:.4f} ms (T {T} rows)", flush=True)
    if bad:
        print("disagree with the plain version: " + "; ".join(bad), flush=True)
    print(card, flush=True)
    print(json.dumps({"card": card, "results": results, "disagree": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
