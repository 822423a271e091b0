#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which raises (and so exits non-zero, with no result line)
when it fails:

 1. print the card's name and power limit (nvidia-smi);
 2. build the CUDA kernels of src/repro_torch/kernels/csrc with nvcc, one
    process per source, into build/kernels (listed in .gitignore);
 3. hold every kernel against its plain PyTorch version on the card at the
    main path's shapes: window attention at the four full-width Swin-T stage
    shapes, unshifted with and without the pad-strip mask and shifted by 3,
    within ATTN_TOL; the codec pair on the split-1..4 payload streams, delta
    on and off, bitwise; the quant pair on each full-width payload leaf, a
    length that is not a multiple of the block, an empty leaf and a bf16
    leaf, bitwise;
 4. the main path, once, with every launch counter at 0 before and read
    after: full-width Swin-T (544x800, random weights from a seeded
    generator, random rel_bias) for splits 1-4, four UEs each through
    SwinSplitPlan.head_jitted + ActivationCodec.compress_head
    (int8_delta_zlib), then decompress_group and tail_batched(pad_to=4);
    detections must have the expected shapes, be finite, and every kernel
    must have launched exactly as often as the path calls it;
 5. one frame at split 2 on the port's CPU path at the same width: the head
    output and the tail's detections (from the card's own payload) against
    the card's within CPU_TOL, and the CPU decode of the card's payload
    bitwise equal to the card's;
 6. time each kernel (CUDA events), its plain version and, for window
    attention, one library call over the same windows (scaled dot-product
    attention with a float mask, never called by the port), beside the
    least time the card could take; then the per-split head+encode, decode
    and batched-tail times;
 7. the codec's modes at full width: for splits 1-4, one frame's head
    payload through raw, zlib, int8, int8_zlib and int8_delta_zlib, each
    int8 mode fused and legacy (per-tensor, the quant pair).  Every payload
    round-trips (raw and zlib to the input's bits, int8 within half a
    quantisation step) and the legacy decode is bitwise the fused decode;
    raw and compressed bytes are printed per mode and split;
 8. the paper's adaptive single-UE loop on the card: calibrate (the
    full-width head and codec measure the payloads into a cache under
    build/), train the throughput estimator (1500 samples, 250 steps), and
    run SplitInferencePipeline.run_trace over the 24-frame jammer sweep of
    examples/adaptive_split_video.py with Objective(w_privacy=3.0), once
    with the fused codec and once with the legacy one, then one run_frame
    per fixed split 1-4 with the legacy codec.  Each run starts with every
    launch counter at 0 and must launch each kernel exactly as often as the
    options in its logs imply; per frame it prints the option, delay,
    compressed bytes and the host wall time of run_frame.

Weights everywhere are random, from a seeded generator: payload sizes and
compression ratios are those of random weights, not of a trained detector.
The last three lines are the card's name and power limit, a JSON object
with one entry per kernel, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import collections
import json
import statistics
import subprocess
import sys
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
N_UES = 4
N_FRAMES = 24                      # the example's jammer sweep
SPLITS = (1, 2, 3, 4)
CPU_SPLIT = 2
MODE = "int8_delta_zlib"
# kernel vs plain version on the card: both fp32, sums in other orders
ATTN_TOL = 1e-4
# card vs CPU at full width: fp32 through up to 12 blocks and the FPN, with
# cuBLAS/cuDNN against oneDNN/MKL sum orders; relative to the map's max |x|
CPU_TOL = 1e-3
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA's data sheet
FP32_FLOP_PER_S = 67e12            # H100 SXM fp32 outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10, runs: int = 7) -> float:
    """Median over ``runs`` of the mean time of ``reps`` back-to-back calls,
    by CUDA events, after a warm-up."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def host_ms(fn, runs: int = 3) -> float:
    """Median wall time of ``fn`` ending in a synchronize (after a warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on an NVIDIA card", file=sys.stderr)
        return 2

    import torch.nn.functional as F
    from repro_torch.configs.swin_t_detection import CONFIG as cfg
    from repro_torch.core.adaptive import (DEFAULT_PRIVACY_PROFILE,
                                           AdaptiveController, Objective)
    from repro_torch.core.calibration import calibrate
    from repro_torch.core.channel import dupf_path
    from repro_torch.core.compression import ActivationCodec, _to_host
    from repro_torch.core.pipeline import SplitInferencePipeline
    from repro_torch.core.splitting import (SERVER_ONLY, UE_ONLY,
                                            SwinSplitPlan, split_option)
    from repro_torch.core.throughput import train_estimator
    from repro_torch.tree import tree_leaves, tree_map
    from repro_torch.data.video import SyntheticVideo, VideoConfig
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import codec as ck
    from repro_torch.kernels import quant as qk
    from repro_torch.kernels import window_attention as wa
    from repro_torch.models import swin as SW

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # -- 1. the card ---------------------------------------------------------
    card = gpu_name_and_limit()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    reports = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(reports)} "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # -- set-up: model, frames, plan, codec ----------------------------------
    g = torch.Generator().manual_seed(SEED)
    params = SW.init(cfg, g, device=dev)
    for stage in params["stages"]:
        for bp in stage["blocks"]:
            bp["rel_bias"] = (torch.randn(bp["rel_bias"].shape, generator=g)
                              * 0.5).to(dev)
    video = SyntheticVideo(VideoConfig(h=cfg.img_h, w=cfg.img_w, seed=SEED))
    frames = torch.from_numpy(video.frames(N_UES)).to(dev)      # (4, 544, 800, 3)
    plan = SwinSplitPlan(cfg, params, device=dev)
    codec = ActivationCodec(mode=MODE, device=dev)
    block = codec.quant_block

    # -- 3. every kernel against its plain version, main-path shapes ---------
    attn_cases = []              # (stage, B, Hp, Wp, C, nh, shift, mask)
    for s in range(cfg.n_stages):
        H, W = cfg.stage_hw(s)
        w = cfg.window
        Hp, Wp = -(-H // w) * w, -(-W // w) * w
        C, nh = cfg.stage_dim(s), cfg.num_heads[s]
        pad = torch.as_tensor(SW.pad_region_mask(Hp, Wp, H, W, w), device=dev)
        shifted = torch.as_tensor(SW.shift_attn_mask(Hp, Wp, w, w // 2),
                                  device=dev)
        for shift, mask in ((0, None), (0, pad), (w // 2, shifted)):
            attn_cases.append((s, Hp, Wp, C, nh, shift, mask))
    attn_err = 0.0
    for s, Hp, Wp, C, nh, shift, mask in attn_cases:
        qkv = torch.randn((N_UES, Hp, Wp, 3 * C), generator=g).to(dev)
        bias = torch.randn((nh, 49, 49), generator=g).to(dev)
        kw = dict(window=cfg.window, shift=shift, n_heads=nh)
        # plain version first, so the kernel's output cannot reuse its buffer
        ref = wa.fused_window_attention_plain(qkv, bias, mask, **kw)
        out = wa.fused_window_attention_cuda(qkv, bias, mask, **kw)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not (torch.isfinite(out).all() and err <= ATTN_TOL):
            raise AssertionError(f"window attention stage {s} shift {shift} "
                                 f"mask {mask is not None}: err {err}")
        attn_err = max(attn_err, err)
        log(f"check B1 stage {s} ({N_UES},{Hp},{Wp},{C}) nh {nh} shift {shift} "
            f"mask {'none' if mask is None else 'yes'}: max|kernel-plain| "
            f"{err:.3g} (tol {ATTN_TOL}), max|out| {float(out.abs().max()):.3g}")
    # the smallest stage also against the plain version on the host
    s, Hp, Wp, C, nh, shift, mask = attn_cases[-1]
    qkv = torch.randn((1, Hp, Wp, 3 * C), generator=g)
    bias = torch.randn((nh, 49, 49), generator=g)
    kw = dict(window=cfg.window, shift=shift, n_heads=nh)
    host_err = float((wa.fused_window_attention_cuda(
        qkv.to(dev), bias.to(dev), mask, **kw).cpu()
        - wa.fused_window_attention_plain(qkv, bias, mask.cpu(), **kw))
        .abs().max())
    if host_err > ATTN_TOL:
        raise AssertionError(f"window attention vs host plain: {host_err}")
    log(f"check B1 stage 3 shifted vs plain on the host: {host_err:.3g}")

    streams, head_trees = {}, {}
    for split in SPLITS:
        with torch.no_grad():
            tree = plan.head_jitted(split_option(split))(params, frames[:1])
        head_trees[split] = tree
        segs = [F.pad(x.reshape(-1), (0, (-x.numel()) % block))
                for x in tree_leaves(tree)]
        streams[split] = torch.cat(segs)
    def abs_err(a, b):
        """Largest |a - b| in float64; 0 for empty tensors."""
        if a.numel() == 0:
            return 0.0
        return float((a.double() - b.double()).abs().max())

    codec_checks = 0
    enc_err = dec_err = quant_err = dequant_err = 0.0
    for split, flat in streams.items():
        for delta in (False, True):
            q, sc = ck.codec_encode_cuda(flat, block, delta)
            q2, sc2 = ck.codec_encode_plain(flat, block, delta)
            y = ck.codec_decode_cuda(q, sc, block, delta)
            y2 = ck.codec_decode_plain(q, sc, block, delta)
            torch.cuda.synchronize()
            same = (torch.equal(q.view(torch.uint8), q2.view(torch.uint8))
                    and torch.equal(sc.view(torch.int32), sc2.view(torch.int32))
                    and torch.equal(y.view(torch.int32), y2.view(torch.int32)))
            enc_err = max(enc_err, abs_err(q, q2), abs_err(sc, sc2))
            dec_err = max(dec_err, abs_err(y, y2))
            if not same:
                raise AssertionError(f"codec split {split} delta {delta}: "
                                     "kernel and plain version differ")
            codec_checks += 1
            log(f"check B2/B3 split {split}: {flat.numel()} f32 = "
                f"{flat.numel() // block} blocks, delta {delta}: bitwise equal")

    def bits(t):
        return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[t.element_size()])

    # every full-width leaf shape (split 4 ships the four stage outputs), a
    # ragged length, an empty leaf and a bf16 leaf
    quant_cases = [x.contiguous() for x in tree_leaves(head_trees[4])]
    quant_cases += [torch.randn((3 * block + 4321,), generator=g).to(dev) * 3,
                    torch.zeros((0, 4), device=dev),
                    quant_cases[1].to(torch.bfloat16)]
    for x in quant_cases:
        q, sc, n = qk.quant_cuda(x, block)
        q2, sc2, n2 = qk.quant_plain(x, block)
        y = qk.dequant_cuda(q, sc, n, tuple(x.shape), x.dtype)
        y2 = qk.dequant_plain(q, sc, n, tuple(x.shape), x.dtype)
        torch.cuda.synchronize()
        same = (n == n2 and torch.equal(q, q2)
                and torch.equal(bits(sc), bits(sc2)) and y.dtype == x.dtype
                and torch.equal(bits(y), bits(y2)))
        quant_err = max(quant_err, abs_err(q, q2), abs_err(sc, sc2))
        dequant_err = max(dequant_err, abs_err(y, y2))
        if not same:
            raise AssertionError(f"quant {tuple(x.shape)} {x.dtype}: kernel "
                                 "and plain version differ")
        log(f"check B4 {tuple(x.shape)} {str(x.dtype).removeprefix('torch.')}: "
            f"{q.shape[0]} blocks, quant and dequant bitwise equal")

    # -- 4. the main path, once, with the launch counters --------------------
    expected = {"fused_window_attention": 0, "codec_encode": 0,
                "codec_decode": 0}
    n_blocks = sum(cfg.depths)
    for split in SPLITS:
        head_blocks = sum(cfg.depths[:split])
        expected["fused_window_attention"] += (N_UES * head_blocks
                                               + n_blocks - head_blocks)
        expected["codec_encode"] += N_UES
        expected["codec_decode"] += 1
    kept = {}
    ops.LAUNCHES.clear()
    with torch.no_grad():
        for split in SPLITS:
            opt = split_option(split)
            producer = plan.head_jitted(opt)
            payloads, heads = [], []
            for i in range(N_UES):
                comp, tree = codec.compress_head(producer, params,
                                                 frames[i:i + 1])
                payloads.append(comp)
                heads.append(tree)
            trees = codec.decompress_group(payloads)
            outs = plan.tail_batched(trees, opt, pad_to=N_UES)
            kept[split] = (payloads, heads, outs)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    log(f"main path launches: {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError("the main path did not go through every kernel "
                             "as often as it calls it")
    for split, (payloads, _, outs) in kept.items():
        assert len(outs) == N_UES
        for out in outs:
            for lv, s in zip(out, range(cfg.n_stages)):
                H, W = cfg.stage_hw(s)
                for key, ch in (("cls", cfg.num_classes), ("box", 4), ("ctr", 1)):
                    t = lv[key]
                    if tuple(t.shape) != (1, H, W, ch) or not torch.isfinite(t).all():
                        raise AssertionError(f"split {split} {key} level {s}: "
                                             f"shape {tuple(t.shape)} or not finite")
        raw = payloads[0].raw_bytes
        if raw != plan.raw_payload_bytes(split_option(split)):
            raise AssertionError(f"split {split}: raw bytes {raw}")
        comp_bytes = [p.compressed_bytes for p in payloads]
        log(f"split {split}: detections ok for {N_UES} UEs; payload raw {raw} B, "
            f"compressed {comp_bytes} B")

    # -- 5. the port's CPU path against the card, one frame ------------------
    cpu = torch.device("cpu")
    params_cpu = tree_map(lambda a: a.to(cpu), params)
    plan_cpu = SwinSplitPlan(cfg, params_cpu, device=cpu)
    codec_cpu = ActivationCodec(mode=MODE, device=cpu)
    payloads, heads, outs = kept[CPU_SPLIT]
    opt = split_option(CPU_SPLIT)
    t0 = time.perf_counter()
    with torch.no_grad():
        head_cpu = plan_cpu.head_jitted(opt)(params_cpu, frames[:1].cpu())
        dec_cpu = codec_cpu.decompress(payloads[0])
        dec_gpu = codec.decompress(payloads[0])
        out_cpu = plan_cpu.tail(dec_cpu, opt)
    for a, b in zip(tree_leaves(dec_cpu), tree_leaves(dec_gpu)):
        if not torch.equal(a.view(torch.int32), b.cpu().view(torch.int32)):
            raise AssertionError("CPU decode of the card's payload differs")
    cpu_err = 0.0
    pairs = list(zip(tree_leaves(head_cpu), tree_leaves(heads[0])))
    pairs += list(zip(tree_leaves(out_cpu), tree_leaves(outs[0])))
    for a, b in pairs:
        b = b.cpu()
        rel = float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
        cpu_err = max(cpu_err, rel)
    if not cpu_err <= CPU_TOL:
        raise AssertionError(f"card vs CPU at split {CPU_SPLIT}: {cpu_err}")
    comp_cpu, _ = codec_cpu.compress_head(plan_cpu.head_jitted(opt),
                                          params_cpu, frames[:1].cpu())
    s_gpu = np.frombuffer(ActivationCodec._fused_stream(payloads[0]), np.uint8)
    s_cpu = np.frombuffer(ActivationCodec._fused_stream(comp_cpu), np.uint8)
    log(f"CPU path, split {CPU_SPLIT}, one frame ({time.perf_counter() - t0:.1f} s): "
        f"head and detections within {cpu_err:.3g} of the card (rel. tol "
        f"{CPU_TOL}); CPU decode of the card's payload bitwise equal; "
        f"CPU-encoded stream differs in {int((s_gpu != s_cpu).sum())} of "
        f"{s_gpu.size} bytes")

    # -- 6. times ------------------------------------------------------------
    rows = {}
    w = cfg.window
    w2 = w * w
    k_ms = p_ms = l_ms = b_ms = 0.0
    flops_total = bytes_total = 0
    for s, Hp, Wp, C, nh, shift, mask in attn_cases:
        padded = (Hp, Wp) != cfg.stage_hw(s)
        if shift == 0 and (mask is None) == padded:
            continue                       # not the mask this stage's blocks use
        # blocks of this kind in one forward: even blocks unshifted, odd shifted
        per_frame = cfg.depths[s] // 2 if shift else cfg.depths[s] - cfg.depths[s] // 2
        qkv = torch.randn((1, Hp, Wp, 3 * C), generator=g).to(dev)
        bias = torch.randn((nh, w2, w2), generator=g).to(dev)
        kw = dict(window=w, shift=shift, n_heads=nh)
        tk = cuda_ms(lambda: wa.fused_window_attention_cuda(qkv, bias, mask, **kw))
        tp = cuda_ms(lambda: wa.fused_window_attention_plain(qkv, bias, mask, **kw))
        # library yardstick: SDPA over the same windows with a float mask
        hd = C // nh
        nW = (Hp // w) * (Wp // w)
        x = torch.roll(qkv, (-shift, -shift), dims=(1, 2)) if shift else qkv
        x = x.reshape(1, Hp // w, w, Wp // w, w, 3, nh, hd)
        x = x.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, nW, nh, w2, hd)
        q, k, v = (x[i].contiguous() for i in range(3))
        fmask = bias[None].expand(nW, nh, w2, w2).clone()
        if mask is not None:
            fmask = fmask.masked_fill(~mask[:, None], -1e9)
        tl = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                            attn_mask=fmask))
        nbytes = 4 * Hp * Wp * 3 * C + 4 * nh * w2 * w2 + 4 * Hp * Wp * C
        nbytes += 0 if mask is None else nW * w2 * w2
        flops = nW * nh * (4 * w2 * w2 * hd + 4 * w2 * w2 + w2 * hd)
        tb = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S) * 1e3
        log(f"time B1 stage {s} (1,{Hp},{Wp},{C}) shift {shift}: kernel {tk:.4f} ms, "
            f"plain {tp:.4f} ms, sdpa {tl:.4f} ms, bound {tb:.4f} ms "
            f"({nbytes} B, {flops} flop), x{per_frame} per frame")
        k_ms += per_frame * tk
        p_ms += per_frame * tp
        l_ms += per_frame * tl
        b_ms += per_frame * tb
        bytes_total += per_frame * nbytes
        flops_total += per_frame * flops
    rows["fused_window_attention"] = dict(
        source="src/repro_torch/kernels/csrc/window_attention.cu",
        replaces="src/repro/kernels/window_attention.py:156",
        max_abs_err=attn_err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
        bound_by=("bytes" if bytes_total / HBM_BYTES_PER_S
                  >= flops_total / FP32_FLOP_PER_S else "operations"),
        library_ms=l_ms)
    log(f"time B1 per frame ({n_blocks} calls, batch 1): kernel {k_ms:.4f} ms, "
        f"plain {p_ms:.4f} ms, sdpa {l_ms:.4f} ms, bound {b_ms:.4f} ms; "
        f"launches per UE frame {n_blocks}")

    flat = streams[1]
    total = flat.numel()
    nb = total // block
    q, sc = ck.codec_encode_cuda(flat, block, False)
    enc_bytes = 4 * total + total + 4 * nb
    dec_bytes = total + 4 * nb + 4 * total
    rows["codec_encode"] = dict(
        source="src/repro_torch/kernels/csrc/codec.cu",
        replaces="src/repro/kernels/codec.py:71", max_abs_err=enc_err,
        ms=cuda_ms(lambda: ck.codec_encode_cuda(flat, block, False)),
        plain_ms=cuda_ms(lambda: ck.codec_encode_plain(flat, block, False)),
        bound_ms=enc_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None)
    rows["codec_decode"] = dict(
        source="src/repro_torch/kernels/csrc/codec.cu",
        replaces="src/repro/kernels/codec.py:102", max_abs_err=dec_err,
        ms=cuda_ms(lambda: ck.codec_decode_cuda(q, sc, block, False)),
        plain_ms=cuda_ms(lambda: ck.codec_decode_plain(q, sc, block, False)),
        bound_ms=dec_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None)
    per_frame = {"codec_encode": "1 per UE frame",
                 "codec_decode": f"1 per {N_UES}-UE group"}
    for name in ("codec_encode", "codec_decode"):
        r = rows[name]
        log(f"time {name} split-1 stream ({total} f32, {nb} blocks): kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms; launches {per_frame[name]}")

    # the quant pair over the split-1 payload's leaves, one launch per leaf
    leaves1 = [x.contiguous() for x in tree_leaves(head_trees[1])]
    quantised = [qk.quant_cuda(x, block) for x in leaves1]
    n_el = sum(x.numel() for x in leaves1)
    nb1 = sum(q.shape[0] for q, _, _ in quantised)
    q_bytes = 4 * n_el + nb1 * block + 4 * nb1        # reads x, writes q + scales
    rows["quant"] = dict(
        source="src/repro_torch/kernels/csrc/quant.cu",
        replaces="src/repro/kernels/quant.py:47", max_abs_err=quant_err,
        ms=cuda_ms(lambda: [qk.quant_cuda(x, block) for x in leaves1]),
        plain_ms=cuda_ms(lambda: [qk.quant_plain(x, block) for x in leaves1]),
        bound_ms=q_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None)
    rows["dequant"] = dict(
        source="src/repro_torch/kernels/csrc/quant.cu",
        replaces="src/repro/kernels/quant.py:79", max_abs_err=dequant_err,
        ms=cuda_ms(lambda: [qk.dequant_cuda(q, sc, n, tuple(x.shape))
                            for x, (q, sc, n) in zip(leaves1, quantised)]),
        plain_ms=cuda_ms(lambda: [qk.dequant_plain(q, sc, n, tuple(x.shape))
                                  for x, (q, sc, n) in zip(leaves1, quantised)]),
        bound_ms=q_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None)
    for name in ("quant", "dequant"):
        r = rows[name]
        log(f"time {name} split-1 leaves ({len(leaves1)} launches, {n_el} f32, "
            f"{nb1} blocks): kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({q_bytes} B); launches 1 per leaf of a legacy split frame")

    with torch.no_grad():
        for split in SPLITS:
            opt = split_option(split)
            producer = plan.head_jitted(opt)
            payloads = kept[split][0]
            trees = codec.decompress_group(payloads)
            t_head = host_ms(lambda: codec.compress_head(producer, params,
                                                         frames[:1]))
            t_dec = host_ms(lambda: codec.decompress_group(payloads))
            t_tail = host_ms(lambda: plan.tail_batched(trees, opt,
                                                       pad_to=N_UES))
            log(f"time split {split}: head+encode {t_head:.2f} ms per UE frame, "
                f"decode {t_dec:.2f} ms per {N_UES}-UE group, batched tail "
                f"{t_tail:.2f} ms per {N_UES}-UE group (host clock)")
            # where head+encode and decode go: the model, the device encode
            # with its one copy down, the host zlib (level 1, as the codec);
            # the host unzip, and one payload's upload with the device decode
            tree = producer(params, frames[:1])
            leaves, _ = codec._leaves(tree)
            p0 = payloads[0]
            stream0 = ActivationCodec._fused_stream(p0)
            segs0 = tuple((tuple(m.shape), m.dtype, m.n, m.block_start,
                           m.delta_axis) for m in p0.meta)
            t_model = host_ms(lambda: producer(params, frames[:1]))
            t_enc = host_ms(lambda: _to_host(*codec._encode(leaves)))
            t_zip = host_ms(lambda: zlib.compress(stream0.tobytes(), codec.level))
            t_unzip = host_ms(lambda: [zlib.decompress(p.blobs[0])
                                       for p in payloads])
            t_dec0 = host_ms(lambda: codec._decode(
                stream0, p0.scales[0], segs0, block, p0.mode, p0.delta_layout))
            log(f"time split {split} parts: head model {t_model:.2f} ms, "
                f"device encode + copy {t_enc:.2f} ms, host zlib {t_zip:.2f} ms "
                f"({stream0.size} B) per UE frame; host unzip {t_unzip:.2f} ms "
                f"per {N_UES}-UE group; upload + device decode {t_dec0:.2f} ms "
                f"per UE payload")

    # -- 7. the codec's modes at full width --------------------------------
    log("phase 7: payloads of random weights on synthetic frames; bytes are "
        "not those of a trained detector")
    int8_modes = ("int8", "int8_zlib", "int8_delta_zlib")
    with torch.no_grad():
        for split in SPLITS:
            tree = head_trees[split]
            xs = tree_leaves(tree)
            sizes = []
            for mode in ("raw", "zlib") + int8_modes:
                decoded = {}
                for fused in ((True, False) if mode in int8_modes else (False,)):
                    c = ActivationCodec(mode=mode, fused=fused, device=dev)
                    p = c.compress(tree)
                    if p.fused != fused or p.raw_bytes != plan.raw_payload_bytes(
                            split_option(split)):
                        raise AssertionError(f"split {split} {mode}: payload "
                                             f"layout or raw bytes wrong")
                    decoded[fused] = tree_leaves(c.decompress(p))
                    tag = ("/fused" if fused else "/legacy") if mode in int8_modes else ""
                    sizes.append(f"{mode}{tag} {p.compressed_bytes}")
                for y, x in zip(decoded[False], xs):
                    if mode in ("raw", "zlib"):
                        ok = torch.equal(bits(y), bits(x))
                    else:
                        step = float(x.abs().max()) / 127.0
                        ok = float((y - x).abs().max()) <= 0.5 * step * (1 + 1e-6)
                    if not ok:
                        raise AssertionError(f"split {split} {mode}: the "
                                             "payload does not round-trip")
                if mode in int8_modes:
                    for a, b in zip(decoded[True], decoded[False]):
                        if not torch.equal(bits(a), bits(b)):
                            raise AssertionError(f"split {split} {mode}: legacy "
                                                 "and fused decodes differ")
            torch.cuda.synchronize()
            log(f"codec modes split {split}: raw {plan.raw_payload_bytes(split_option(split))} B; "
                f"compressed B: {', '.join(sizes)}; all round-trip, legacy == "
                f"fused decode bitwise")

    # -- 8. the adaptive single-UE loop on the card -----------------------
    t0 = time.perf_counter()
    cache = ROOT / "build" / "calibration_cache.json"
    cache.parent.mkdir(parents=True, exist_ok=True)
    system = calibrate(force=True, cache_path=str(cache), device=dev)
    t_cal = time.perf_counter() - t0
    t0 = time.perf_counter()
    est = train_estimator(system.channel, "kpm+spec", n_train=1500, steps=250,
                          device=dev)
    t_est = time.perf_counter() - t0
    log(f"calibrate on the card ({t_cal:.1f} s): payload bytes "
        f"{system.compressed_bytes}; estimator trained in {t_est:.1f} s")
    sweep = -40 + 35 * np.exp(-((np.linspace(0, 1, N_FRAMES) - 0.55) / 0.18) ** 2)
    loop_frames = torch.from_numpy(video.frames(N_FRAMES)).to(dev)[:, None]
    n_leaves = {split_option(s): len(tree_leaves(head_trees[s])) for s in SPLITS}

    def loop_pipeline(fused: bool):
        ctrl = AdaptiveController(
            system=system, estimator=est, objective=Objective(w_privacy=3.0),
            path=dupf_path(), privacy_profile=dict(DEFAULT_PRIVACY_PROFILE))
        pipe = SplitInferencePipeline(
            plan=plan, system=system, codec=ActivationCodec(fused=fused, device=dev),
            controller=ctrl, path=dupf_path(), execute_model=True, seed=SEED)
        walls = []
        run_frame = pipe.run_frame

        def timed(*a, **kw):                    # host wall time per frame
            t = time.perf_counter()
            out = run_frame(*a, **kw)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            return out
        pipe.run_frame = timed
        return pipe, walls

    def expected_launches(logs, fused: bool):
        exp = {"fused_window_attention": n_blocks * len(logs)}
        for lg in logs:
            if lg.option in (UE_ONLY, SERVER_ONLY):
                continue
            for name, k in ((("codec_encode", 1), ("codec_decode", 1)) if fused
                            else (("quant", n_leaves[lg.option]),
                                  ("dequant", n_leaves[lg.option]))):
                exp[name] = exp.get(name, 0) + k
        return exp

    loop_launches = {}
    for fused in (True, False):
        name = "fused" if fused else "legacy"
        pipe, walls = loop_pipeline(fused)
        ops.LAUNCHES.clear()
        logs = pipe.run_trace(loop_frames, sweep)
        if not fused:                           # every payload shape meets B4
            logs += [pipe.run_frame(loop_frames[0], -20.0, split_option(s))
                     for s in SPLITS]
        torch.cuda.synchronize()
        got = dict(ops.LAUNCHES)
        want = expected_launches(logs, fused)
        log(f"loop {name}: launches {got} (expected from the logged options "
            f"{want})")
        if got != want:
            raise AssertionError(f"loop {name}: the launches do not match the "
                                 "options the frames ran")
        loop_launches[name] = got
        for i, (lg, wall) in enumerate(zip(logs, walls)):
            if not (np.isfinite(lg.delay_s) and lg.raw_bytes >= lg.compressed_bytes >= 0):
                raise AssertionError(f"loop {name} frame {i}: bad log {lg}")
            fixed = "" if i < N_FRAMES else " (fixed)"
            log(f"loop {name} frame {i:2d} {lg.interference_db:6.1f} dB "
                f"{lg.option:11s} delay {lg.delay_s * 1e3:8.2f} ms, compressed "
                f"{lg.compressed_bytes} B, quant_s {lg.quant_s * 1e3:7.2f} ms, "
                f"run_frame {wall * 1e3:7.2f} ms{fixed}")
        opts = [lg.option for lg in logs[:N_FRAMES]]
        by_opt = collections.defaultdict(list)
        for opt, wall in zip(opts, walls):
            by_opt[opt].append(wall)
        medians = ", ".join(f"{o} {statistics.median(w) * 1e3:.2f} ms "
                            f"({len(w)} frames)" for o, w in by_opt.items())
        log(f"loop {name}: options {dict(collections.Counter(opts))}, "
            f"adaptation events {sum(a != b for a, b in zip(opts, opts[1:]))}, "
            f"run_frame median by option over the {N_FRAMES} adaptive frames: "
            f"{medians}")
    # B1-B3 report their phase-4 counts, the quant pair its legacy-loop run
    for name in ("quant", "dequant"):
        launches[name] = loop_launches["legacy"].get(name, 0)
        if launches[name] == 0:
            raise AssertionError(f"the legacy loop never launched {name}")

    kernels = []
    for name, r in rows.items():
        kernels.append({"name": name, "route": "cuda", "source": r["source"],
                        "replaces": r["replaces"], "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
