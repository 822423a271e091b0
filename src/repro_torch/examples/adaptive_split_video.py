"""End-to-end demo: real-time video object detection with adaptive split
inference over the simulated AI-RAN network (the paper's full demo loop).
The port of ``examples/adaptive_split_video.py``.

Every frame really executes: Swin head on the "UE", the INT8+zlib codec,
simulated 5G uplink (calibrated to paper Fig. 4), Swin tail + detection on
the "edge", while the AF adapts the split to the interference trace.

    PYTHONPATH=src python -m repro_torch.examples.adaptive_split_video \\
        --reduced --device cpu --frames 10
    PYTHONPATH=src python -m repro_torch.examples.adaptive_split_video
"""
from __future__ import annotations

import argparse
from typing import Any, Dict

import numpy as np

from repro_torch.examples import add_port_flags, frame, swin_model


def jammer_sweep(frames: int) -> np.ndarray:
    """Interference ramps up mid-clip, then recovers."""
    t = np.linspace(0, 1, frames)
    return -40 + 35 * np.exp(-((t - 0.55) / 0.18) ** 2)


def run(args, *, params=None, system=None, estimator_init=None) -> Dict[str, Any]:
    """``run_frame`` over the jammer sweep; returns the trace and the
    ``FrameLog`` of every frame.  ``params``, ``system`` and
    ``estimator_init`` as in ``quickstart.run``."""
    import torch

    from repro_torch.core.adaptive import (DEFAULT_PRIVACY_PROFILE,
                                           AdaptiveController, Objective)
    from repro_torch.core.calibration import calibrate
    from repro_torch.core.channel import dupf_path
    from repro_torch.core.compression import ActivationCodec
    from repro_torch.core.pipeline import SplitInferencePipeline
    from repro_torch.core.splitting import SwinSplitPlan
    from repro_torch.core.throughput import train_estimator
    from repro_torch.data.video import SyntheticVideo, VideoConfig

    dev, cfg, params = swin_model(args, params)
    video = SyntheticVideo(VideoConfig(h=cfg.img_h, w=cfg.img_w, seed=0))
    imgs = [frame(video, t, dev) for t in range(args.frames)]

    system = system or calibrate(device=dev)
    est = train_estimator(system.channel, "kpm+spec", n_train=1500, steps=250,
                          device=dev, params=estimator_init)
    ctrl = AdaptiveController(
        system=system, estimator=est,
        objective=Objective(w_delay=1.0, w_energy=0.15, w_privacy=0.05),
        path=dupf_path(), privacy_profile=dict(DEFAULT_PRIVACY_PROFILE))
    pipe = SplitInferencePipeline(
        plan=SwinSplitPlan(cfg, params, device=dev), system=system,
        codec=ActivationCodec(device=dev), controller=ctrl, path=dupf_path(),
        narrowband=args.narrowband, execute_model=True, seed=0)

    trace = jammer_sweep(args.frames)
    with torch.no_grad():
        logs = [pipe.run_frame(img, float(lvl)) for img, lvl in zip(imgs, trace)]
    return {"trace": trace, "logs": logs}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--narrowband", action="store_true")
    add_port_flags(ap)
    return ap.parse_args(argv)


def main(argv=None) -> Dict[str, Any]:
    res = run(parse_args(argv))
    logs = res["logs"]
    print(f"{'frame':>5s} {'intf':>6s} {'option':12s} {'delay':>8s} "
          f"{'payload':>9s} {'energy':>7s}")
    for i, (log, lvl) in enumerate(zip(logs, res["trace"])):
        print(f"{i:5d} {lvl:5.0f}dB {log.option:12s} "
              f"{log.delay_s * 1e3:6.0f} ms {log.compressed_bytes / 1e3:7.0f}kB "
              f"{log.energy_j:6.2f} J")

    d = np.asarray([l.delay_s for l in logs])
    print(f"\nmean E2E delay {d.mean() * 1e3:.0f} ms  "
          f"p95 {np.quantile(d, .95) * 1e3:.0f} ms")
    opts = [l.option for l in logs]
    print("split usage:", {o: opts.count(o) for o in sorted(set(opts))})
    print("adaptation events:", sum(a != b for a, b in zip(opts, opts[1:])))
    return res


if __name__ == "__main__":
    main()
