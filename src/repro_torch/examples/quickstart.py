"""Quickstart: split a Swin detector, compress the boundary, pick a split
adaptively.  The port of ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart --reduced \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.examples.quickstart   # the card
"""
from __future__ import annotations

import argparse
from typing import Any, Dict

import numpy as np

from repro_torch.examples import add_port_flags, frame, swin_model

LEVELS = (-40, -20, -5)


def run(args, *, params=None, system=None, estimator_init=None) -> Dict[str, Any]:
    """The JAX example's steps.  ``params`` (Swin weights), ``system`` (a
    ``Calibrated``) and ``estimator_init`` (the estimator's initial MLP
    weights, ``train_estimator``'s ``params``) replace the port's own."""
    import torch

    from repro_torch.core.adaptive import (DEFAULT_PRIVACY_PROFILE,
                                           AdaptiveController, Objective)
    from repro_torch.core.calibration import calibrate
    from repro_torch.core.channel import dupf_path, iq_spectrogram, observe_kpms
    from repro_torch.core.compression import ActivationCodec
    from repro_torch.core.splitting import SwinSplitPlan
    from repro_torch.core.throughput import train_estimator
    from repro_torch.data.video import SyntheticVideo, VideoConfig
    from repro_torch.models import swin as SW
    from repro_torch.tree import tree_leaves

    # 1. an unmodified Swin-T detector
    dev, cfg, params = swin_model(args, params)
    video = SyntheticVideo(VideoConfig(h=cfg.img_h, w=cfg.img_w))
    img = frame(video, 0, dev)

    # 2. partition its forward pass at stage boundaries -- no retraining
    plan = SwinSplitPlan(cfg, params, device=dev)
    with torch.no_grad():
        full = SW.forward_full(cfg, params, img)
        payload, _ = plan.head(img, "split2")          # UE side
        leaves = tree_leaves(payload)

        # 3. compress: the fused INT8 encode (B2) + zlib
        codec = ActivationCodec(device=dev)
        comp = codec.compress(payload)

        # 4. server side completes detection from the decompressed payload
        out = plan.tail(codec.decompress(comp), "split2")
        drift = float((out[0]["cls"] - full[0]["cls"]).abs().mean())

    # 5. the AF picks the split from live radio observations
    system = system or calibrate(device=dev)       # calibrated to paper §V
    est = train_estimator(system.channel, "kpm+spec", n_train=800, steps=150,
                          device=dev, params=estimator_init)
    ctrl = AdaptiveController(
        system=system, estimator=est,
        objective=Objective(w_delay=1.0, w_energy=0.2, w_privacy=0.1),
        path=dupf_path(), privacy_profile=dict(DEFAULT_PRIVACY_PROFILE))
    rng = np.random.default_rng(0)
    decisions = []
    for lvl in LEVELS:
        ctrl.interference_db = lvl
        decisions.append(ctrl.decide(observe_kpms(lvl, False, rng),
                                     iq_spectrogram(lvl, False, rng),
                                     plan.options))
    return {"n_tensors": len(leaves),
            "raw_bytes": sum(x.numel() * x.element_size() for x in leaves),
            "compressed_bytes": comp.compressed_bytes, "ratio": comp.ratio,
            "drift": drift, "full": full, "out": out,
            "decisions": decisions}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    add_port_flags(ap)
    return ap.parse_args(argv)


def main(argv=None) -> Dict[str, Any]:
    res = run(parse_args(argv))
    print(f"split2 boundary: {res['n_tensors']} tensors, "
          f"{res['raw_bytes'] / 1e6:.2f} MB raw")
    print(f"compressed: {res['compressed_bytes'] / 1e6:.2f} MB "
          f"({100 * (1 - res['ratio']):.1f}% reduction)")
    print(f"detection logit drift through codec: {res['drift']:.4f} "
          f"(accuracy preserved)")
    for lvl, d in zip(LEVELS, res["decisions"]):
        print(f"interference {lvl:+d} dB -> {d.option:12s} "
              f"(predicted delay {d.delay_s * 1e3:6.0f} ms, "
              f"energy {d.energy_j:5.1f} J, privacy {d.privacy:.2f})")
    return res


if __name__ == "__main__":
    main()
