"""Calibrate the simulated testbed to the paper's measurements.

The counterpart of ``repro/core/calibration.py``.  The paper's testbed (a
laptop UE, a GH200 edge, a physical NR uplink) is not available; its
measured operating points are, and the simulator is fitted to hit them:

  fitted constants                     from paper value
  ------------------------------------------------------------------
  UE effective FLOP/s                  UE-only E2E delay 3842.7 ms
  UE active power                      UE-only energy 0.0213 Wh/frame
  edge effective FLOP/s                25x the UE (fixed ratio)
  R(-30), R(-10), R(-5)                Split-1 delays (Fig. 4)
  R(-40)                               server-only delay 327.6 ms
  R(-20)                               geometric interpolation

The fit needs real compressed payload sizes, so ``calibrate()`` runs the
port's Swin-T head and codec once per split at full detection resolution
(``_measure_payloads``) and caches the sizes in a JSON file.  That file is
the port's own (``CACHE_PATH``): the JAX package's ``.calibration_cache.json``
holds sizes measured with other weights, and the port never writes it.
Given the same cache table, the fit is field-exact against the JAX package.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.swin_t_detection import CONFIG as SWIN_CONFIG, SwinConfig
from repro_torch.core.channel import ChannelModel
from repro_torch.core.compression import ActivationCodec
from repro_torch.core.energy import DeviceProfile, RadioProfile
from repro_torch.core.splitting import SERVER_ONLY, SwinSplitPlan
from repro_torch.data.video import SyntheticVideo, VideoConfig
from repro_torch.models import swin as SW

# --- paper §V measurements (ground truth for the fit / validation) ----------
PAPER = {
    "ue_only_ms": 3842.7,
    "server_only_ms": 327.6,
    "split1_ms": {-30: 1262.9, -10: 1586.1, -5: 2652.8},
    "ue_only_wh": 0.0213,
    "split1_wh": 0.0051,
    "server_only_wh": 0.0001,
    "privacy_split1": 0.527,
    "dupf_ms": (1944.13, 211.77),
    "cupf_ms": (2199.73, 310.58),
    "input_mb": 1.312,
    "payload_reduction": (0.85, 0.87),
}

# the port's own cache, at the root of the checkout (listed in .gitignore)
CACHE_PATH = os.path.join(os.path.dirname(__file__), os.pardir, os.pardir,
                          os.pardir, ".calibration_cache_torch.json")


def _accounting_plan(cfg: SwinConfig) -> SwinSplitPlan:
    """A weightless Swin plan for FLOP accounting (no device needed)."""
    plan = SwinSplitPlan.__new__(SwinSplitPlan)
    plan.cfg = cfg
    plan.ship_merged = True
    plan.include_early_split = False
    return plan


@dataclass
class Calibrated:
    ue: DeviceProfile
    edge: DeviceProfile
    radio: RadioProfile
    channel: ChannelModel
    # measured-at-calibration payload bytes per option (batch=1)
    raw_bytes: Dict[str, int]
    compressed_bytes: Dict[str, int]
    swin_cfg: SwinConfig = field(default_factory=lambda: SWIN_CONFIG)

    def head_time_s(self, option: str) -> float:
        return self.ue.compute_time_s(
            _accounting_plan(self.swin_cfg).head_flops(option))

    def tail_time_s(self, option: str) -> float:
        return self.edge.compute_time_s(
            _accounting_plan(self.swin_cfg).tail_flops(option))

    def payload_bytes(self, plan, option: str,
                      codec: Optional[ActivationCodec] = None):
        """(raw, compressed) boundary bytes for a split plan.  The tables are
        measurements of the paper's Swin plan at full resolution and apply
        to the port's Swin plans only (accounting charges the full-size
        calibrated system even when a reduced stand-in executes); any other
        plan is estimated from its own payload specs with ``codec``
        (default: the paper's int8+zlib setting)."""
        if isinstance(plan, SwinSplitPlan) and option in self.raw_bytes:
            return self.raw_bytes[option], self.compressed_bytes[option]
        raw = plan.raw_payload_bytes(option)
        if option == SERVER_ONLY:
            return raw, raw                  # raw input ships as-is
        # estimate_bytes is arithmetic on the specs and touches no device
        codec = codec or ActivationCodec(device="cpu")
        return raw, codec.estimate_bytes(plan.payload_specs(option))


def _measure_payloads(cfg: SwinConfig, codec: ActivationCodec, seed: int = 0,
                      device="cuda") -> Dict[str, Dict[str, int]]:
    """Run the port's head + codec once per option at full resolution, with
    weights from the port's ``init`` on a generator seeded with ``seed``."""
    device = resolve_device(device)
    params = SW.init(cfg, torch.Generator().manual_seed(seed), device=device)
    video = SyntheticVideo(VideoConfig(h=cfg.img_h, w=cfg.img_w, seed=seed))
    img = torch.from_numpy(video.frame(0)[0])[None].to(device)
    plan = SwinSplitPlan(cfg, params, device=device)
    out = {}
    with torch.no_grad():
        for opt in plan.options:
            payload, _ = plan.head(img, opt)
            if payload is None:
                out[opt] = {"raw": 0, "compressed": 0}
                continue
            if opt == SERVER_ONLY:
                # raw uint8 image over the link (paper's server-only mode)
                n = cfg.img_h * cfg.img_w * 3
                out[opt] = {"raw": n, "compressed": n}
                continue
            comp = codec.compress(payload)
            out[opt] = {"raw": int(comp.raw_bytes),
                        "compressed": int(comp.compressed_bytes)}
    return out


def calibrate(force: bool = False, codec: Optional[ActivationCodec] = None,
              cache_path: str = CACHE_PATH, device="cuda") -> Calibrated:
    """Fit the testbed from the cached payload sizes, measuring them first
    (on ``device``) when the cache is missing or ``force`` is set."""
    device = resolve_device(device)
    cached = None
    if not force and os.path.exists(cache_path):
        with open(cache_path) as f:
            cached = json.load(f)
    if cached is None:
        payloads = _measure_payloads(SWIN_CONFIG,
                                     codec or ActivationCodec(device=device),
                                     device=device)
        with open(cache_path, "w") as f:
            json.dump(payloads, f, indent=1)
    else:
        payloads = cached

    cfg = SWIN_CONFIG
    total_f = SW.total_flops(cfg)

    # 1) UE compute rate from UE-only delay; power from UE-only energy.
    ue_t = PAPER["ue_only_ms"] / 1e3
    ue_flops = total_f / ue_t
    ue_power = PAPER["ue_only_wh"] * 3600.0 / ue_t
    ue = DeviceProfile("ue-laptop-i9", flops_per_s=ue_flops,
                       power_active_w=ue_power)

    # 2) Edge: GH200 MIG slice, 25x the laptop (fixed ratio; the residual
    #    of the server-only fit below lands on the uplink rate instead).
    edge = DeviceProfile("edge-gh200-mig", flops_per_s=25.0 * ue_flops,
                         power_active_w=250.0)

    path_s = 0.004  # dUPF local breakout (testbed default)

    # 3) Channel rates.  Split-1 delays pin R at -30/-10/-5; server-only
    #    pins R at -40 (input tx dominates); -20 geometric interp.
    h1 = SW.head_flops(cfg, 1) / ue.flops_per_s
    t1 = (total_f - SW.head_flops(cfg, 1)) / edge.flops_per_s
    c1 = payloads["split1"]["compressed"]
    rate_table: Dict[int, float] = {}
    for lvl, d_ms in PAPER["split1_ms"].items():
        tx = d_ms / 1e3 - h1 - t1 - path_s
        rate_table[lvl] = c1 * 8.0 / tx
    t_edge = total_f / edge.flops_per_s
    in_bytes = payloads["server_only"]["compressed"]
    tx0 = PAPER["server_only_ms"] / 1e3 - t_edge - path_s
    rate_table[-40] = in_bytes * 8.0 / tx0
    rate_table[-20] = float(np.sqrt(rate_table[-30] * rate_table[-10]))

    channel = ChannelModel(rate_table=rate_table)
    raw = {k: v["raw"] for k, v in payloads.items()}
    comp = {k: v["compressed"] for k, v in payloads.items()}
    return Calibrated(ue=ue, edge=edge, radio=RadioProfile(),
                      channel=channel, raw_bytes=raw, compressed_bytes=comp)
