"""Synthetic real-time video workload (the paper's 20-second clip).

Frames are natural-image-like: smooth low-frequency background + moving
textured rectangles ("objects") + mild sensor noise.  Deterministic given
the seed, so privacy/energy profiling is repeatable (paper §V-A uses a
fixed pre-recorded clip for exactly this reason).  Object tracks double as
detection targets for the training example.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np


@dataclass
class VideoConfig:
    h: int = 544
    w: int = 800
    n_objects: int = 4
    fps: int = 10
    seconds: float = 20.0
    noise: float = 0.01
    seed: int = 0

    @property
    def n_frames(self) -> int:
        return int(self.fps * self.seconds)


def _smooth_background(rng, h, w):
    """Low-frequency background via bilinear-upsampled coarse noise."""
    coarse = rng.uniform(0.15, 0.7, (8, 8, 3))
    ys = np.linspace(0, 7, h)
    xs = np.linspace(0, 7, w)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, 7)
    x1 = np.minimum(x0 + 1, 7)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    img = ((1 - wy) * (1 - wx) * coarse[y0][:, x0]
           + (1 - wy) * wx * coarse[y0][:, x1]
           + wy * (1 - wx) * coarse[y1][:, x0]
           + wy * wx * coarse[y1][:, x1])
    return img


@dataclass
class SyntheticVideo:
    cfg: VideoConfig = field(default_factory=VideoConfig)

    def __post_init__(self):
        rng = np.random.default_rng(self.cfg.seed)
        self._bg = _smooth_background(rng, self.cfg.h, self.cfg.w)
        c = self.cfg
        self._obj = []
        for _ in range(c.n_objects):
            self._obj.append({
                "xy": rng.uniform([0.1 * c.w, 0.1 * c.h],
                                  [0.8 * c.w, 0.8 * c.h]),
                "vel": rng.uniform(-6, 6, 2),
                "size": rng.uniform([40, 30], [160, 120]),
                "color": rng.uniform(0.2, 1.0, 3),
                "cls": int(rng.integers(0, 80)),
            })
        self._rng = rng

    def frame(self, t: int) -> Tuple[np.ndarray, List[Dict]]:
        """Returns (H, W, 3) float32 frame in [0,1] and object boxes."""
        c = self.cfg
        img = self._bg.copy()
        boxes = []
        rng = np.random.default_rng(c.seed * 100003 + t)
        for ob in self._obj:
            x, y = ob["xy"] + ob["vel"] * t
            x = float(np.abs((x % (2 * c.w)) - c.w) % c.w)
            y = float(np.abs((y % (2 * c.h)) - c.h) % c.h)
            sw, sh = ob["size"]
            x0, y0 = int(max(x - sw / 2, 0)), int(max(y - sh / 2, 0))
            x1, y1 = int(min(x + sw / 2, c.w)), int(min(y + sh / 2, c.h))
            if x1 <= x0 or y1 <= y0:
                continue
            # textured fill (stripes) so objects carry internal structure
            yy = np.arange(y0, y1)[:, None]
            stripe = 0.85 + 0.15 * np.sin(yy / 6.0)
            img[y0:y1, x0:x1] = ob["color"] * stripe[..., None]
            boxes.append({"box": (x0, y0, x1, y1), "cls": ob["cls"]})
        img = img + rng.normal(0, c.noise, img.shape)
        return np.clip(img, 0, 1).astype(np.float32), boxes

    def frames(self, n: int = 0, batch: int = 1) -> np.ndarray:
        n = n or self.cfg.n_frames
        out = np.stack([self.frame(t)[0] for t in range(n)])
        if batch > 1:
            out = out[: (n // batch) * batch].reshape(-1, batch, self.cfg.h,
                                                      self.cfg.w, 3)
        return out
