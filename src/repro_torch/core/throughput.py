"""ML uplink-throughput estimator (paper §I / prior work [1]).

The counterpart of ``repro/core/throughput.py``.  Predicts achievable uplink
throughput from radio observations, with two feature sets:

  * ``kpm``      -- numeric KPMs only (SINR, RSRP, PRB util, MCS, BLER).
                    Fails under *narrowband* jammers: wideband KPMs barely
                    move while throughput collapses.
  * ``kpm+spec`` -- KPMs + pooled IQ-derived spectrogram bins, in which the
                    jammer stripe is visible.

A two-hidden-layer MLP in torch on an explicit device, trained on synthetic
traces from ``core/channel.py`` with the JAX package's inline Adam and the
same minibatch draws.  GELU is the tanh approximation, ``jax.nn.gelu``'s
default.  The parameters are a list of ``{"w": (a, b), "b": (b,)}``, the
JAX package's layout, so ``bridge.params_from_numpy`` carries an estimator
across.  The AF (``core/adaptive.py``) consumes ``predict()``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core.channel import (ChannelModel, RadioKPM, iq_spectrogram,
                                      observe_kpms)

N_SPEC_BINS = 32


def featurize(kpm: RadioKPM, spec: Optional[np.ndarray],
              mode: str) -> np.ndarray:
    base = np.array([kpm.sinr_db / 30.0, (kpm.rsrp_dbm + 100) / 30.0,
                     kpm.prb_util, kpm.mcs / 27.0, kpm.bler], np.float32)
    if mode == "kpm":
        return base
    pooled = spec.mean(axis=0) / 100.0 + 1.0          # (F,)
    return np.concatenate([base, pooled.astype(np.float32)])


def feature_dim(mode: str) -> int:
    return 5 if mode == "kpm" else 5 + N_SPEC_BINS


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def _init_mlp(generator: torch.Generator, dims, device) -> List[Dict[str, Any]]:
    return [{"w": (torch.randn((a, b), generator=generator)
                   / math.sqrt(a)).to(device),
             "b": torch.zeros((b,), device=device)}
            for a, b in zip(dims, dims[1:])]


def _mlp(params, x: torch.Tensor) -> torch.Tensor:
    for i, lyr in enumerate(params):
        x = x @ lyr["w"] + lyr["b"]
        if i + 1 < len(params):
            x = F.gelu(x, approximate="tanh")
    return x


@dataclass
class ConstantRateEstimator:
    """Degenerate estimator: one fixed rate whatever the radio observations
    (the baseline for ablations and contention studies)."""
    rate_bps: float

    def predict(self, kpm: RadioKPM, spec: Optional[np.ndarray]) -> float:
        return self.rate_bps


@dataclass
class ThroughputEstimator:
    mode: str = "kpm+spec"
    hidden: int = 64
    params: Optional[list] = None
    # normalization for the regression target log10(rate)
    y_mean: float = 7.0
    y_std: float = 1.0
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def init(self, generator: torch.Generator):
        self.params = _init_mlp(generator, (feature_dim(self.mode), self.hidden,
                                            self.hidden, 1), self.device)
        return self

    def _log_rate(self, X: np.ndarray) -> torch.Tensor:
        """float32 log10(rate), as the JAX package computes it."""
        with torch.no_grad():
            x = torch.from_numpy(np.asarray(X, np.float32)).to(self.device)
            return _mlp(self.params, x)[:, 0] * self.y_std + self.y_mean

    def predict(self, kpm: RadioKPM, spec: Optional[np.ndarray]) -> float:
        y = self._log_rate(featurize(kpm, spec, self.mode)[None])[0]
        return float(10.0 ** y)

    def predict_batch(self, X: np.ndarray) -> np.ndarray:
        return (10.0 ** self._log_rate(X)).cpu().numpy()


# ---------------------------------------------------------------------------
# synthetic dataset + training
# ---------------------------------------------------------------------------

def make_dataset(channel: ChannelModel, n: int, mode: str,
                 seed: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (X, y=log10 rate, narrowband flags)."""
    rng = np.random.default_rng(seed)
    X, y, nb = [], [], []
    for _ in range(n):
        lvl = float(rng.uniform(-42, -4))
        narrow = bool(rng.random() < 0.5)
        kpm = observe_kpms(lvl, narrow, rng)
        spec = iq_spectrogram(lvl, narrow, rng)
        rate = channel.sample_rate(lvl, rng, narrowband=narrow)
        X.append(featurize(kpm, spec, mode))
        y.append(np.log10(rate))
        nb.append(narrow)
    return np.stack(X), np.asarray(y, np.float32), np.asarray(nb)


def train_estimator(channel: ChannelModel, mode: str = "kpm+spec",
                    n_train: int = 4096, steps: int = 600, lr: float = 3e-3,
                    seed: int = 0, device="cuda",
                    params: Optional[list] = None) -> ThroughputEstimator:
    """Fit the MLP with the JAX package's inline Adam and minibatch draws.
    ``params`` starts from given weights (for instance the JAX package's
    init, carried across by ``bridge.params_from_numpy``) instead of a
    fresh init from a generator seeded with ``seed``."""
    X, y, _ = make_dataset(channel, n_train, mode, seed)
    est = ThroughputEstimator(mode=mode, device=device)
    if params is None:
        est.init(torch.Generator().manual_seed(seed))
    else:
        est.params = [{k: v.to(est.device) for k, v in lyr.items()}
                      for lyr in params]
    est.y_mean, est.y_std = float(y.mean()), float(y.std() + 1e-6)
    yn = (y - est.y_mean) / est.y_std
    Xd = torch.from_numpy(X).to(est.device)
    yd = torch.from_numpy(np.asarray(yn, np.float32)).to(est.device)

    p = [{k: v.detach().clone().requires_grad_(True) for k, v in lyr.items()}
         for lyr in est.params]
    flat = [t for lyr in p for t in (lyr["b"], lyr["w"])]
    m = [torch.zeros_like(t) for t in flat]
    v = [torch.zeros_like(t) for t in flat]
    one = torch.ones((), dtype=torch.float32)
    rng = np.random.default_rng(seed + 1)
    for i in range(steps):
        idx = torch.from_numpy(rng.integers(0, X.shape[0], 256)).to(est.device)
        loss = torch.mean((_mlp(p, Xd[idx])[:, 0] - yd[idx]) ** 2)
        grads = torch.autograd.grad(loss, flat)
        # inline Adam; the bias corrections in float32, as JAX computes them
        c1 = float(one - (one * 0.9) ** (i + 1))
        c2 = float(one - (one * 0.999) ** (i + 1))
        with torch.no_grad():
            for t, g, mt, vt in zip(flat, grads, m, v):
                mt.mul_(0.9).add_(0.1 * g)
                vt.mul_(0.999).add_(0.001 * g * g)
                t.sub_(lr * (mt / c1) / (torch.sqrt(vt / c2) + 1e-8))
    est.params = [{k: t.detach() for k, t in lyr.items()} for lyr in p]
    return est


def eval_estimator(est: ThroughputEstimator, channel: ChannelModel,
                   n: int = 1024, seed: int = 123) -> Dict[str, float]:
    """Relative rate error overall and on the narrowband subset (the regime
    where KPM-only estimation collapses, paper §I)."""
    X, y, nb = make_dataset(channel, n, est.mode, seed)
    pred = est.predict_batch(X)
    true = 10.0 ** y
    rel = np.abs(pred - true) / true
    return {
        "median_rel_err": float(np.median(rel)),
        "narrowband_rel_err": float(np.median(rel[nb])),
        "wideband_rel_err": float(np.median(rel[~nb])),
    }
