"""Privacy-leakage metric: distance correlation (paper §V-A, Fig 5).

The counterpart of ``repro/core/privacy.py``.  dCor(X, Y) over a batch of
frames: X = raw inputs, Y = the transmitted representation at split l.  1.0
when the raw input itself is transmitted (server-only), 0 when nothing is
(UE-only), decreasing with split depth as features become more abstract.

The functions compute on the device their tensors lie on (numpy inputs are
taken as CPU tensors).  The feature standardisation uses the population
standard deviation, as ``jnp.std`` does.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves


def _pairwise_dist(x: torch.Tensor) -> torch.Tensor:
    """x: (n, d) -> (n, n) euclidean distances."""
    sq = torch.sum(x * x, dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    return torch.sqrt(torch.clamp_min(d2, 0.0))


def _u_center(a: torch.Tensor, n: int) -> torch.Tensor:
    """U-centering (Szekely & Rizzo 2014): the bias-corrected estimator --
    the naive empirical dCor of INDEPENDENT data is strongly positive at
    small n (e.g. ~0.5 at n=40), which would inflate the privacy profile."""
    row = a.sum(dim=1, keepdim=True) / (n - 2)
    col = a.sum(dim=0, keepdim=True) / (n - 2)
    tot = a.sum() / ((n - 1) * (n - 2))
    u = a - row - col + tot
    return u * (1.0 - torch.eye(n, dtype=a.dtype, device=a.device))


def _features(x: torch.Tensor, n: int, max_features: int) -> torch.Tensor:
    f = torch.as_tensor(x).reshape(n, -1).float()
    # stride-subsample features (dCor cost is O(n^2 d))
    if f.shape[1] > max_features:
        f = f[:, ::f.shape[1] // max_features][:, :max_features]
    # standardize per feature (scale invariance across layers)
    return (f - f.mean(0)) / (f.std(0, correction=0) + 1e-6)


def distance_correlation(x, y, max_features: int = 4096) -> float:
    """Bias-corrected distance correlation (clamped at 0).
    x: (n, ...) raw inputs; y: (n, ...) transmitted representation."""
    n = x.shape[0]
    A = _u_center(_pairwise_dist(_features(x, n, max_features)), n)
    B = _u_center(_pairwise_dist(_features(y, n, max_features)), n)
    norm = 1.0 / (n * (n - 3))
    dcov2 = norm * torch.sum(A * B)
    dvarx = norm * torch.sum(A * A)
    dvary = norm * torch.sum(B * B)
    dcor2 = dcov2 / torch.clamp_min(torch.sqrt(dvarx * dvary), 1e-12)
    return float(torch.sqrt(torch.clamp_min(dcor2, 0.0)))


def payload_privacy(inputs, payload_tree) -> float:
    """dCor between raw inputs and the concatenated transmitted payload."""
    leaves = [l for l in tree_leaves(payload_tree)
              if hasattr(l, "shape") and l.ndim >= 1]
    if not leaves:
        return 0.0
    n = inputs.shape[0]
    flat = torch.cat([torch.as_tensor(l).reshape(n, -1).float()
                      for l in leaves], dim=1)
    return distance_correlation(inputs, flat)
