"""Weights from the JAX package's parameter trees, as numpy arrays.

``params_from_numpy`` takes a tree of the JAX package's parameters with
every leaf converted to numpy (``jax.tree.map(np.asarray, params)``) and
returns the port's: the same nesting, dense weights kept (in, out), conv
weights (the only 4-D leaves) turned from HWIO to the OIHW that
``F.conv2d`` takes.  It serves the Swin-T tree of ``repro.models.swin.init``
and the throughput estimator's parameter list (``[{"w": (a, b), "b":
(b,)}, ...]``, 2-D and 1-D leaves, taken as they are).  No weight is
re-drawn, so a model compared with the JAX package runs on exactly its
weights.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.tree import tree_map


def params_from_numpy(tree: Any, device="cuda") -> Any:
    device = resolve_device(device)

    def convert(leaf):
        t = torch.from_numpy(np.array(leaf, dtype=np.float32))
        if t.dim() == 4:                       # HWIO -> OIHW
            t = t.permute(3, 2, 0, 1).contiguous()
        return t.to(device)

    return tree_map(convert, tree)
