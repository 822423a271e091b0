"""Weights from the JAX package's parameter trees, as numpy arrays.

``params_from_numpy`` takes a tree of the JAX package's parameters with
every leaf converted to numpy (``jax.tree.map(np.asarray, params)``) and
returns the port's: the same nesting, dense weights kept (in, out), conv
weights (the only 4-D leaves) turned from HWIO to the OIHW that
``F.conv2d`` takes.  bf16 leaves stay bf16 (a bf16 Swin-T's weights; its
``rel_bias`` is float32 there and stays so); every other leaf comes out
float32.  It serves the Swin-T tree of ``repro.models.swin.init`` and the
throughput estimator's parameter list (``[{"w": (a, b), "b": (b,)},
...]``, 2-D and 1-D leaves, taken as they are).  No weight is re-drawn, so
a model compared with the JAX package runs on exactly its weights.

``lm_params_from_numpy`` takes the LM tree of ``repro.models.transformer.
init`` and keeps every leaf's layout and dtype: the per-layer weights are
stacked by ``jax.vmap`` into a leading layer axis, so ``wq`` is (layers, d,
H, hd), 4-D and no convolution.  bf16 leaves arrive as ``ml_dtypes``
bfloat16 arrays, which torch cannot take: their bits go through uint16.

``adamw_state_from_numpy`` takes the JAX package's ``AdamWState`` (step,
m, v) with numpy leaves and returns the port's, leaves kept as they are, so
both optimizers can step from the same state.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.optim.adamw import AdamWState
from repro_torch.tree import tree_map


def _bf16_tensor(a: np.ndarray) -> torch.Tensor:
    """An ``ml_dtypes`` bfloat16 array's bits as a torch bfloat16 tensor."""
    return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)


def params_from_numpy(tree: Any, device="cuda") -> Any:
    device = resolve_device(device)

    def convert(leaf):
        a = np.asarray(leaf)
        if a.dtype.name == "bfloat16":
            t = _bf16_tensor(a)
        else:
            t = torch.from_numpy(np.array(a, dtype=np.float32))
        if t.dim() == 4:                       # HWIO -> OIHW
            t = t.permute(3, 2, 0, 1).contiguous()
        return t.to(device)

    return tree_map(convert, tree)


def lm_params_from_numpy(tree: Any, device="cuda") -> Any:
    device = resolve_device(device)

    def convert(leaf):
        a = np.asarray(leaf)
        if a.dtype.name == "bfloat16":
            return _bf16_tensor(a).to(device)
        return torch.from_numpy(a.copy()).to(device)

    return tree_map(convert, tree)


def adamw_state_from_numpy(state: Any, device="cuda") -> AdamWState:
    step, m, v = state
    return AdamWState(step=lm_params_from_numpy(step, device),
                      m=lm_params_from_numpy(m, device),
                      v=lm_params_from_numpy(v, device))
