"""Model registry: the serving surface of ``repro/models/registry.py``.

``get_model(cfg, device)`` returns an ``LMModel`` with init / prefill /
decode_step / cache_init and the ``*_inputs`` spec factories (shapes and
dtypes, no allocation), over the dense, MoE, recurrent (xLSTM) and hybrid
(Hymba) LMs of ``models/transformer.py``.  The training surface (``loss_fn``,
``train_inputs``) waits for ROADMAP A9.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import transformer as T


@dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape and dtype, the port's ``jax.ShapeDtypeStruct``."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclass(frozen=True)
class LMModel:
    cfg: ModelConfig
    device: Any = "cuda"

    def __post_init__(self):
        T.check_supported(self.cfg)
        object.__setattr__(self, "device", resolve_device(self.device))

    # -- parameters and steps -------------------------------------------------
    def init(self, generator: torch.Generator):
        return T.init(self.cfg, generator, self.device)

    def prefill(self, params, batch, max_len: int):
        return T.prefill(self.cfg, params, batch, max_len)

    def decode_step(self, params, caches, batch, cache_index: int):
        return T.decode_step(self.cfg, params, caches, batch, cache_index)

    def cache_init(self, B: int, max_len: int):
        return T.cache_init(self.cfg, B, max_len, self.device)

    # -- input specs ------------------------------------------------------------
    def prefill_inputs(self, shape: InputShape) -> Dict[str, TensorSpec]:
        return {"tokens": TensorSpec((shape.global_batch, shape.seq_len),
                                     torch.int32)}

    def decode_inputs(self, shape: InputShape) -> Dict[str, TensorSpec]:
        """One-token inputs for a decode step (the cache passed separately)."""
        return {"tokens": TensorSpec((shape.global_batch, 1), torch.int32)}

    def concrete(self, specs: Dict[str, TensorSpec],
                 generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Materialize specs as random tensors on the model's device: token
        ids uniform below the vocabulary, floats normal."""
        out = {}
        for name, s in specs.items():
            if s.dtype.is_floating_point:
                t = torch.randn(s.shape, generator=generator,
                                device=generator.device).to(s.dtype)
            else:
                t = torch.randint(0, self.cfg.vocab_size, s.shape,
                                  generator=generator, device=generator.device,
                                  dtype=s.dtype)
            out[name] = t.to(self.device)
        return out


def get_model(cfg: ModelConfig, device="cuda") -> LMModel:
    return LMModel(cfg, device)
