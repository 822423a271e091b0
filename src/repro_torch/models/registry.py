"""Model registry: the serving surface of ``repro/models/registry.py``.

``get_model(cfg, device)`` returns an ``LMModel`` with init / spec /
loss_fn / prefill / decode_step / cache_init, the ``*_inputs`` spec
factories (shapes and dtypes, no allocation) and ``abstract_params`` /
``abstract_cache``, the same trees as tensors on ``torch.device("meta")``
(the port's ``jax.eval_shape``), over every LM of
``models/transformer.py``: dense, MoE, recurrent (xLSTM), hybrid (Hymba),
audio (musicgen: frames in) and vision-language (InternVL: patches and
tokens in).
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


META = torch.device("meta")


class MetaGenerator(torch.Generator):
    """A generator whose draws land on the meta device: an ``init`` given
    one builds its tree's shapes and dtypes and allocates nothing."""

    @property
    def device(self) -> torch.device:
        return META


@dataclass(frozen=True)
class LMModel:
    cfg: ModelConfig
    device: Any = "cuda"

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    # -- parameters and steps -------------------------------------------------
    def init(self, generator: torch.Generator):
        return T.init(self.cfg, generator, self.device)

    def spec(self):
        """Each parameter's logical axes (``transformer.spec``)."""
        return T.spec(self.cfg)

    def abstract_params(self):
        """``init``'s tree on the meta device: shapes and dtypes only."""
        return T.init(self.cfg, MetaGenerator(), META)

    def abstract_cache(self, B: int, max_len: int):
        """``cache_init``'s tree on the meta device."""
        return T.cache_init(self.cfg, B, max_len, META)

    def loss_fn(self, params, batch) -> torch.Tensor:
        return T.loss_fn(self.cfg, params, batch)

    def prefill(self, params, batch, max_len: int):
        return T.prefill(self.cfg, params, batch, max_len)

    def decode_step(self, params, caches, batch, cache_index: int):
        return T.decode_step(self.cfg, params, caches, batch, cache_index)

    def cache_init(self, B: int, max_len: int):
        return T.cache_init(self.cfg, B, max_len, self.device)

    # -- input specs ------------------------------------------------------------
    def train_inputs(self, shape: InputShape) -> Dict[str, TensorSpec]:
        """A training batch: ``prefill_inputs`` and int32 labels, (B, S),
        or one per codebook (B, S, ncb) for audio; a vision config's labels
        cover its patch positions too (-1 there)."""
        batch = self.prefill_inputs(shape)
        B, S = shape.global_batch, shape.seq_len
        labels = ((B, S, self.cfg.n_codebooks)
                  if self.cfg.frontend == "audio_frames" else (B, S))
        batch["labels"] = TensorSpec(labels, torch.int32)
        return batch

    def prefill_inputs(self, shape: InputShape) -> Dict[str, TensorSpec]:
        """The prompt's inputs, ``train_inputs`` without labels: audio
        frames (B, S, d) float32; for a vision config ``n_frontend_tokens``
        patches (B, P, d) float32 and S - P tokens; otherwise tokens (B,
        S)."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        if cfg.frontend == "audio_frames":
            return {"frames": TensorSpec((B, S, cfg.d_model), torch.float32)}
        if cfg.frontend == "vision_patches":
            P = cfg.n_frontend_tokens
            return {"patches": TensorSpec((B, P, cfg.d_model), torch.float32),
                    "tokens": TensorSpec((B, S - P), torch.int32)}
        return {"tokens": TensorSpec((B, S), torch.int32)}

    def decode_inputs(self, shape: InputShape) -> Dict[str, TensorSpec]:
        """One-token inputs for a decode step (the cache passed separately):
        tokens (B, 1), or one per codebook (B, 1, ncb) for audio."""
        B = shape.global_batch
        if self.cfg.frontend == "audio_frames":
            return {"tokens": TensorSpec((B, 1, self.cfg.n_codebooks),
                                         torch.int32)}
        return {"tokens": TensorSpec((B, 1), torch.int32)}

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
