"""Step builders for serving (``repro/launch/steps.py``): prefill and
decode_step as plain functions on one device.

The JAX package builds jitted steps with shardings over a mesh; the port runs
eagerly on one card, so a builder returns the function itself.  The mesh,
the sharding rules and the train step wait for ROADMAP A9.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import transformer as T


def build_prefill(cfg: ModelConfig, shape: InputShape, *,
                  max_len: Optional[int] = None) -> Callable:
    """prefill(params, batch) -> (last-position logits, decode caches of
    ``max_len`` rows, ``shape.seq_len`` by default)."""
    max_len = max_len or shape.seq_len

    def prefill(params, batch):
        return T.prefill(cfg, params, batch, max_len)

    return prefill


def build_decode_step(cfg: ModelConfig) -> Callable:
    """decode_step(params, caches, batch, cache_index) -> (logits (B, 1, V),
    or (B, 1, ncb, V) with codebooks, caches): one new token against the
    caches ``build_prefill`` made."""

    def decode_step(params, caches, batch, cache_index: int):
        return T.decode_step(cfg, params, caches, batch, cache_index)

    return decode_step
