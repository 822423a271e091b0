"""Synthetic token / frame / patch pipeline for LM-family training: a copy
of ``repro/data/tokens.py`` (numpy only), which gives bitwise the JAX
package's arrays for the same (cfg, seq_len, batch, seed, worker,
n_workers).

Deterministic per-host sharding: worker w of W draws from a seed stream
``seed * W + w`` so the global batch is reproducible under any data-
parallel layout (elastic restarts re-shard cleanly).

Sequences follow a Zipfian unigram mixed with local n-gram structure so
the loss actually decreases during the examples' short training runs
(pure-uniform tokens give a flat loss surface).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclass
class TokenStream:
    cfg: ModelConfig
    seq_len: int
    batch: int              # per-host batch
    seed: int = 0
    worker: int = 0
    n_workers: int = 1

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed * self.n_workers + self.worker)
        v = self.cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._p = (1.0 / ranks ** 1.1)
        self._p /= self._p.sum()

    def _sample_tokens(self, shape):
        flat = self._rng.choice(self.cfg.vocab_size, size=int(np.prod(shape)),
                                p=self._p)
        toks = flat.reshape(shape).astype(np.int32)
        # inject learnable bigram structure: token[2i+1] = f(token[2i])
        n_pairs = shape[-1] // 2
        toks[..., 1:2 * n_pairs:2] = (
            toks[..., 0:2 * n_pairs:2] * 31 + 7) % self.cfg.vocab_size
        return toks

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        cfg, B, S = self.cfg, self.batch, self.seq_len
        batch: Dict[str, np.ndarray] = {}
        if cfg.frontend == "audio_frames":
            toks = self._sample_tokens((B, S + 1, cfg.n_codebooks))
            batch["frames"] = self._rng.normal(
                0, 1, (B, S, cfg.d_model)).astype(np.float32)
            batch["labels"] = toks[:, 1:]
            return batch
        if cfg.frontend == "vision_patches":
            np_tok = S - cfg.n_frontend_tokens
            toks = self._sample_tokens((B, np_tok + 1))
            batch["patches"] = self._rng.normal(
                0, 1, (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
            batch["tokens"] = toks[:, :-1]
            labels = np.full((B, S), -1, np.int32)   # no loss on patch positions
            labels[:, cfg.n_frontend_tokens:] = toks[:, 1:]
            batch["labels"] = labels
            return batch
        toks = self._sample_tokens((B, S + 1))
        batch["tokens"] = toks[:, :-1]
        batch["labels"] = toks[:, 1:]
        return batch
