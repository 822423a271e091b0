"""Split plans: partition a model's forward pass at a boundary.

The counterpart of ``repro/core/splitting.py``.  Execution options follow
paper Fig. 4: UE_ONLY, SPLIT(l), SERVER_ONLY.

  * ``SwinSplitPlan``: the paper's setting, the Swin detection backbone
    split after patch embedding or after stage 1..4; the FPN and detection
    head always run on the server.
  * ``LMSplitPlan``: the technique on an LM of the dense or MoE family,
    the residual stream cut at a layer boundary (quartile depths by
    default), across runs of different block kinds; the payload is the
    (B, S, d) activation after layer l.

Both are the port's own classes, not subclasses of the JAX package's; the
port's cell simulator tests ``isinstance`` against its own ``SwinSplitPlan``.
Both implement the ``SplitPlan`` protocol.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import (Any, List, Optional, Protocol, Sequence, Tuple,
                    runtime_checkable)

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, count_active_params
from repro_torch.configs.swin_t_detection import SwinConfig
from repro_torch.models import swin as SW
from repro_torch.models import transformer as T
from repro_torch.models.layers import rms_norm
from repro_torch.tree import tree_leaves, tree_map

UE_ONLY = "ue_only"
SERVER_ONLY = "server_only"


def split_option(l: int) -> str:
    return f"split{l}"


def _split_of(option: str) -> int:
    return int(option.removeprefix("split"))


@dataclass(frozen=True)
class Workload:
    """What one frame of work means for a plan: Swin processes one image per
    frame (``n_tokens`` stays 1), an LM plan an ``n_tokens`` prefill."""
    n_tokens: int = 1
    include_state: bool = False


@runtime_checkable
class SplitPlan(Protocol):
    """Uniform interface every split plan implements: ``head``/``tail``
    execute the partitioned forward; ``tail_batched`` stacks same-option
    payloads from many UEs and runs ONE tail forward (the edge server's
    micro-batching entry); the ``*_flops`` / ``payload_specs`` family is
    pure accounting over ``self.workload``."""
    params: Any
    workload: Workload

    @property
    def options(self) -> List[str]: ...
    def head(self, inputs, option: str) -> Tuple[Any, Any]: ...
    def tail(self, payload, option: str) -> Any: ...
    def tail_batched(self, payloads: Sequence[Any], option: str,
                     pad_to: Optional[int] = None) -> List[Any]: ...
    def head_flops(self, option: str) -> float: ...
    def tail_flops(self, option: str) -> float: ...
    def payload_specs(self, option: str) -> List[Tuple[Tuple[int, ...], str]]: ...
    def raw_payload_bytes(self, option: str, batch: int = 1) -> int: ...


def payload_batch(payload) -> int:
    """Leading (batch) dim of a payload tree."""
    return int(tree_leaves(payload)[0].shape[0])


def stack_payloads(payloads: Sequence[Any], pad_to: Optional[int] = None):
    """Concatenate same-structure payloads along the batch axis, optionally
    zero-padding to ``pad_to`` rows (bucketed batch sizes)."""
    stacked = tree_map(lambda *xs: torch.cat(list(xs), dim=0), *payloads)
    total = sum(payload_batch(p) for p in payloads)
    if pad_to is not None and pad_to > total:
        pad = pad_to - total
        stacked = tree_map(
            lambda a: torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))]),
            stacked)
    return stacked


def unstack_outputs(out, sizes: Sequence[int]) -> List[Any]:
    """Slice a batched tail output back into per-payload outputs."""
    outs, off = [], 0
    for n in sizes:
        outs.append(tree_map(lambda a, o=off, n=n: a[o:o + n], out))
        off += n
    return outs


class _PlanBase:
    """Byte accounting and batched tail execution on top of each plan's
    ``payload_specs`` / ``_tail_impl``."""

    def raw_payload_bytes(self, option: str, batch: int = 1) -> int:
        return batch * sum(int(np.prod(s)) * getattr(torch, d).itemsize
                           for s, d in self.payload_specs(option))

    def tail(self, payload, option: str):
        return self._tail_impl(self.params, payload, option)

    def tail_batched(self, payloads: Sequence[Any], option: str,
                     pad_to: Optional[int] = None) -> List[Any]:
        """Stack same-option payloads and run ONE tail forward.  Returns
        per-payload outputs in input order; ``pad_to`` zero-pads the stacked
        batch and the padding rows are dropped from the outputs."""
        if self.params is None:
            raise ValueError("tail_batched needs real params")
        sizes = [payload_batch(p) for p in payloads]
        total = sum(sizes)
        out = self._tail_impl(self.params, stack_payloads(payloads, pad_to),
                              option)
        if pad_to is not None and pad_to > total:
            out = tree_map(lambda a: a[:total], out)
        return unstack_outputs(out, sizes)


@dataclass
class SwinSplitPlan(_PlanBase):
    cfg: SwinConfig
    params: Any
    ship_merged: bool = True          # False = beyond-paper payload opt
    include_early_split: bool = False  # split0 (after patch embed, paper §IV-B)
    workload: Workload = field(default_factory=Workload)
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @property
    def options(self) -> List[str]:
        splits = range(0 if self.include_early_split else 1, self.cfg.n_stages + 1)
        return [UE_ONLY] + [split_option(l) for l in splits] + [SERVER_ONLY]

    def _image(self, img) -> torch.Tensor:
        return torch.as_tensor(img, dtype=torch.float32, device=self.device)

    # -- execution -----------------------------------------------------------
    def head(self, img, option: str):
        """UE-side computation.  Returns (payload_tree_or_None,
        detections_or_None)."""
        img = self._image(img)
        if option == UE_ONLY:
            return None, SW.forward_full(self.cfg, self.params, img)
        if option == SERVER_ONLY:
            return {"img": img}, None
        return self.head_jitted(option)(self.params, img), None

    def head_jitted(self, option: str):
        """The stable head producer for ``option`` (None for the two modes
        that ship no boundary activations): the same object on every call,
        so ``ActivationCodec.compress_head`` and any cache keyed on the
        producer see one identity per option."""
        if option in (UE_ONLY, SERVER_ONLY):
            return None
        return SW.head_producer(self.cfg, _split_of(option), self.ship_merged)

    def _tail_impl(self, params, payload, option: str):
        if option == SERVER_ONLY:
            return SW.forward_full(self.cfg, params, payload["img"])
        return SW.tail_apply(self.cfg, params, payload, _split_of(option))

    # -- accounting ----------------------------------------------------------
    def head_flops(self, option: str) -> int:
        if option == UE_ONLY:
            return SW.total_flops(self.cfg)
        if option == SERVER_ONLY:
            return 0
        return SW.head_flops(self.cfg, _split_of(option))

    def tail_flops(self, option: str) -> int:
        if option == UE_ONLY:
            return 0
        if option == SERVER_ONLY:
            return SW.total_flops(self.cfg)
        return SW.tail_flops(self.cfg, _split_of(option))

    def payload_specs(self, option: str) -> List[Tuple[Tuple[int, ...], str]]:
        """(shape, dtype) per shipped tensor, batch dim excluded."""
        if option == UE_ONLY:
            return []
        if option == SERVER_ONLY:
            return [((self.cfg.img_h, self.cfg.img_w, 3), "uint8")]
        return [(s, self.cfg.dtype)
                for s in SW.boundary_shapes(self.cfg, _split_of(option),
                                            ship_merged=self.ship_merged)]


# ===========================================================================
# LM-family archs (technique generalization)
# ===========================================================================

def default_candidates(cfg: ModelConfig) -> Tuple[int, ...]:
    n = cfg.n_layers
    return tuple(sorted({min(max(1, round(n * q)), n - 1)
                         for q in (0.25, 0.5, 0.75)}))


@dataclass
class LMSplitPlan(_PlanBase):
    cfg: ModelConfig
    params: Any
    candidates: Tuple[int, ...] = ()
    workload: Workload = field(default_factory=lambda: Workload(n_tokens=128))
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if not self.candidates:
            self.candidates = default_candidates(self.cfg)

    @property
    def options(self) -> List[str]:
        return ([UE_ONLY] + [split_option(l) for l in self.candidates]
                + [SERVER_ONLY])

    # -- execution (prefill-style single-shot inference) ---------------------
    def _embed(self, params, batch) -> torch.Tensor:
        """The whole batch (tokens, frames, patches) on the plan's device,
        through ``embed_inputs``."""
        return T.embed_inputs(self.cfg, params, {
            name: torch.as_tensor(x, device=self.device)
            for name, x in batch.items()})

    def head(self, batch, option: str):
        """UE-side layers.  Returns (payload_or_None, logits_or_None): the
        payload of a split is ``{"h": (B, S, d)}`` after layer l."""
        if option == SERVER_ONLY:
            return dict(batch), None
        h = self._embed(self.params, batch)
        hi = self.cfg.n_layers if option == UE_ONLY else _split_of(option)
        h, _, _ = T.forward_slice(self.cfg, self.params, h,
                                  T.positions_for(h), 0, hi)
        if option == UE_ONLY:
            return None, self._finish(self.params, h)
        return {"h": h}, None

    def _tail_impl(self, params, payload, option: str):
        if option == SERVER_ONLY:
            h, lo = self._embed(params, payload), 0
        else:
            h, lo = payload["h"], _split_of(option)
        h, _, _ = T.forward_slice(self.cfg, params, h, T.positions_for(h),
                                  lo, self.cfg.n_layers)
        return self._finish(params, h)

    def _finish(self, params, h: torch.Tensor) -> torch.Tensor:
        h = rms_norm(h, params["final_norm"], self.cfg.norm_eps)
        return T.unembed(self.cfg, params, h[:, -1:])

    # -- accounting ----------------------------------------------------------
    def _layer_flops(self) -> float:
        # 2ND forward flops per token, each layer's share
        return 2.0 * count_active_params(self.cfg) / self.cfg.n_layers

    def head_flops(self, option: str) -> float:
        if option == UE_ONLY:
            return (self._layer_flops() * self.cfg.n_layers
                    * self.workload.n_tokens)
        if option == SERVER_ONLY:
            return 0.0
        return self._layer_flops() * _split_of(option) * self.workload.n_tokens

    def tail_flops(self, option: str) -> float:
        total = (self._layer_flops() * self.cfg.n_layers
                 * self.workload.n_tokens)
        return total - self.head_flops(option)

    def payload_specs(self, option: str) -> List[Tuple[Tuple[int, ...], str]]:
        """(shape, dtype) per shipped tensor, batch dim excluded.  With
        ``workload.include_state`` the recurrent state of the head's l
        layers is counted beside the stream, as the JAX package counts it:
        mLSTM C (l, nh, hd, hd) for the SSM family, mamba h (l, d_inner, N)
        for the hybrid one, float32.  ``head`` itself ships the stream
        only, as there."""
        cfg = self.cfg
        seq_len = self.workload.n_tokens
        if option == UE_ONLY:
            return []
        if option == SERVER_ONLY:
            # counted as the JAX package counts it: S token ids, even where
            # the raw input is float frames or patches (``head`` ships the
            # batch as it is)
            return [((seq_len,), "int32")]
        specs = [((seq_len, cfg.d_model), cfg.dtype)]
        if self.workload.include_state and cfg.family in ("ssm", "hybrid"):
            l = _split_of(option)
            di = cfg.ssm_expand * cfg.d_model
            if cfg.family == "ssm":
                hd = di // cfg.n_heads
                specs.append(((l, cfg.n_heads, hd, hd), "float32"))
            else:
                specs.append(((l, di, cfg.ssm_state), "float32"))
        return specs
