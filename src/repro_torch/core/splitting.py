"""Split plans: partition the Swin detector's forward pass at a boundary.

The counterpart of the Swin half of ``repro/core/splitting.py``.  The paper's
setting: split the Swin detection backbone after patch embedding or after
stage 1..4; the FPN and detection head always run on the server.  Execution
options follow paper Fig. 4: UE_ONLY, SPLIT(l), SERVER_ONLY.

``SwinSplitPlan`` here is the port's own class, not a subclass of the JAX
package's; callers of the JAX package that test ``isinstance`` against its
plan (calibration, the cell simulator) are not driven by the port yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.swin_t_detection import SwinConfig
from repro_torch.models import swin as SW
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
    frame (``n_tokens`` stays 1)."""
    n_tokens: int = 1
    include_state: bool = False


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
        return batch * sum(int(np.prod(s)) * np.dtype(d).itemsize
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
