"""Swin-T object-detection backbone: the paper's own model (Fig. 2).

A copy of ``repro/configs/swin_t_detection.py``.  Swin-T (arXiv:2103.14030):
depths (2,2,6,2), dims (96,192,384,768), heads (3,6,12,24), window 7,
patch 4.  Detection input defaults to 800x544 RGB, matching the paper's
stated 1.312 MB input payload.

The four stage boundaries are the paper's split points S1..S4.  The
detection head (FPN + an FCOS-style dense head) always runs on the server.
"""
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class SwinConfig:
    name: str = "swin-t-detection"
    img_h: int = 544
    img_w: int = 800
    in_chans: int = 3
    patch_size: int = 4
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window: int = 7
    mlp_ratio: float = 4.0
    num_classes: int = 80
    fpn_dim: int = 256
    dtype: str = "float32"
    norm_eps: float = 1e-5
    # "pallas": the fused window-attention kernel (the name the JAX package
    # gives this path; here it is the CUDA kernel) | "xla": plain einsums
    attn_impl: str = "pallas"

    @property
    def n_stages(self) -> int:
        return len(self.depths)

    def stage_dim(self, i: int) -> int:
        return self.embed_dim * (2 ** i)

    def stage_hw(self, i: int) -> Tuple[int, int]:
        """Feature map H, W at the OUTPUT of stage i (post-merge for i>=1)."""
        h = -(-self.img_h // self.patch_size)
        w = -(-self.img_w // self.patch_size)
        for _ in range(i):
            h = -(-h // 2)
            w = -(-w // 2)
        return h, w


CONFIG = SwinConfig()


def reduced() -> SwinConfig:
    return SwinConfig(
        name="swin-reduced", img_h=56, img_w=56, embed_dim=16,
        depths=(1, 1, 2, 1), num_heads=(1, 2, 2, 4), window=7,
        num_classes=4, fpn_dim=32,
    )
