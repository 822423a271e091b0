"""Swin Transformer backbone + detection head in PyTorch (the paper's model).

The counterpart of ``repro/models/swin.py``: patch embedding, four stages of
shifted-window attention blocks with patch merging between stages, an FPN
neck and an FCOS-style dense detection head.  Every public function keeps
the JAX package's NHWC layout, and the parameters keep its nesting (dicts of
tensors); dense weights are (in, out), conv weights are OIHW for
``F.conv2d`` (the JAX package stores HWIO; ``repro_torch.bridge`` converts).

The module is stage-structured for the paper's split points: S0 = after
patch embedding, S1..S4 = after stage 1..4.  ``head_apply`` / ``tail_apply``
run the partitioned forward and the detection neck and head always run on
the server side.

Window attention takes ``cfg.attn_impl``: ``"pallas"`` (the name the JAX
package gives its fused kernel path) goes through
``kernels.ops.fused_window_attention``, the hand-written CUDA kernel on the
card and its plain version on the CPU; ``"xla"`` is the plain rolled and
partitioned einsum path, kept as a cross-check.

``cfg.dtype`` is "float32" or "bfloat16", and a bf16 model rounds where the
JAX package's does: activations, residuals and weights are bf16 (products
accumulate in f32 and round once, ``dense``), while ``rel_bias``, the
attention logits and softmax, the MLP's GELU (``dense32``, the bias added in
f32) and the detections ``cls``, ``box`` and ``ctr`` stay f32, and
``layer_norm`` takes its statistics in f32.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.swin_t_detection import SwinConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (dense, dense32, dtype_of, einsum32,
                                       init_dense, layer_norm)
from repro_torch.tree import tree_map

# ---------------------------------------------------------------------------
# static tables (numpy, cached on the geometry; copied from the JAX package)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def rel_pos_index(window: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij"))          # (2,w,w)
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]               # (2,w2,w2)
    rel = rel.transpose(1, 2, 0) + (window - 1)
    return (rel[..., 0] * (2 * window - 1) + rel[..., 1]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def shift_attn_mask(Hp: int, Wp: int, window: int, shift: int) -> np.ndarray:
    """(nW, w2, w2) bool mask: True = may attend (same region)."""
    img = np.zeros((Hp, Wp), np.int32)
    cnt = 0
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    for hs in slices:
        for ws in slices:
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(Hp // window, window, Wp // window, window)
    win = win.transpose(0, 2, 1, 3).reshape(-1, window * window)
    return (win[:, :, None] == win[:, None, :])


@functools.lru_cache(maxsize=None)
def pad_region_mask(Hp: int, Wp: int, H: int, W: int,
                    window: int) -> np.ndarray:
    """(nW, w2, w2) bool mask isolating the (H:, W:) pad strip: padded
    tokens must not contaminate real ones (pad is its own region)."""
    img = np.zeros((Hp, Wp), np.int32)
    img[H:, :] = 1
    img[:, W:] = 2
    win = img.reshape(Hp // window, window, Wp // window, window)
    win = win.transpose(0, 2, 1, 3).reshape(-1, window * window)
    return (win[:, :, None] == win[:, None, :])


@functools.lru_cache(maxsize=None)
def _on_device(table: Callable[..., np.ndarray], args: Tuple[int, ...],
               device: torch.device) -> torch.Tensor:
    """One upload per (table, geometry, device); blocks reuse it."""
    arr = table(*args)
    if arr.dtype == np.int32:
        arr = arr.astype(np.int64)
    return torch.as_tensor(arr, device=device)


# ---------------------------------------------------------------------------
# init (the port's own, for runs with no JAX; parity tests bridge weights)
# ---------------------------------------------------------------------------

def _conv_init(g: torch.Generator, k: int, cin: int, cout: int,
               scale: float) -> torch.Tensor:
    """Drawn as the JAX package's HWIO (k, k, cin, cout), stored OIHW."""
    return init_dense(g, (k, k, cin, cout), scale).permute(3, 2, 0, 1).contiguous()


def _block_init(cfg: SwinConfig, g: torch.Generator, dim: int, n_heads: int):
    hidden = int(dim * cfg.mlp_ratio)
    return {
        "norm1_s": torch.ones(dim), "norm1_b": torch.zeros(dim),
        "qkv_w": init_dense(g, (dim, 3 * dim)), "qkv_b": torch.zeros(3 * dim),
        "rel_bias": torch.zeros(((2 * cfg.window - 1) ** 2, n_heads)),
        "proj_w": init_dense(g, (dim, dim)), "proj_b": torch.zeros(dim),
        "norm2_s": torch.ones(dim), "norm2_b": torch.zeros(dim),
        "mlp": {"w1": init_dense(g, (dim, hidden)), "b1": torch.zeros(hidden),
                "w2": init_dense(g, (hidden, dim)), "b2": torch.zeros(dim)},
    }


def cast_params(tree, dtype: torch.dtype):
    """A parameter tree in ``dtype``, as the JAX package casts its draws:
    every leaf but ``rel_bias``, which stays float32."""
    if isinstance(tree, dict):
        return {k: v if k == "rel_bias" else cast_params(v, dtype)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_params(v, dtype) for v in tree]
    return tree.to(dtype)


def init(cfg: SwinConfig, generator: torch.Generator, device="cuda"):
    """Random parameters with the JAX package's shapes, scales and nesting
    (``repro/models/swin.py::init``), drawn in float32 from a CPU
    ``generator``, cast to ``cfg.dtype`` as there (``rel_bias`` stays
    float32 and starts at zero) and placed on ``device``."""
    device = resolve_device(device)
    g = generator
    C, fd, p = cfg.embed_dim, cfg.fpn_dim, cfg.patch_size
    params: Dict[str, Any] = {
        "patch_embed": {
            "w": _conv_init(g, p, cfg.in_chans, C,
                            1.0 / math.sqrt(p * p * cfg.in_chans)),
            "b": torch.zeros(C), "norm_s": torch.ones(C),
            "norm_b": torch.zeros(C),
        },
        "stages": [],
    }
    for si, depth in enumerate(cfg.depths):
        dim = cfg.stage_dim(si)
        stage = {"blocks": [_block_init(cfg, g, dim, cfg.num_heads[si])
                            for _ in range(depth)]}
        if si < cfg.n_stages - 1:
            stage["merge"] = {"norm_s": torch.ones(4 * dim),
                              "norm_b": torch.zeros(4 * dim),
                              "w": init_dense(g, (4 * dim, 2 * dim))}
        params["stages"].append(stage)
    conv_scale = 1.0 / math.sqrt(9 * fd)
    params["fpn"] = {
        "lateral": [init_dense(g, (cfg.stage_dim(i), fd))
                    for i in range(cfg.n_stages)],
        "smooth": [_conv_init(g, 3, fd, fd, conv_scale)
                   for _ in range(cfg.n_stages)],
    }
    params["det_head"] = {
        "conv1": _conv_init(g, 3, fd, fd, conv_scale),
        "conv2": _conv_init(g, 3, fd, fd, conv_scale),
        "cls_w": init_dense(g, (fd, cfg.num_classes)),
        "cls_b": torch.full((cfg.num_classes,), -math.log((1 - 0.01) / 0.01)),
        "box_w": init_dense(g, (fd, 4)), "box_b": torch.zeros(4),
        "ctr_w": init_dense(g, (fd, 1)), "ctr_b": torch.zeros(1),
    }
    return tree_map(lambda a: a.to(device), cast_params(params, dtype_of(cfg)))


def spec(cfg: SwinConfig) -> Callable[[Any], Any]:
    """The sharding spec of Swin's weights: every leaf replicated (the
    model is small; activations split over the batch instead).  As in the
    JAX package, a function of the parameter tree; here it gives each leaf
    (None,) * ndim, which the rules place as replication."""
    def like(params):
        return tree_map(lambda a: (None,) * a.dim(), params)
    return like


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------

def window_attention(cfg: SwinConfig, p, x: torch.Tensor, Hp: int, Wp: int,
                     n_heads: int, shift: int,
                     mask: Optional[torch.Tensor]) -> torch.Tensor:
    """x: (B, Hp, Wp, C) pre-normed.  Returns (B, Hp, Wp, C)."""
    B, _, _, C = x.shape
    w = cfg.window
    w2 = w * w
    hd = C // n_heads
    idx = _on_device(rel_pos_index, (w,), x.device)
    bias = p["rel_bias"][idx].permute(2, 0, 1)               # (nh, w2, w2)

    if cfg.attn_impl == "pallas":
        # the fused kernel owns roll / partition / un-partition; qkv and
        # proj run on the image layout
        qkv = dense(x, p["qkv_w"]) + p["qkv_b"]
        out = ops.fused_window_attention(qkv, bias, mask, window=w,
                                         shift=shift, n_heads=n_heads)
        return dense(out, p["proj_w"]) + p["proj_b"]
    if cfg.attn_impl != "xla":
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")

    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    nwh, nww = Hp // w, Wp // w
    xw = x.reshape(B, nwh, w, nww, w, C).permute(0, 1, 3, 2, 4, 5)
    xw = xw.reshape(B * nwh * nww, w2, C)                    # (nB, w2, C)
    qkv = dense(xw, p["qkv_w"]) + p["qkv_b"]
    qkv = qkv.reshape(-1, w2, 3, n_heads, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]       # (nB, w2, nh, hd)
    logits = einsum32("nqhd,nkhd->nhqk", q, k) / math.sqrt(hd)
    logits = logits + bias[None]
    if mask is not None:
        nW = mask.shape[0]
        lg = logits.reshape(B, nW, n_heads, w2, w2)
        lg = lg.masked_fill(~mask[None, :, None], -1e9)
        logits = lg.reshape(-1, n_heads, w2, w2)
    attn = torch.softmax(logits, dim=-1)
    out = einsum32("nhqk,nkhd->nqhd", attn, v, out_dtype=x.dtype)
    out = out.reshape(-1, w2, C)
    out = dense(out, p["proj_w"]) + p["proj_b"]
    out = out.reshape(B, nwh, nww, w, w, C).permute(0, 1, 3, 2, 4, 5)
    out = out.reshape(B, Hp, Wp, C)
    if shift:
        out = torch.roll(out, (shift, shift), dims=(1, 2))
    return out


def swin_block(cfg: SwinConfig, p, x: torch.Tensor, H: int, W: int,
               n_heads: int, shift: int) -> torch.Tensor:
    """x: (B, H, W, C) unpadded feature map."""
    w = cfg.window
    Hp, Wp = -(-H // w) * w, -(-W // w) * w
    h = layer_norm(x, p["norm1_s"], p["norm1_b"], cfg.norm_eps)
    if (Hp, Wp) != (H, W):
        h = F.pad(h, (0, 0, 0, Wp - W, 0, Hp - H))
    mask = None
    if shift:
        mask = _on_device(shift_attn_mask, (Hp, Wp, w, shift), x.device)
    elif (Hp, Wp) != (H, W):
        mask = _on_device(pad_region_mask, (Hp, Wp, H, W, w), x.device)
    h = window_attention(cfg, p, h, Hp, Wp, n_heads, shift, mask)
    x = x + h[:, :H, :W]
    h2 = layer_norm(x, p["norm2_s"], p["norm2_b"], cfg.norm_eps)
    m = p["mlp"]
    # jax.nn.gelu defaults to the tanh approximation; it runs in f32 and
    # rounds once, after the GELU (a bf16 bias is promoted exactly in the
    # f32 add, with no cast of its own)
    h2 = F.gelu(dense32(h2, m["w1"]) + m["b1"],
                approximate="tanh").to(x.dtype)
    return x + (dense(h2, m["w2"]) + m["b2"])


def _nhwc_conv(x: torch.Tensor, w: torch.Tensor, stride: int,
               padding: int) -> torch.Tensor:
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def patch_embed(cfg: SwinConfig, p, img: torch.Tensor) -> torch.Tensor:
    """img: (B, H, W, 3) float in [0,1], cast to ``cfg.dtype``.  Returns
    (B, H/4, W/4, C).  A VALID 4x4 stride-4 conv, as the JAX package's."""
    x = _nhwc_conv(img.to(dtype_of(cfg)), p["w"], cfg.patch_size, 0) + p["b"]
    return layer_norm(x, p["norm_s"], p["norm_b"], cfg.norm_eps)


def patch_merge(cfg: SwinConfig, p, x: torch.Tensor) -> torch.Tensor:
    """(B,H,W,C) -> (B,ceil(H/2),ceil(W/2),2C).  The 2x2 gather order is
    (0,0),(0,1),(1,0),(1,1), the JAX package's (not torchvision's x0..x3)."""
    B, H, W, C = x.shape
    if H % 2 or W % 2:
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        H, W = x.shape[1], x.shape[2]
    x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, H // 2, W // 2, 4 * C)
    x = layer_norm(x, p["norm_s"], p["norm_b"], cfg.norm_eps)
    return dense(x, p["w"])


def stage_apply(cfg: SwinConfig, params, x: torch.Tensor, stage: int):
    """Run stage ``stage`` (blocks + trailing merge).  Returns
    (pre_merge_feature, post_merge_x)."""
    sp = params["stages"][stage]
    H, W = x.shape[1], x.shape[2]
    nh = cfg.num_heads[stage]
    for bi, bp in enumerate(sp["blocks"]):
        shift = 0 if bi % 2 == 0 else cfg.window // 2
        x = swin_block(cfg, bp, x, H, W, nh, shift)
    feat = x
    if "merge" in sp:
        x = patch_merge(cfg, sp["merge"], x)
    return feat, x


# ---------------------------------------------------------------------------
# split-structured forward (the paper's head/tail partition)
# ---------------------------------------------------------------------------

N_SPLITS = 5   # split l in {0..4}: 0 = after patch embed, k = after stage k


def head_apply(cfg: SwinConfig, params, img: torch.Tensor, split: int, *,
               ship_merged: bool = True) -> Dict[str, Any]:
    """Run the UE part: patch-embed + stages 1..split.  Returns the boundary
    payload {"feats": [stage outputs 1..split], "x": running tensor} ("x" is
    left out after stage 4, and when ``ship_merged`` is False the server
    recomputes the merge)."""
    x = patch_embed(cfg, params["patch_embed"], img)
    feats: List[torch.Tensor] = []
    for s in range(split):
        f, x = stage_apply(cfg, params, x, s)
        feats.append(f)
    payload: Dict[str, Any] = {"feats": feats}
    if split == 0 or (split < cfg.n_stages and ship_merged):
        payload["x"] = x
    return payload


def tail_apply(cfg: SwinConfig, params, boundary, split: int):
    """Run the server part: stages split+1..4, FPN, detection head."""
    feats = list(boundary["feats"])
    if "x" in boundary:
        x = boundary["x"]
    elif split < cfg.n_stages:                 # recompute merge server-side
        x = patch_merge(cfg, params["stages"][split - 1]["merge"], feats[-1])
    else:
        x = None
    for s in range(split, cfg.n_stages):
        f, x = stage_apply(cfg, params, x, s)
        feats.append(f)
    return detection_head(cfg, params, feats)


def forward_full(cfg: SwinConfig, params, img: torch.Tensor):
    return tail_apply(cfg, params, head_apply(cfg, params, img, 0), 0)


@functools.lru_cache(maxsize=None)
def head_producer(cfg: SwinConfig, split: int, ship_merged: bool = True):
    """A stable ``producer(params, img)`` per (config, split, ship_merged),
    the counterpart of the JAX package's ``head_apply_jit``: callers that
    cache on the producer's identity see the same object every frame."""
    def producer(params, img):
        return head_apply(cfg, params, img, split, ship_merged=ship_merged)
    return producer


# ---------------------------------------------------------------------------
# FPN + FCOS head
# ---------------------------------------------------------------------------

def _conv3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _nhwc_conv(x, w, 1, 1)              # SAME 3x3 stride 1


def detection_head(cfg: SwinConfig, params, feats):
    """feats: per-stage features (B, H_i, W_i, C_i).  Returns per-level dicts
    of cls/box/centerness maps (FCOS-style dense predictions)."""
    fpn = params["fpn"]
    lat = [dense(f, w) for f, w in zip(feats, fpn["lateral"])]
    outs = [None] * len(lat)
    prev = lat[-1]
    outs[-1] = prev
    for i in range(len(lat) - 2, -1, -1):     # top-down: repeat-upsample, crop
        up = prev.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        prev = lat[i] + up[:, :lat[i].shape[1], :lat[i].shape[2]]
        outs[i] = prev
    outs = [_conv3(o, w) for o, w in zip(outs, fpn["smooth"])]

    head = params["det_head"]
    levels = []
    for o in outs:
        h = torch.relu(_conv3(o, head["conv1"]))
        h = torch.relu(_conv3(h, head["conv2"]))
        # the predictions are f32 whatever the model's dtype: the f32
        # products promote a bf16 bias exactly
        levels.append({
            "cls": dense32(h, head["cls_w"]) + head["cls_b"],
            "box": torch.relu(dense32(h, head["box_w"]) + head["box_b"]),
            "ctr": dense32(h, head["ctr_w"]) + head["ctr_b"],
        })
    return levels


def detection_loss(cfg: SwinConfig, levels, targets) -> torch.Tensor:
    """Simple dense detection loss (focal-BCE cls + L1 box on positives),
    differentiable under autograd.

    levels: ``detection_head``'s per-level dicts.  targets: per level a dict
    of cls=(B,H,W) int labels, box=(B,H,W,4), pos=(B,H,W) bool, as tensors
    or numpy arrays.  A label outside [0, num_classes) one-hots to zeros, as
    ``jax.nn.one_hot`` does.  The paper itself runs inference only."""
    dev = levels[0]["cls"].device
    total = torch.zeros((), device=dev)
    classes = torch.arange(cfg.num_classes, device=dev)
    for lv, tg in zip(levels, targets):
        labels = torch.as_tensor(tg["cls"], device=dev)
        cls_t = (labels[..., None] == classes).float()
        pc = torch.sigmoid(lv["cls"])
        focal = -(cls_t * (1 - pc) ** 2 * torch.log(pc + 1e-8)
                  + (1 - cls_t) * pc ** 2 * torch.log(1 - pc + 1e-8))
        total = total + focal.mean()
        pos = torch.as_tensor(tg["pos"], device=dev)[..., None].float()
        box = torch.as_tensor(tg["box"], dtype=torch.float32, device=dev)
        l1 = (lv["box"] - box).abs() * pos
        total = total + l1.sum() / torch.clamp(pos.sum() * 4, min=1.0)
    return total


# ---------------------------------------------------------------------------
# analytic FLOPs (copied from the JAX package: plain Python)
# ---------------------------------------------------------------------------

def _block_flops(cfg: SwinConfig, H: int, W: int, C: int) -> int:
    w = cfg.window
    Hp, Wp = -(-H // w) * w, -(-W // w) * w
    n = Hp * Wp
    nw = n // (w * w)
    f = 0
    f += 2 * H * W * C * 3 * C                 # qkv
    f += 2 * nw * (w * w) * (w * w) * C * 2    # qk^T and pv
    f += 2 * H * W * C * C                     # proj
    f += 2 * H * W * C * int(cfg.mlp_ratio * C) * 2   # mlp
    return f


def stage_flops(cfg: SwinConfig) -> Dict[str, int]:
    """FLOPs per pipeline segment: patch_embed, stage0..3 (incl. merge), det."""
    out: Dict[str, int] = {}
    h, w = cfg.stage_hw(0)
    out["patch_embed"] = 2 * h * w * cfg.embed_dim * (cfg.patch_size ** 2 * cfg.in_chans)
    for s, depth in enumerate(cfg.depths):
        H, W = cfg.stage_hw(s)
        C = cfg.stage_dim(s)
        f = depth * _block_flops(cfg, H, W, C)
        if s < cfg.n_stages - 1:
            f += 2 * (H // 2) * (W // 2) * 4 * C * 2 * C   # patch merge
        out[f"stage{s}"] = f
    det = 0
    fd = cfg.fpn_dim
    for s in range(cfg.n_stages):
        H, W = cfg.stage_hw(s)
        C = cfg.stage_dim(s)
        det += 2 * H * W * C * fd                      # lateral
        det += 2 * H * W * fd * fd * 9                 # smooth 3x3
        det += 2 * 2 * H * W * fd * fd * 9             # two head convs
        det += 2 * H * W * fd * (cfg.num_classes + 5)  # predictors
    out["det"] = det
    return out


def total_flops(cfg: SwinConfig) -> int:
    return sum(stage_flops(cfg).values())


def head_flops(cfg: SwinConfig, split: int) -> int:
    """UE-side FLOPs for split l (0 = after patch embed)."""
    sf = stage_flops(cfg)
    f = sf["patch_embed"]
    for s in range(split):
        f += sf[f"stage{s}"]
    return f


def tail_flops(cfg: SwinConfig, split: int) -> int:
    return total_flops(cfg) - head_flops(cfg, split)


# ---------------------------------------------------------------------------
# activation payload accounting (paper Fig. 3 x-axis)
# ---------------------------------------------------------------------------

def boundary_shapes(cfg: SwinConfig, split: int, *,
                    ship_merged: bool = True) -> List[Tuple[int, ...]]:
    """Shapes (no batch dim) of every tensor shipped at split l."""
    shapes = []
    for s in range(split):                      # FPN needs stage outputs 1..l
        h, w = cfg.stage_hw(s)
        shapes.append((h, w, cfg.stage_dim(s)))
    if split == 0:
        h, w = cfg.stage_hw(0)
        shapes.append((h, w, cfg.stage_dim(0)))
    elif split < cfg.n_stages and ship_merged:
        h, w = cfg.stage_hw(split)
        shapes.append((h, w, cfg.stage_dim(split)))
    return shapes


def boundary_bytes(cfg: SwinConfig, split: int, dtype_bytes: int = 4, *,
                   ship_merged: bool = True) -> int:
    return sum(int(np.prod(s)) * dtype_bytes
               for s in boundary_shapes(cfg, split, ship_merged=ship_merged))
