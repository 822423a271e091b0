"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA card (a CUDA kernel has no CPU mode): they are
marked ``cuda`` and skip without one.  On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

They import no JAX: the plain versions are held against the JAX package by
the CPU tests, and here the kernels are held against the plain versions on
the same inputs (window attention within 1e-4, both fp32 with sums in other
orders, and on bf16 qkv within 1e-2 of each output row's max, one rounding
of the output; the codec pair and the quant pair bitwise; flash attention's backward
kernels (and their SASS: HMMAs in every bf16 dK/dV and dQ kernel, no
atomic), and its log-sum-exp, which leaves its output bitwise; flash
attention, with and
without a sliding window or a logit soft-cap, and flash decode, with and
without a cap, within 1e-5 of the output's max |x| in f32, sums in other
orders, and 1e-2 in bf16, one rounding of the output; a window of w >= Skv
and a cap of 0 bitwise the call without one), the Swin-T slice in fp32 and
in bf16 and the frame loop on the card against the same on the CPU, and
LM serving at the reduced size on the
card against the CPU path (xLSTM and Hymba too, past the ring's wrap;
musicgen's frames and codebooks, InternVL's patches, soft-capped and not).  The MoE FFN and MLA run no kernel: one full-width
layer of each on the card is held to the CPU path (routing equal).  The vectorized MAC has no kernel of its own: its
step's PyTorch ops on the card are held bit for bit to the CPU path (and
its lexsort to numpy's), with no host sync inside a step.  ``dense32`` and
``bmm32`` upcast under autograd because the half GEMMs with a float32
output have no derivative, which one case checks.
"""
import argparse
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs.swin_t_detection import reduced
from repro_torch.core.calibration import calibrate
from repro_torch.core.compression import ActivationCodec
from repro_torch.core.pipeline import SplitInferencePipeline
from repro_torch.core.splitting import SwinSplitPlan, split_option
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.core.splitting import LMSplitPlan, Workload
from repro_torch.kernels import codec as ck
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import quant as qk
from repro_torch.kernels import window_attention as wa
from repro_torch.launch import serve as SV
from repro_torch.models import layers as L
from repro_torch.models import swin as SW
from repro_torch.models import transformer as T
from repro_torch.tree import tree_flatten, tree_map

pytestmark = pytest.mark.cuda
ATTN_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("B,Hp,Wp,window,shift,nh,hd", [
    (1, 14, 14, 7, 0, 3, 16),
    (2, 14, 14, 7, 3, 3, 16),
    (1, 14, 21, 7, 3, 2, 32),
    (1, 7, 14, 7, 3, 2, 16),
    (2, 8, 12, 4, 2, 2, 16),
    (1, 18, 18, 9, 4, 2, 32),
])
def test_window_attention_kernel_matches_plain(cuda, B, Hp, Wp, window, shift,
                                               nh, hd):
    g = torch.Generator().manual_seed(1)
    C, w2 = nh * hd, window * window
    qkv = torch.randn((B, Hp, Wp, 3 * C), generator=g).to(cuda)
    bias = torch.randn((nh, w2, w2), generator=g).to(cuda)
    mask = (torch.as_tensor(SW.shift_attn_mask(Hp, Wp, window, shift), device=cuda)
            if shift else None)
    kw = dict(window=window, shift=shift, n_heads=nh)
    out = wa.fused_window_attention_cuda(qkv, bias, mask, **kw)
    ref = wa.fused_window_attention_plain(qkv.cpu(), bias.cpu(),
                                          None if mask is None else mask.cpu(), **kw)
    torch.cuda.synchronize()
    assert float((out.cpu() - ref).abs().max()) <= ATTN_TOL


@pytest.mark.parametrize("mask_kind", ["none", "pad", "shifted"])
@pytest.mark.parametrize("hd", [16, 32])
@pytest.mark.parametrize("window", [4, 7, 8, 9])
def test_window_attention_tensor_core_tiles(cuda, window, hd, mask_kind):
    """B1 at w2 16, 49, 64 and 81 (query rows padded to 16, keys to 8 in the
    kernel) with no mask, the pad-strip mask and the shifted mask: within
    1e-4 of the plain version, finite, and two launches bitwise equal."""
    g = torch.Generator().manual_seed(window * 100 + hd)
    nh, w2 = 2, window * window
    Hp, Wp = 2 * window, 3 * window
    qkv = torch.randn((2, Hp, Wp, 3 * nh * hd), generator=g).to(cuda)
    bias = torch.randn((nh, w2, w2), generator=g).to(cuda)
    shift, mask = 0, None
    if mask_kind == "pad":
        mask = SW.pad_region_mask(Hp, Wp, Hp - 1, Wp - 2, window)
    elif mask_kind == "shifted":
        shift = window // 2
        mask = SW.shift_attn_mask(Hp, Wp, window, shift)
    mask = None if mask is None else torch.as_tensor(mask, device=cuda)
    kw = dict(window=window, shift=shift, n_heads=nh)
    ref = wa.fused_window_attention_plain(qkv, bias, mask, **kw)
    out = wa.fused_window_attention_cuda(qkv, bias, mask, **kw)
    again = wa.fused_window_attention_cuda(qkv, bias, mask, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert float((out - ref).abs().max()) <= ATTN_TOL
    assert torch.equal(out, again)


@pytest.mark.parametrize("block", [128, 256, 1024, 8192, 8320, 49152])
@pytest.mark.parametrize("delta", [False, True])
def test_codec_kernels_match_plain_bitwise(cuda, block, delta):
    """The codec pair against its plain version, bitwise, on the adversarial
    blocks, at every strip geometry (one row, rows fewer than the warps, one
    chunk, a ragged second chunk, six chunks); two launches bitwise equal."""
    x = torch.from_numpy(ck.codec_edge_blocks(block)).reshape(-1)
    q, s = ck.codec_encode_cuda(x.to(cuda), block, delta)
    q_again, s_again = ck.codec_encode_cuda(x.to(cuda), block, delta)
    q2, s2 = ck.codec_encode_plain(x, block, delta)
    assert q.dtype == q2.dtype
    assert torch.equal(q.cpu(), q2) and torch.equal(q, q_again)
    assert torch.equal(s.cpu().view(torch.int32), s2.view(torch.int32))
    assert torch.equal(s.view(torch.int32), s_again.view(torch.int32))
    y = ck.codec_decode_cuda(q, s, block, delta)
    y_again = ck.codec_decode_cuda(q, s, block, delta)
    y2 = ck.codec_decode_plain(q2, s2, block, delta)
    assert torch.equal(y.cpu().view(torch.int32), y2.view(torch.int32))
    assert torch.equal(y.view(torch.int32), y_again.view(torch.int32))


def test_codec_kernels_take_unaligned_views(cuda):
    """A stream that starts inside a 16-byte vector (encode) or a 4-byte
    word (decode) is copied by the wrapper, not read misaligned."""
    block = 256
    x = torch.from_numpy(ck.codec_edge_blocks(block)).reshape(-1)
    xs = torch.cat([torch.zeros(1), x]).to(cuda)[1:]
    assert xs.data_ptr() % 16
    q, s = ck.codec_encode_cuda(xs, block, True)
    q2, s2 = ck.codec_encode_plain(x, block, True)
    assert torch.equal(q.cpu(), q2)
    assert torch.equal(s.cpu().view(torch.int32), s2.view(torch.int32))
    qs = torch.cat([torch.zeros(1, dtype=q.dtype, device=cuda), q])[1:]
    assert qs.data_ptr() % 4
    y = ck.codec_decode_cuda(qs, s, block, True)
    y2 = ck.codec_decode_plain(q2, s2, block, True)
    assert torch.equal(y.cpu().view(torch.int32), y2.view(torch.int32))


def test_codec_kernels_refuse_blocks_over_the_limit(cuda):
    """Neither kernel takes a block larger than the largest one it is checked
    at (MAX_CUDA_BLOCK)."""
    block = ck.MAX_CUDA_BLOCK + 128
    x = torch.zeros((block,), device=cuda)
    with pytest.raises(ValueError, match="exceeds"):
        ck.codec_encode_cuda(x, block, True)
    q = torch.zeros((block,), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="exceeds"):
        ck.codec_decode_cuda(q, torch.ones((1,), device=cuda), block, True)


def test_slice_on_the_card_matches_the_cpu_path(cuda):
    """head -> compress_head -> decompress_group -> tail_batched at the
    reduced size, on the card and on the CPU, through every kernel."""
    cfg = reduced()
    g = torch.Generator().manual_seed(3)
    params = SW.init(cfg, g, device="cpu")
    for stage in params["stages"]:
        for bp in stage["blocks"]:
            bp["rel_bias"] = torch.randn(bp["rel_bias"].shape, generator=g)
    imgs = torch.rand((3, 1, cfg.img_h, cfg.img_w, 3), generator=g)
    outs = {}
    ops.LAUNCHES.clear()
    for dev in (cuda, torch.device("cpu")):
        p = tree_map(lambda a: a.to(dev), params)
        plan = SwinSplitPlan(cfg, p, device=dev)
        codec = ActivationCodec(mode="int8_delta_zlib", device=dev)
        opt = split_option(2)
        payloads = [codec.compress_head(plan.head_jitted(opt), p, img.to(dev))[0]
                    for img in imgs]
        outs[dev.type] = plan.tail_batched(codec.decompress_group(payloads),
                                           opt, pad_to=4)
    assert set(ops.LAUNCHES) == {"fused_window_attention", "codec_encode",
                                 "codec_decode"}
    for a_tree, b_tree in zip(outs["cuda"], outs["cpu"]):
        for a, b in zip(tree_flatten(a_tree)[0], tree_flatten(b_tree)[0]):
            a = a.cpu().numpy()
            assert np.isfinite(a).all()
            scale = max(1.0, float(b.abs().max()))
            assert float(np.abs(a - b.numpy()).max()) <= 2e-3 * scale


def test_bf16_slice_on_the_card_matches_the_cpu_path(cuda):
    """The same slice on the bf16 Swin-T: bf16 payload leaves, f32
    detections, every kernel launched, and the card within 5e-2 of each
    map's max |x| of the CPU path (both round to bf16 after sums in other
    orders, and a value rounded the other way moves all that follows; the
    JAX package's bf16 model is held to the same bound on the CPU)."""
    cfg = dataclasses.replace(reduced(), dtype="bfloat16")
    g = torch.Generator().manual_seed(3)
    params = SW.init(cfg, g, device="cpu")
    for stage in params["stages"]:
        for bp in stage["blocks"]:
            bp["rel_bias"] = torch.randn(bp["rel_bias"].shape, generator=g)
    imgs = torch.rand((3, 1, cfg.img_h, cfg.img_w, 3), generator=g)
    outs = {}
    ops.LAUNCHES.clear()
    for dev in (cuda, torch.device("cpu")):
        p = tree_map(lambda a: a.to(dev), params)
        plan = SwinSplitPlan(cfg, p, device=dev)
        codec = ActivationCodec(mode="int8_delta_zlib", device=dev)
        opt = split_option(2)
        heads = [codec.compress_head(plan.head_jitted(opt), p, img.to(dev))
                 for img in imgs]
        assert all(x.dtype == torch.bfloat16
                   for _, tree in heads for x in tree_flatten(tree)[0])
        outs[dev.type] = plan.tail_batched(
            codec.decompress_group([c for c, _ in heads]), opt, pad_to=4)
    assert ops.LAUNCHES["fused_window_attention"] == 3 * 2 + 3
    assert ops.LAUNCHES["codec_encode"] == 3 and ops.LAUNCHES["codec_decode"] == 1
    for a_tree, b_tree in zip(outs["cuda"], outs["cpu"]):
        for a, b in zip(tree_flatten(a_tree)[0], tree_flatten(b_tree)[0]):
            assert a.dtype == torch.float32
            a = a.cpu().numpy()
            assert np.isfinite(a).all()
            scale = max(1.0, float(b.abs().max()))
            assert float(np.abs(a - b.numpy()).max()) <= 5e-2 * scale


@pytest.mark.parametrize("mask_kind", ["none", "pad", "shifted"])
@pytest.mark.parametrize("hd", [16, 32])
@pytest.mark.parametrize("window", [4, 7, 9])
def test_window_attention_bf16_tiles(cuda, window, hd, mask_kind):
    """B1 on bf16 qkv: a bf16 output whose every row (one head's hd values
    at one pixel) lies within 1e-2 of that row's max |x| of the plain
    version (each side rounds its f32 result once), finite, and two
    launches bitwise equal."""
    g = torch.Generator().manual_seed(window * 100 + hd + 1)
    nh, w2 = 2, window * window
    Hp, Wp = 2 * window, 3 * window
    qkv = torch.randn((2, Hp, Wp, 3 * nh * hd), generator=g).to(
        device=cuda, dtype=torch.bfloat16)
    bias = torch.randn((nh, w2, w2), generator=g).to(cuda)
    shift, mask = 0, None
    if mask_kind == "pad":
        mask = SW.pad_region_mask(Hp, Wp, Hp - 1, Wp - 2, window)
    elif mask_kind == "shifted":
        shift = window // 2
        mask = SW.shift_attn_mask(Hp, Wp, window, shift)
    mask = None if mask is None else torch.as_tensor(mask, device=cuda)
    kw = dict(window=window, shift=shift, n_heads=nh)
    ref = wa.fused_window_attention_plain(qkv, bias, mask, **kw)
    out = wa.fused_window_attention_cuda(qkv, bias, mask, **kw)
    again = wa.fused_window_attention_cuda(qkv, bias, mask, **kw)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    d = (out.double() - ref.double()).abs().unflatten(-1, (nh, hd)).amax(-1)
    top = ref.double().abs().unflatten(-1, (nh, hd)).amax(-1).clamp_min(1e-30)
    assert float((d / top).max()) <= 1e-2
    assert torch.equal(out, again)


def _int_bits(t: torch.Tensor) -> torch.Tensor:
    return t.cpu().view(torch.int16 if t.element_size() == 2 else
                        torch.int8 if t.element_size() == 1 else torch.int32)


def _quant_leaf(case, block: int, dtype, device):
    """(the leaf on the card, its values on the host).  A shape gives scaled
    normals with a run of zeros; "edge" the codec's edge blocks flattened
    and cut a third of a block into the last (the subnormal-scale one);
    "view +4 B" a leaf starting one element (4 bytes in f32) into its
    storage, which the f32 wrapper copies; "poisoned tail" a 16-byte-aligned view followed in its storage
    by 1e30, which the kernel reads in place: a value read past n would
    raise that block's scale."""
    g = torch.Generator().manual_seed(4)
    if case == "edge":
        x = torch.from_numpy(ck.codec_edge_blocks(block).reshape(-1)
                             [:7 * block + block // 3])
    elif isinstance(case, tuple):
        x = torch.randn(case, generator=g) * 7
        if x.numel() > 300:
            x.view(-1)[100:300] = 0.0
    else:
        x = torch.randn((3 * block + 4321,), generator=g) * 7
    x = x.to(dtype)
    if case == "view +4 B":
        buf = torch.zeros((x.numel() + 4,), dtype=dtype, device=device)
        leaf = buf[1:1 + x.numel()]
    elif case == "poisoned tail":
        buf = torch.full((x.numel() + 1024,), 1e30, dtype=dtype, device=device)
        leaf = buf[:x.numel()]
    else:
        return x.to(device), x
    leaf.copy_(x)
    return leaf, x


@pytest.mark.parametrize("case", [(1, 136, 200, 96), (311,), (), (0, 4),
                                  (3, 8192), (2, 13, 7, 24), "edge",
                                  "view +4 B", "poisoned tail"], ids=str)
@pytest.mark.parametrize("block", [128, 8192, ck.MAX_CUDA_BLOCK + 128, 65536])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_kernels_match_plain_bitwise(cuda, case, block, dtype):
    """B4a/B4b against their plain versions, bitwise, with a ragged last
    block, on unaligned and in-place views, at blocks above the codec's
    MAX_CUDA_BLOCK; two launches on the same input bitwise equal."""
    leaf, x = _quant_leaf(case, block, dtype, cuda)
    shape = tuple(x.shape)
    if case == "view +4 B":
        assert leaf.data_ptr() % 16 == leaf.element_size()
    q, s, n = qk.quant_cuda(leaf, block)
    q_again, s_again, _ = qk.quant_cuda(leaf, block)
    q2, s2, n2 = qk.quant_plain(x, block)
    assert n == n2 and torch.equal(q.cpu(), q2) and torch.equal(q, q_again)
    assert torch.equal(_int_bits(s), _int_bits(s2))
    assert torch.equal(_int_bits(s), _int_bits(s_again))
    y = qk.dequant_cuda(q, s, n, shape, dtype)
    y_again = qk.dequant_cuda(q, s, n, shape, dtype)
    y2 = qk.dequant_plain(q2, s2, n2, shape, dtype)
    assert y.dtype == dtype and tuple(y.shape) == shape
    assert torch.equal(_int_bits(y), _int_bits(y2))
    assert torch.equal(_int_bits(y), _int_bits(y_again))


@pytest.mark.parametrize("fused", [True, False])
def test_frame_loop_on_the_card_matches_the_cpu_path(cuda, tmp_path, fused):
    """run_frame at the reduced size for every option, on the card and on
    the CPU, with the same weights, frames and seeds: the same accounting,
    raw bytes equal and compressed bytes within 2 %, through the kernels of
    the codec configuration."""
    cfg = reduced()
    cache = tmp_path / "cache.json"
    cache.write_text(json.dumps({
        "ue_only": {"raw": 0, "compressed": 0},
        "split1": {"raw": 15667200, "compressed": 3352860},
        "split2": {"raw": 18278400, "compressed": 3814666},
        "split3": {"raw": 19584000, "compressed": 4073777},
        "split4": {"raw": 19584000, "compressed": 4065219},
        "server_only": {"raw": 1305600, "compressed": 1305600}}))
    params = SW.init(cfg, torch.Generator().manual_seed(5), device="cpu")
    img = torch.rand((1, cfg.img_h, cfg.img_w, 3),
                     generator=torch.Generator().manual_seed(6))
    logs = {}
    ops.LAUNCHES.clear()
    for dev in (cuda, torch.device("cpu")):
        pipe = SplitInferencePipeline(
            plan=SwinSplitPlan(cfg, tree_map(lambda a: a.to(dev), params),
                               device=dev),
            system=calibrate(cache_path=str(cache), device=dev),
            codec=ActivationCodec(fused=fused, device=dev), seed=1)
        logs[dev.type] = [pipe.run_frame(img.to(dev), -20.0, opt)
                          for opt in pipe.plan.options]
    kernels = {"codec_encode", "codec_decode"} if fused else {"quant", "dequant"}
    assert set(ops.LAUNCHES) == {"fused_window_attention"} | kernels
    for a, b in zip(logs["cuda"], logs["cpu"]):
        assert (a.option, a.raw_bytes, a.rate_bps, a.tx_s > 0) == (
            b.option, b.raw_bytes, b.rate_bps, b.tx_s > 0)
        assert abs(a.compressed_bytes - b.compressed_bytes) <= 0.02 * b.compressed_bytes


def _rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.double().cpu()
    return float((out.double().cpu() - ref).abs().max()) / float(ref.abs().max())


ATTN_KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,causal", [
    (2, 128, 128, 4, 4, 64, True),
    (2, 256, 256, 8, 2, 128, True),
    (2, 96, 96, 4, 1, 32, False),
    (1, 1, 130, 4, 2, 64, True),
    (1, 70, 200, 6, 2, 16, True),
    (2, 333, 333, 15, 5, 64, True),
    (2, 200, 520, 16, 8, 128, True),    # Sq < Skv at the serving widths
    (2, 333, 333, 16, 8, 128, True),    # ragged q and kv tiles
    (2, 150, 190, 4, 2, 32, True),
    (2, 200, 130, 8, 2, 128, False),    # non-causal, Sq > Skv
])
def test_flash_attention_kernel_matches_plain(cuda, dtype, B, Sq, Skv, H, KV,
                                              hd, causal):
    """Within tolerance of the plain version, and two launches on the same
    inputs give the same bits (no order-dependent sums)."""
    g = torch.Generator().manual_seed(7)
    q = torch.randn((B, Sq, H, hd), generator=g).to(cuda, dtype)
    k = torch.randn((B, Skv, KV, hd), generator=g).to(cuda, dtype)
    v = torch.randn((B, Skv, KV, hd), generator=g).to(cuda, dtype)
    out = fa.flash_attention_cuda(q, k, v, causal)
    again = fa.flash_attention_cuda(q, k, v, causal)
    ref = fa.flash_attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    assert _rel_err(out, ref) <= ATTN_KERNEL_TOL[dtype]
    assert torch.equal(out, again)


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,causal,w,cap", [
    (2, 127, 127, 2, 2, 16, True, 0, 0.0),      # G = 1
    (2, 128, 128, 4, 2, 32, True, 0, 0.0),      # G = 2, one whole tile
    (2, 129, 129, 6, 2, 64, True, 0, 0.0),      # G = 3, one row past it
    (2, 255, 255, 10, 2, 128, True, 0, 0.0),    # G = 5
    (1, 127, 255, 5, 1, 64, True, 0, 0.0),      # Sq < Skv
    (1, 129, 255, 3, 1, 128, True, 0, 0.0),
    (2, 128, 129, 4, 4, 16, True, 0, 0.0),
    (2, 255, 128, 4, 2, 32, False, 0, 0.0),     # non-causal, Sq > Skv
    (1, 129, 127, 6, 2, 128, False, 0, 0.0),
    (2, 255, 255, 6, 2, 64, True, 100, 0.0),    # windows across a kv tile's edge
    (1, 255, 255, 5, 1, 32, True, 129, 0.0),
    (2, 129, 255, 4, 2, 128, True, 127, 0.0),
    (2, 255, 255, 6, 2, 128, True, 0, 1.0),     # a binding cap
    (1, 128, 255, 10, 2, 16, True, 64, 50.0),
    (2, 127, 129, 3, 3, 64, False, 0, 1.0),
])
def test_flash_attention_bf16_at_the_tile_edges(cuda, B, Sq, Skv, H, KV, hd,
                                                causal, w, cap):
    """B5's bf16 kernel (q tiles of 128 rows, two warpgroups of 64, kv tiles
    of 128) at sequence lengths around its tiles, every head dim, G of 1,
    2, 3 and 5, windows whose edge falls inside a kv tile, caps, Sq < Skv
    and non-causal calls: within 1e-2 of each output row's max of the plain
    version, two launches bitwise equal, and the output bitwise the same
    with and without the log-sum-exp."""
    g = torch.Generator().manual_seed(Sq + Skv + hd + w)
    q = torch.randn((B, Sq, H, hd), generator=g).to(cuda, torch.bfloat16)
    k = torch.randn((B, Skv, KV, hd), generator=g).to(cuda, torch.bfloat16)
    v = torch.randn((B, Skv, KV, hd), generator=g).to(cuda, torch.bfloat16)
    out = fa.flash_attention_cuda(q, k, v, causal, w, cap)
    again = fa.flash_attention_cuda(q, k, v, causal, w, cap)
    with_lse, lse = fa.flash_attention_cuda(q, k, v, causal, w, cap,
                                            with_lse=True)
    ref = fa.flash_attention_plain(q, k, v, causal, w, cap).double()
    torch.cuda.synchronize()
    row_err = ((out.double() - ref).abs().amax(-1)
               / ref.abs().amax(-1).clamp_min(1e-30))
    assert float(row_err.max()) <= ATTN_KERNEL_TOL[torch.bfloat16]
    assert torch.equal(out, again)
    assert torch.equal(out, with_lse) and lse.shape == (B, H, Sq)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,w", [
    (2, 300, 300, 25, 5, 64, 64),       # Hymba's heads, a window of a tile
    (2, 1100, 1100, 25, 5, 64, 1024),   # Hymba's window, ragged
    (2, 200, 1300, 25, 5, 64, 1024),    # Sq < Skv
    (1, 130, 130, 4, 2, 32, 1),         # w = 1: the diagonal alone
    (2, 150, 190, 4, 2, 16, 17),        # a window across tile edges
    (2, 96, 96, 8, 2, 128, 50),
])
def test_flash_attention_window_matches_plain(cuda, dtype, B, Sq, Skv, H, KV,
                                              hd, w):
    """B5 with a sliding window within tolerance of the plain version, and
    two launches bitwise equal."""
    g = torch.Generator().manual_seed(17)
    q = torch.randn((B, Sq, H, hd), generator=g).to(cuda, dtype)
    k = torch.randn((B, Skv, KV, hd), generator=g).to(cuda, dtype)
    v = torch.randn((B, Skv, KV, hd), generator=g).to(cuda, dtype)
    out = fa.flash_attention_cuda(q, k, v, True, w)
    again = fa.flash_attention_cuda(q, k, v, True, w)
    ref = fa.flash_attention_plain(q, k, v, True, w)
    torch.cuda.synchronize()
    assert _rel_err(out, ref) <= ATTN_KERNEL_TOL[dtype]
    assert torch.equal(out, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("w", [300, 301, 5000])
def test_flash_attention_window_past_skv_is_the_causal_call(cuda, dtype, w):
    """A window of w >= Skv gives bitwise the output of no window."""
    g = torch.Generator().manual_seed(18)
    q = torch.randn((2, 250, 25, 64), generator=g).to(cuda, dtype)
    k = torch.randn((2, 300, 5, 64), generator=g).to(cuda, dtype)
    v = torch.randn((2, 300, 5, 64), generator=g).to(cuda, dtype)
    assert torch.equal(fa.flash_attention_cuda(q, k, v, True, w),
                       fa.flash_attention_cuda(q, k, v, True))


def _b6_shape(S, hd, dtype, lens, C, monkeypatch):
    """(S, kv_len per batch row) of a B6 case, with the kernel's cluster
    forced to C (None: the wrapper's plan).  S "wrap": every rank of C
    takes 7 or more sub-tiles (the ring wraps three times or more), the
    last cut short.  lens "edges": 0, 1, T - 1, T, T + 1 and the full cache;
    "wrap": 0, 1, a live count that ends inside a sub-tile, the full
    cache."""
    esize = torch.empty((), dtype=dtype).element_size()
    T = da.SUBTILE_BYTES // (hd * esize)
    if S == "wrap":
        S = 7 * C * T + T // 2
    if C is not None:
        plan = da.cluster_plan
        monkeypatch.setattr(da, "cluster_plan",
                            lambda *a: (C, plan(*a)[1]))
    if lens == "edges":
        lens = (0, 1, T - 1, T, T + 1, S)
    elif lens == "wrap":
        lens = (0, 1, 5 * T + T // 3, S)
    return S, lens


# (S, H, KV, hd, kv_len, C): the cluster's size forced to every C, over
# caches that wrap the ring; G of 1, 2, 3, 4, 6, 8 and 16
B6_CLUSTER_CASES = [("wrap", 16, 8, 128, "wrap", C) for C in (1, 2, 4, 8, 16)] + [
    ("wrap", 24, 24, 64, "wrap", 2), ("wrap", 48, 3, 32, "wrap", 4),
    ("wrap", 24, 8, 128, "wrap", 4), ("wrap", 16, 2, 64, "wrap", 2),
    ("wrap", 48, 8, 128, "wrap", 8), ("wrap", 8, 2, 16, "wrap", 16),
    (2080, 16, 8, 128, "edges", 16), (300, 4, 4, 64, (0, 1, 300), 16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("S,H,KV,hd,lens,C", [
    (512, 8, 2, 64, (170, 256, 512), None),
    (300, 4, 4, 64, (0, 1, 300), None),
    (100, 24, 2, 32, (99, 7), None),
    (2080, 16, 8, 128, (0, 2048, 2080, 1000), None),
    (40, 4, 2, 16, (40, 0, 3), None),
    (2080, 16, 8, 128, "edges", None),
    (600, 8, 2, 64, "edges", None),
    (1100, 48, 3, 32, "edges", None),
] + B6_CLUSTER_CASES)
def test_decode_attention_kernel_matches_plain(cuda, monkeypatch, dtype, S, H,
                                               KV, hd, lens, C):
    """Within tolerance of the plain version, zeros where kv_len is 0, and
    two launches give the same bits; "edges" takes kv_len at 0, 1, T - 1,
    T, T + 1 rows of the kernel's sub-tiles and the full cache; C forces
    the cluster's size (``_b6_shape``)."""
    S, lens = _b6_shape(S, hd, dtype, lens, C, monkeypatch)
    g = torch.Generator().manual_seed(8)
    B = len(lens)
    q = torch.randn((B, 1, H, hd), generator=g).to(cuda, dtype)
    ck_ = torch.randn((B, KV, S, hd), generator=g).to(cuda, dtype)
    cv_ = torch.randn((B, KV, S, hd), generator=g).to(cuda, dtype)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
    out = da.decode_attention_cuda(q, ck_, cv_, kv_len)
    again = da.decode_attention_cuda(q, ck_, cv_, kv_len)
    ref = da.decode_attention_plain(q, ck_, cv_, kv_len)
    torch.cuda.synchronize()
    assert _rel_err(out, ref) <= ATTN_KERNEL_TOL[dtype]
    assert torch.equal(out, again)
    for b, n in enumerate(lens):
        if n == 0:
            assert not out[b].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,w,cap", [
    (2, 300, 300, 16, 8, 128, 0, 1.0),      # qwen3's heads, a binding cap
    (2, 200, 520, 16, 8, 128, 0, 50.0),     # Gemma 2's cap, Sq < Skv
    (2, 256, 256, 48, 8, 128, 0, 1.0),      # InternVL's heads, G = 6
    (2, 300, 300, 25, 5, 64, 64, 1.0),      # windowed and capped
    (2, 333, 333, 24, 24, 64, 0, 1.0),      # musicgen's heads, G = 1
    (1, 70, 200, 6, 2, 16, 0, 0.5),
])
def test_flash_attention_softcap_matches_plain(cuda, dtype, B, Sq, Skv, H,
                                               KV, hd, w, cap):
    """B5 with a logit soft-cap within tolerance of the plain version (a cap
    of 1.0 binds on most scores of unit-normal q and k, so a cap applied in
    the bf16 body's base-2 units would miss), two launches bitwise equal."""
    g = torch.Generator().manual_seed(23)
    q = torch.randn((B, Sq, H, hd), generator=g).to(cuda, dtype)
    k = torch.randn((B, Skv, KV, hd), generator=g).to(cuda, dtype)
    v = torch.randn((B, Skv, KV, hd), generator=g).to(cuda, dtype)
    out = fa.flash_attention_cuda(q, k, v, True, w, cap)
    again = fa.flash_attention_cuda(q, k, v, True, w, cap)
    ref = fa.flash_attention_plain(q, k, v, True, w, cap)
    torch.cuda.synchronize()
    assert _rel_err(out, ref) <= ATTN_KERNEL_TOL[dtype]
    assert torch.equal(out, again)
    assert _rel_err(fa.flash_attention_plain(q, k, v, True, w), ref) > 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_zero_softcap_is_bitwise_the_uncapped_kernels(cuda, dtype):
    """cap = 0 takes the uncapped branch of both kernels: bitwise the call
    without the argument."""
    g = torch.Generator().manual_seed(24)
    q = torch.randn((2, 300, 16, 128), generator=g).to(cuda, dtype)
    k = torch.randn((2, 300, 8, 128), generator=g).to(cuda, dtype)
    v = torch.randn((2, 300, 8, 128), generator=g).to(cuda, dtype)
    assert torch.equal(fa.flash_attention_cuda(q, k, v, True, 0, 0.0),
                       fa.flash_attention_cuda(q, k, v, True))
    ck_, cv_ = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    lens = torch.tensor([1, 300], dtype=torch.int32, device=cuda)
    assert torch.equal(da.decode_attention_cuda(q[:, :1], ck_, cv_, lens, 0.0),
                       da.decode_attention_cuda(q[:, :1], ck_, cv_, lens))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("S,H,KV,hd,lens,cap,C", [
    (2080, 16, 8, 128, (1, 129, 2048, 2080), 1.0, None),   # a global cache
    (2080, 16, 8, 128, (0, 2048), 50.0, None),
    (1024, 25, 5, 64, (1, 1023, 1024), 1.0, None),         # Hymba's ring
    (2080, 24, 24, 64, (1, 2048, 2080), 1.0, None),        # musicgen's G = 1
    (2080, 48, 8, 128, (2048, 2049), 1.0, None),           # InternVL's G = 6
    (2080, 24, 24, 64, (5, 2048), 0.0, None),              # G = 1, no cap
    ("wrap", 16, 8, 128, "wrap", 1.0, 16),                 # the ring wraps
    ("wrap", 25, 5, 64, "wrap", 50.0, 4),
    ("wrap", 24, 24, 64, "wrap", 1.0, 1),
])
def test_decode_attention_softcap_matches_plain(cuda, monkeypatch, dtype, S, H,
                                                KV, hd, lens, cap, C):
    """B6 with a logit soft-cap (and at G = 1) within tolerance of the plain
    version, zeros where kv_len is 0, two launches bitwise equal; C forces
    the cluster's size (``_b6_shape``)."""
    S, lens = _b6_shape(S, hd, dtype, lens, C, monkeypatch)
    g = torch.Generator().manual_seed(25)
    B = len(lens)
    q = torch.randn((B, 1, H, hd), generator=g).to(cuda, dtype)
    ck_ = torch.randn((B, KV, S, hd), generator=g).to(cuda, dtype)
    cv_ = torch.randn((B, KV, S, hd), generator=g).to(cuda, dtype)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
    out = da.decode_attention_cuda(q, ck_, cv_, kv_len, cap)
    again = da.decode_attention_cuda(q, ck_, cv_, kv_len, cap)
    ref = da.decode_attention_plain(q, ck_, cv_, kv_len, cap)
    torch.cuda.synchronize()
    assert _rel_err(out, ref) <= ATTN_KERNEL_TOL[dtype]
    assert torch.equal(out, again)
    for b, n in enumerate(lens):
        if n == 0:
            assert not out[b].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("S,H,KV,hd,lens,cap,C", [
    (1040, 16, 8, 128, (1040, 460, 0, 1), 0.0, None),     # half of qwen3's cache
    (1040, 16, 8, 128, (1040, 0), 1.0, None),
    (512, 25, 5, 64, (512, 1, 0), 0.0, None),            # half of Hymba's ring
    (300, 24, 24, 64, (0, 300, 7), 0.0, None),            # musicgen's G = 1
    ("wrap", 16, 8, 128, "wrap", 0.0, 8),                 # the ring wraps
    ("wrap", 16, 8, 128, "wrap", 1.0, 16),
    ("wrap", 24, 24, 64, "wrap", 0.0, 2),
    ("wrap", 12, 1, 32, "wrap", 0.0, 1),
])
def test_decode_attention_partial_mode_matches_plain(cuda, monkeypatch, dtype,
                                                     S, H, KV, hd, lens, cap,
                                                     C):
    """B6's partial mode: out (float32 whatever q's dtype) and lse within
    tolerance of the plain version, lse -inf and out zeros where kv_len is
    0, two launches bitwise equal, its out rounded to q's dtype within one
    rounding of the default mode's, which stays bitwise what it is; C
    forces the cluster's size (``_b6_shape``)."""
    S, lens = _b6_shape(S, hd, dtype, lens, C, monkeypatch)
    g = torch.Generator().manual_seed(26)
    B = len(lens)
    q = torch.randn((B, 1, H, hd), generator=g).to(cuda, dtype)
    ck_ = torch.randn((B, KV, S, hd), generator=g).to(cuda, dtype)
    cv_ = torch.randn((B, KV, S, hd), generator=g).to(cuda, dtype)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
    out, lse = da.decode_attention_cuda(q, ck_, cv_, kv_len, cap, True)
    again = da.decode_attention_cuda(q, ck_, cv_, kv_len, cap, True)
    ref, ref_lse = da.decode_attention_plain(q, ck_, cv_, kv_len, cap, True)
    default = da.decode_attention_cuda(q, ck_, cv_, kv_len, cap)
    torch.cuda.synchronize()
    assert out.dtype == lse.dtype == torch.float32
    assert _rel_err(out, ref) <= ATTN_KERNEL_TOL[torch.float32]
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    live = kv_len > 0
    assert torch.isinf(lse[~live]).all() and (lse[~live] < 0).all()
    assert not out[~live].any()
    assert float((lse[live] - ref_lse[live]).abs().max()) <= 1e-4
    assert _rel_err(out.to(dtype), default) <= ATTN_KERNEL_TOL[dtype]
    assert torch.equal(default, da.decode_attention_cuda(q, ck_, cv_, kv_len,
                                                         cap))


@pytest.mark.parametrize("shape", [(2, 1, 256), (3, 5, 256)])
def test_dense32_bf16_on_the_card_matches_the_upcast(cuda, shape):
    """The tied unembedding's bf16 GEMM with a float32 output on the card
    against float32 products of the same bf16 values on the CPU; ``w`` is a
    transposed view, as ``embed.T`` is."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(shape, generator=g).to(torch.bfloat16)
    w = torch.randn((1000, shape[-1]), generator=g).to(torch.bfloat16).T
    got = L.dense32(x.to(cuda), w.to(cuda))
    assert got.dtype == torch.float32 and got.shape == shape[:-1] + (1000,)
    assert _rel_err(got, L.dense32(x, w)) <= 1e-5


def _slice_err(out: torch.Tensor, ref: torch.Tensor, top=None) -> float:
    """The worst (batch row, head) slice of a (B, S, heads, hd) gradient,
    relative to that slice's max |x| (or to ``top``).  Per slice, not per
    row: a query's dQ sums dS = P (dP - D), which cancels exactly for a row
    that sees one key, so that row is rounding noise against rounding
    noise."""
    d = (out.double() - ref.double()).abs().amax(dim=(1, 3))
    if top is None:
        top = ref.double().abs().amax(dim=(1, 3)).clamp_min(1e-30)
    return float((d / top).max())


BWD_CASES = [
    (2, 300, 15, 5, 64, 0, 0.0),        # smollm-360m's heads
    (2, 333, 4, 2, 128, 0, 0.0),        # ragged, qwen3's head dim
    (1, 1100, 25, 5, 64, 1024, 0.0),    # Hymba's window, ragged
    (2, 200, 4, 2, 16, 0, 1.0),         # a binding cap
    (2, 256, 4, 2, 32, 0, 50.0),        # Gemma 2's cap
    (2, 192, 24, 24, 64, 0, 0.0),       # musicgen's G = 1
    (2, 150, 4, 2, 64, 17, 1.0),        # window and cap across tile edges
    (2, 1, 4, 2, 128, 4, 0.0),          # one row
    (2, 15, 4, 2, 128, 4, 0.0),         # less than a warp's 16 rows
    (2, 65, 4, 2, 128, 17, 0.0),        # one row past a 64-row tile
    (2, 100, 4, 4, 16, 0, 1.0),         # one k-step, G = 1, a binding cap
    # the wgmma body's tile edges: 64 rows a consumer warpgroup and a dK/dV
    # q step at hd <= 64 (32 at hd 128), 128 kv rows a dQ step (64 at hd
    # 128) and 128 rows a CTA; G of 1, 2, 3 and 5 over every hd
    (2, 63, 6, 2, 64, 0, 0.0),          # one row short of 64, G = 3
    (2, 64, 4, 4, 32, 0, 0.0),          # 64 rows, G = 1
    (2, 65, 10, 2, 16, 0, 0.0),         # one row past 64, G = 5
    (2, 127, 4, 2, 128, 0, 0.0),        # one row short of a CTA, G = 2
    (2, 128, 6, 2, 64, 0, 1.0),         # a CTA's rows, a binding cap
    (2, 129, 10, 2, 32, 0, 50.0),       # one row past a CTA, Gemma 2's cap
    (2, 257, 6, 2, 128, 0, 0.0),        # two CTAs and a row
    (2, 257, 10, 2, 64, 100, 0.0),      # a window edge inside kv and q tiles
    (2, 200, 6, 2, 16, 40, 50.0),       # a window inside a dK/dV q step, capped
    (2, 129, 4, 4, 128, 70, 1.0),       # a window past a 32-row q step, G = 1
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("B,S,H,KV,hd,w,cap", BWD_CASES)
def test_flash_attention_backward_matches_plain(cuda, dtype, B, S, H, KV, hd,
                                                w, cap):
    """B5's backward kernels against ``flash_attention_bwd_plain`` on the
    same inputs (the kernel's forward output and log-sum-exp), each
    gradient's (batch row, head) slices within the kernel tolerance, and two
    launches bitwise equal (no atomics)."""
    g = torch.Generator().manual_seed(23)
    q = torch.randn((B, S, H, hd), generator=g).to(cuda, dtype)
    k = torch.randn((B, S, KV, hd), generator=g).to(cuda, dtype)
    v = torch.randn((B, S, KV, hd), generator=g).to(cuda, dtype)
    dout = torch.randn((B, S, H, hd), generator=g).to(cuda, dtype)
    out, lse = fa.flash_attention_cuda(q, k, v, True, w, cap, with_lse=True)
    ops.LAUNCHES.clear()
    got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, True, w, cap)
    again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, True, w, cap)
    ref = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, True, w, cap)
    torch.cuda.synchronize()
    assert dict(ops.LAUNCHES) == {name: 2 for name in fa.BWD_KERNELS}
    # at S = 1 each row sees one key, dS cancels exactly and dq, dk are
    # rounding noise on both sides: they are held to dv's max, the size of
    # the terms that cancel, as the CPU tests hold w = 1
    top = float(ref[2].double().abs().max()) if S == 1 else None
    for a, b, c, t in zip(got, again, ref, (top, top, None)):
        assert a.dtype == dtype and a.shape == c.shape
        assert torch.equal(a, b)
        assert _slice_err(a, c, t) <= ATTN_KERNEL_TOL[dtype]


def test_flash_attention_forward_sass(cuda):
    """The built forward library's SASS, read as ``chip_smoke.py``'s phase 2
    reads it: every bf16 instantiation (hd 16-128, capped and not) runs
    wgmma (HGMMA) fed by TMA (UTMALDG) and no mma.sync (HMMA)."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as CS
    fa._fn()                            # builds and loads the library
    counts = CS.fwd_build_facts("")
    assert any(CS.B5_FWD_KERNELS[0] in fn for fn in counts)


def test_flash_attention_backward_sass(cuda):
    """The built backward library's SASS, read with cuobjdump as
    ``chip_smoke.py``'s phase 17 (a) reads it: every bf16 dK/dV and dQ
    instantiation (hd 16-128, capped and not) runs wgmma (HGMMA) fed by TMA
    (UTMALDG) and no mma.sync (HMMA), and no backward kernel holds an
    atomic."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as CS
    fa._bwd_fns()                       # builds and loads the library
    counts = CS.bwd_build_facts("")
    assert any("_wgmma_kernel" in fn for fn in counts)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("Sq,Skv,w,cap", [(333, 333, 0, 0.0), (200, 520, 0, 0.0),
                                          (1100, 1100, 1024, 0.0),
                                          (256, 256, 0, 1.0)])
def test_flash_attention_lse_leaves_the_output_bitwise(cuda, dtype, Sq, Skv,
                                                       w, cap):
    """The forward with the log-sum-exp gives bitwise the output without
    it, and the log-sum-exp of the plain version's scores within 1e-5 of
    its magnitude (at least 1)."""
    g = torch.Generator().manual_seed(24)
    q = torch.randn((2, Sq, 10, 64), generator=g).to(cuda, dtype)
    k = torch.randn((2, Skv, 5, 64), generator=g).to(cuda, dtype)
    v = torch.randn((2, Skv, 5, 64), generator=g).to(cuda, dtype)
    out, lse = fa.flash_attention_cuda(q, k, v, True, w, cap, with_lse=True)
    assert torch.equal(out, fa.flash_attention_cuda(q, k, v, True, w, cap))
    _, ref = fa.flash_attention_plain(q, k, v, True, w, cap, with_lse=True)
    assert lse.shape == (2, 10, Sq) and lse.dtype == torch.float32
    assert float(((lse - ref).abs() / ref.abs().clamp_min(1.0)).max()) <= 1e-5


@pytest.mark.parametrize("op", ["dense32", "bmm32"])
def test_half_gemms_with_f32_output_under_autograd(cuda, op):
    """``dense32``/``bmm32`` on bf16 operands: without a gradient they take
    the half GEMM with a float32 output, which has no derivative (its
    backward raises); with one they upcast the operands.  Both give the
    same products within 1e-5 of the output's max (exact products, float32
    sums in other orders), and the bf16 gradients match the CPU's upcast
    path within 1e-2 of each one's max (one rounding of float32 sums)."""
    g = torch.Generator().manual_seed(25)
    shapes = {"dense32": ((3, 40, 96), (96, 200)),
              "bmm32": ((4, 40, 96), (4, 96, 56))}[op]
    a, b = (torch.randn(s, generator=g).to(torch.bfloat16) for s in shapes)
    fn = getattr(L, op)
    ac, bc = a.to(cuda), b.to(cuda)
    with torch.no_grad():
        ref = fn(ac, bc)
    half = (torch.bmm(ac, bc, out_dtype=torch.float32) if op == "bmm32" else
            torch.mm(ac.reshape(-1, 96), bc, out_dtype=torch.float32))
    assert torch.equal(ref.reshape(half.shape), half)
    with pytest.raises(RuntimeError, match="derivative for aten::.*mm"):
        x = ac.clone().requires_grad_(True)
        (torch.bmm(x, bc, out_dtype=torch.float32) if op == "bmm32" else
         torch.mm(x.reshape(-1, 96), bc, out_dtype=torch.float32)).sum() \
            .backward()
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        x, w = (t.to(dev).requires_grad_(True) for t in (a, b))
        y = fn(x, w)
        if dev.type == "cuda":
            assert y.dtype == torch.float32
            assert _rel_err(y.detach(), ref) <= 1e-5
        (y * torch.linspace(-1, 1, y.shape[-1], device=dev)).sum().backward()
        grads[dev.type] = (x.grad, w.grad)
    for gc, gh in zip(grads["cuda"], grads["cpu"]):
        assert gc.dtype == torch.bfloat16
        assert _rel_err(gc, gh) <= ATTN_KERNEL_TOL[torch.bfloat16]


@pytest.mark.parametrize("arch", ["smollm-360m", "hymba-1.5b",
                                  "musicgen-medium"])
def test_training_on_the_card_matches_the_cpu_path(cuda, arch):
    """A reduced config (f32) on the same weights and batch: the loss and
    every gradient on the card within 1e-4 of the CPU's (relative to each
    leaf's max), through B5's forward (twice a layer: remat recomputes it)
    and its backward kernels (once a layer), and no other kernel: smollm's
    dense layers, Hymba's windowed attention beside its mamba heads,
    musicgen's frames, G = 1 and codebook heads."""
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch.steps import value_and_grad
    cfg = get_reduced_config(arch)
    params = T.init(cfg, torch.Generator().manual_seed(4), device="cpu")
    # 80 positions: past the reduced Hymba's window of 16
    batch = next(TokenStream(cfg, seq_len=80, batch=2, seed=4))
    got = {}
    for dev in (cuda, torch.device("cpu")):
        ops.LAUNCHES.clear()
        got[dev.type] = value_and_grad(
            cfg, tree_map(lambda a: a.to(dev), params),
            {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        if dev.type == "cuda":
            n = cfg.n_layers
            assert dict(ops.LAUNCHES) == {"flash_attention": 2 * n,
                                          **{k: n for k in fa.BWD_KERNELS}}
    (lc, gc), (lh, gh) = got["cuda"], got["cpu"]
    assert abs(float(lc) - float(lh)) <= 1e-5 * abs(float(lh))
    for a, b in zip(tree_flatten(gc)[0], tree_flatten(gh)[0]):
        if not b.abs().max():           # musicgen's token embedding: unused
            assert not a.abs().max()
        else:
            assert _rel_err(a, b) <= 1e-4


def test_lm_serving_on_the_card_matches_the_cpu_path(cuda):
    """Reduced qwen3-1.7b (f32) on the same weights and tokens: prefill,
    three decode steps and the split tail through the codec, on the card and
    on the CPU, logits within 1e-4 of their max |x|; then serve on the card
    launches B5, B6 and the codec pair as its config implies."""
    cfg = get_reduced_config("qwen3-1.7b")
    g = torch.Generator().manual_seed(9)
    params = T.init(cfg, g, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=g,
                         dtype=torch.int32)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        p = tree_map(lambda a: a.to(dev), params)
        with torch.no_grad():
            lg, caches = T.prefill(cfg, p, {"tokens": toks.to(dev)}, 27)
            got = [lg]
            tok = toks[:, -1:]
            for i in range(3):
                lg, caches = T.decode_step(cfg, p, caches,
                                           {"tokens": tok.to(dev)}, 24 + i)
                got.append(lg)
                tok = (tok + 1) % cfg.vocab_size
            plan = LMSplitPlan(cfg, p, candidates=(1,),
                               workload=Workload(n_tokens=24), device=dev)
            codec = ActivationCodec(device=dev)
            payload, _ = plan.head({"tokens": toks}, "split1")
            got.append(plan.tail(codec.decompress(codec.compress(payload)),
                                 "split1"))
        out[dev.type] = got
    for a, b in zip(out["cuda"], out["cpu"]):
        assert _rel_err(a, b) <= 1e-4
    ops.LAUNCHES.clear()
    st = SV.serve(argparse.Namespace(arch="qwen3-1.7b", reduced=True,
                                     prompt_len=16, gen=3, batch=2, split=0.5,
                                     device="cuda"))
    n = cfg.n_layers
    assert dict(ops.LAUNCHES) == {"flash_attention": 2 * n,
                                  "decode_attention": 3 * n,
                                  "codec_encode": 1, "codec_decode": 1}
    assert st["metrics"]["counters"]["nonfinite_logits_total"] == 0


@pytest.mark.parametrize("arch", ["xlstm-350m", "hymba-1.5b"])
def test_recurrent_serving_on_the_card_matches_the_cpu_path(cuda, arch):
    """Reduced xLSTM and Hymba (f32, Hymba's window of 16) on the same weights
    and tokens: a 20-token prefill and 20 decode steps (past the ring's
    wrap), on the card and on the CPU, logits within 1e-4 of their max |x|;
    then serve on the card launches the kernels its config implies."""
    cfg = get_reduced_config(arch)
    g = torch.Generator().manual_seed(19)
    params = T.init(cfg, g, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 20), generator=g,
                         dtype=torch.int32)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        p = tree_map(lambda a: a.to(dev), params)
        with torch.no_grad():
            lg, caches = T.prefill(cfg, p, {"tokens": toks.to(dev)}, 40)
            got = [lg]
            tok = toks[:, -1:]
            for i in range(20):
                lg, caches = T.decode_step(cfg, p, caches,
                                           {"tokens": tok.to(dev)}, 20 + i)
                got.append(lg)
                tok = (tok + 1) % cfg.vocab_size
        out[dev.type] = got
    for a, b in zip(out["cuda"], out["cpu"]):
        assert _rel_err(a, b) <= 1e-4
    ops.LAUNCHES.clear()
    st = SV.serve(argparse.Namespace(arch=arch, reduced=True, prompt_len=20,
                                     gen=3, batch=2, split=0.5, device="cuda"))
    n = cfg.n_layers
    want = {"codec_encode": 1, "codec_decode": 1}
    if cfg.hybrid:
        want.update(flash_attention=2 * n, decode_attention=3 * n)
    assert dict(ops.LAUNCHES) == want
    assert st["metrics"]["counters"]["nonfinite_logits_total"] == 0


def _frontend_prompt(cfg, B, S, g):
    """musicgen's frames (B, S, d), or InternVL's patches and S - P tokens,
    on the CPU."""
    if cfg.frontend == "audio_frames":
        return {"frames": torch.randn((B, S, cfg.d_model), generator=g)}
    P = cfg.n_frontend_tokens
    return {"patches": torch.randn((B, P, cfg.d_model), generator=g),
            "tokens": torch.randint(0, cfg.vocab_size, (B, S - P), generator=g,
                                    dtype=torch.int32)}


@pytest.mark.parametrize("cap", [0.0, 0.5])
@pytest.mark.parametrize("arch", ["musicgen-medium", "internvl2-26b"])
def test_frontend_serving_on_the_card_matches_the_cpu_path(cuda, arch, cap):
    """Reduced musicgen (frames in, two codebook heads, codebook tokens
    decoded) and InternVL (8 patches before the text), f32, optionally
    soft-capped, on the same weights and inputs: a 20-position prefill, six
    decode steps and the split tail through the codec, on the card and on
    the CPU, logits within 1e-4 of their max |x|; then serve on the card
    launches B5, B6 and the codec pair as its config implies."""
    cfg = get_reduced_config(arch).replace(attn_logit_softcap=cap)
    g = torch.Generator().manual_seed(29)
    params = T.init(cfg, g, device="cpu")
    prompt = _frontend_prompt(cfg, 2, 20, g)
    shape = (2, 1, cfg.n_codebooks) if cfg.n_codebooks else (2, 1)
    toks = torch.randint(0, cfg.vocab_size, (6,) + shape, generator=g,
                         dtype=torch.int32)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        p = tree_map(lambda a: a.to(dev), params)
        with torch.no_grad():
            lg, caches = T.prefill(cfg, p, {k: x.to(dev)
                                            for k, x in prompt.items()}, 26)
            got = [lg]
            for i in range(6):
                lg, caches = T.decode_step(cfg, p, caches,
                                           {"tokens": toks[i].to(dev)}, 20 + i)
                got.append(lg)
            plan = LMSplitPlan(cfg, p, candidates=(1,),
                               workload=Workload(n_tokens=20), device=dev)
            codec = ActivationCodec(device=dev)
            payload, _ = plan.head(prompt, "split1")
            got.append(plan.tail(codec.decompress(codec.compress(payload)),
                                 "split1"))
        out[dev.type] = got
    for a, b in zip(out["cuda"], out["cpu"]):
        assert _rel_err(a, b) <= 1e-4
    ops.LAUNCHES.clear()
    st = SV.serve(argparse.Namespace(arch=arch, reduced=True, prompt_len=16,
                                     gen=3, batch=2, split=0.5,
                                     device="cuda"))
    n = get_reduced_config(arch).n_layers
    assert dict(ops.LAUNCHES) == {"flash_attention": 2 * n,
                                  "decode_attention": 3 * n,
                                  "codec_encode": 1, "codec_decode": 1}
    assert st["metrics"]["counters"]["nonfinite_logits_total"] == 0


# card vs CPU for the MoE FFN and MLA at full width: f32 sums in other
# orders (the LM test above holds 1e-4); bf16 by a rounding of h or the
# output landing one bf16 step apart (2^-8 of a value, two of them)
MOE_CARD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "deepseek-v2-lite-16b"])
def test_moe_layer_on_the_card_matches_the_cpu(cuda, arch, dtype):
    """One full-width MoE layer (granite: 40 experts top-8; deepseek: 64
    top-6 and 2 shared) on 2 x 128 tokens: each token's set of experts and
    each (token, expert)'s keep and slot equal on the card and the CPU (the
    order within the set follows probabilities that may sit a few ulps
    apart, and decides only the order of the k-sum), y within MOE_CARD_TOL
    of its max |y|."""
    cfg = get_config(arch).replace(dtype=str(dtype).removeprefix("torch."))
    g = torch.Generator().manual_seed(5)
    p = L.moe_init(cfg, g)
    x = torch.randn((2, 128, cfg.d_model), generator=g).to(dtype)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        with torch.no_grad(), L.record_routing() as rec:
            y, aux = L.moe_apply(cfg, tree_map(lambda a: a.to(dev), p),
                                 x.to(dev))
        out[dev.type] = (y, aux, rec[0])
    (y, aux, r), (y_cpu, aux_cpu, r_cpu) = out["cuda"], out["cpu"]
    (e, o), (e_cpu, o_cpu) = r["idx"].cpu().sort(-1), r_cpu["idx"].sort(-1)
    assert torch.equal(e, e_cpu)
    for name in ("keep", "slot"):
        assert torch.equal(r[name].cpu().gather(-1, o),
                           r_cpu[name].gather(-1, o_cpu)), name
    assert y.dtype == dtype and _rel_err(y, y_cpu) <= MOE_CARD_TOL[dtype]
    assert abs(float(aux) - float(aux_cpu)) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_mla_decode_on_the_card_matches_the_cpu(cuda, dtype):
    """deepseek's full-width MLA layer: a 64-token prefill written into a
    72-row latent cache, then three absorbed decode steps into it, on the
    card and the CPU: outputs and cache rows within MOE_CARD_TOL."""
    cfg = get_config("deepseek-v2-lite-16b").replace(
        dtype=str(dtype).removeprefix("torch."))
    g = torch.Generator().manual_seed(6)
    p = L.mla_init(cfg, g)
    x = torch.randn((2, 67, cfg.d_model), generator=g).to(dtype)
    kind = T.LayerKind(attn="mla", ffn="moe")
    out = {}
    for dev in (cuda, torch.device("cpu")):
        pd, xd = tree_map(lambda a: a.to(dev), p), x.to(dev)
        pos = T.positions_for(xd)
        cache = T.block_cache_init(cfg, kind, 2, 72, dev)["attn"]
        with torch.no_grad():
            y, rows = L.mla_apply(cfg, pd, xd[:, :64], pos[:, :64])
            got = [y]
            for name in cache:
                cache[name][:, :64] = rows[name]
            for i in range(64, 67):
                y, _ = L.mla_apply(cfg, pd, xd[:, i:i + 1], pos[:, i:i + 1],
                                   cache=cache, cache_index=i)
                got.append(y)
        out[dev.type] = got + [cache["latent"], cache["k_rope"]]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert a.dtype == dtype and _rel_err(a, b) <= MOE_CARD_TOL[dtype]


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "deepseek-v2-lite-16b"])
def test_moe_serving_on_the_card_launches_as_its_config_implies(cuda, arch):
    """``serve`` of a reduced MoE arch on the card with ``--split``: GQA
    (granite) launches B5 once per layer in the prefill and across the
    split, B6 once per layer and step; MLA (deepseek) neither; the codec
    pair once each; no logit non-finite."""
    cfg = get_reduced_config(arch)
    ops.LAUNCHES.clear()
    st = SV.serve(argparse.Namespace(arch=arch, reduced=True, prompt_len=16,
                                     gen=3, batch=2, split=0.5,
                                     device="cuda"))
    n = cfg.n_layers
    want = {"codec_encode": 1, "codec_decode": 1}
    if not cfg.use_mla:
        want.update(flash_attention=2 * n, decode_attention=3 * n)
    assert dict(ops.LAUNCHES) == want
    assert st["metrics"]["counters"]["nonfinite_logits_total"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("nB,w2,nh,hd,masked", [
    (7, 49, 3, 32, True), (5, 49, 6, 32, False), (3, 64, 4, 64, True),
    (2, 81, 2, 32, False), (2, 144, 2, 128, True), (4, 16, 3, 16, True)])
def test_windows_kernel_matches_plain(cuda, dtype, nB, w2, nh, hd, masked):
    """B7 against its plain version on the same inputs, a fully masked row
    among them, within 1e-5 of each output row's max |x| in f32 (sums in
    other orders) and 1e-2 in bf16 (one rounding of the output)."""
    g = torch.Generator().manual_seed(w2 + hd)
    q, k, v = (torch.randn((nB, w2, nh, hd), generator=g).to(cuda, dtype)
               for _ in range(3))
    bias = torch.randn((nh, w2, w2), generator=g).to(cuda)
    mask = None
    if masked:
        mask = (torch.rand((nB, w2, w2), generator=g) < 0.7).to(cuda)
        mask[0, w2 // 2] = False
    ref = wa.window_attention_plain(q, k, v, bias, mask)
    n0 = ops.LAUNCHES["window_attention"]
    out = ops.window_attention(q, k, v, bias, mask)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["window_attention"] == n0 + 1
    assert out.dtype == dtype and out.shape == q.shape
    assert _rel_err(out, ref) <= (1e-2 if dtype == torch.bfloat16 else 1e-5)
    if masked and dtype == torch.float32:
        w2p = -(-w2 // 64) * 64
        torch.testing.assert_close(out[0, w2 // 2], v[0].sum(0) / w2p,
                                   rtol=1e-5, atol=1e-5)


def test_window_attention_refuses_windows_over_12(cuda):
    """B1's tiles hold at most 144 keys; window 13 is refused before any
    launch, and the plain version still takes it."""
    qkv = torch.zeros((1, 13, 13, 48), device=cuda)
    bias = torch.zeros((1, 169, 169), device=cuda)
    kw = dict(window=13, shift=0, n_heads=1)
    with pytest.raises(ValueError, match="w2 169"):
        wa.fused_window_attention_cuda(qkv, bias, None, **kw)
    assert wa.fused_window_attention_plain(qkv, bias, None, **kw).shape == (
        1, 13, 13, 16)


def test_windows_kernel_dead_rows_in_one_window(cuda):
    """B7 at w2 49 with several rows of one window fully masked: each such
    row is sum(v) / W2P, the rest within 1e-5 of each row's max of the plain
    version, every output finite, two launches bitwise equal."""
    g = torch.Generator().manual_seed(49)
    nB, w2, nh, hd = 6, 49, 3, 32
    q, k, v = (torch.randn((nB, w2, nh, hd), generator=g).to(cuda)
               for _ in range(3))
    bias = torch.randn((nh, w2, w2), generator=g).to(cuda)
    mask = (torch.rand((nB, w2, w2), generator=g) < 0.7).to(cuda)
    dead = (0, 7, 16, 17, 40, 48)
    mask[2, list(dead)] = False
    ref = wa.window_attention_plain(q, k, v, bias, mask)
    out = wa.window_attention_cuda(q, k, v, bias, mask)
    again = wa.window_attention_cuda(q, k, v, bias, mask)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.equal(out, again)
    assert _rel_err(out, ref) <= 1e-5
    w2p = -(-w2 // 64) * 64
    for t in dead:
        torch.testing.assert_close(out[2, t], v[2].sum(0) / w2p, rtol=1e-5,
                                   atol=1e-5)


def test_cell_on_the_card_matches_the_cpu_path(cuda, tmp_path):
    """A small executed lock-step cell (3 UEs, 2 slots, split 2, reduced
    Swin-T) on the card and on the CPU, same weights and frames: the same
    accounting fields and raw bytes, compressed bytes within 2 %, and one
    codec pair per slot's option group and the blocks of every head and
    batched tail launched."""
    from repro_torch.core.cell import CellSimulator
    cfg = reduced()
    cache = tmp_path / "cache.json"
    cache.write_text(json.dumps({
        "ue_only": {"raw": 0, "compressed": 0},
        "split1": {"raw": 15667200, "compressed": 3352860},
        "split2": {"raw": 18278400, "compressed": 3814666},
        "split3": {"raw": 19584000, "compressed": 4073777},
        "split4": {"raw": 19584000, "compressed": 4065219},
        "server_only": {"raw": 1305600, "compressed": 1305600}}))
    params = SW.init(cfg, torch.Generator().manual_seed(5), device="cpu")
    g = torch.Generator().manual_seed(6)
    imgs = [torch.rand((1, cfg.img_h, cfg.img_w, 3), generator=g)
            for _ in range(3)]
    res = {}
    for dev in (torch.device("cpu"), cuda):
        sim = CellSimulator(
            plan=SwinSplitPlan(cfg, tree_map(lambda a: a.to(dev), params),
                               device=dev),
            system=calibrate(cache_path=str(cache), device=dev), n_ues=3,
            seed=2, execute_model=True, device=dev)
        ops.LAUNCHES.clear()
        res[dev.type] = sim.run(np.full((2, 3), -20.0),
                                imgs=[i.to(dev) for i in imgs],
                                option="split2", keep_outputs=True)
    torch.cuda.synchronize()
    head_blocks = sum(cfg.depths[:2])
    assert dict(ops.LAUNCHES) == {
        "fused_window_attention": 2 * (3 * head_blocks
                                       + sum(cfg.depths) - head_blocks),
        "codec_encode": 2, "codec_decode": 2}
    for a, b in zip(res["cuda"].logs, res["cpu"].logs):
        assert (a.option, a.raw_bytes, a.rate_bps, a.head_s, a.tail_s) == (
            b.option, b.raw_bytes, b.rate_bps, b.head_s, b.tail_s)
        assert abs(a.compressed_bytes - b.compressed_bytes) <= 0.02 * b.compressed_bytes
    for slot in res["cuda"].outputs:
        for out in slot.values():
            assert all(torch.isfinite(x).all() for x in tree_flatten(out)[0])


# -- the vectorized MAC: its step's ops on the card, no kernel of its own ----------

def _mac_keys(seed, n):
    rng = np.random.default_rng(seed)
    ints = rng.integers(0, 4, n)
    floats = rng.choice([0.0, -0.0, 1.5, -2.0, np.inf, -np.inf, 3.25], n)
    fine = rng.random(n)
    fine[rng.random(n) < 0.3] = np.inf
    return [(ints,), (floats,), (fine, floats), (ints, floats, ints[::-1]),
            (np.arange(n)[::-1], ints, floats)]


@pytest.mark.parametrize("n", [7, 1000, 20000])
def test_mac_lexsort_on_the_card_matches_numpy(cuda, n):
    """The card sorts by radix: ties, inf and both zero signs must still
    give numpy's lexsort permutation."""
    from repro_torch.core.ran_vec import _lexsort
    for keys in _mac_keys(n, n):
        got = _lexsort([torch.as_tensor(np.array(k), device=cuda)
                        for k in keys])
        assert np.array_equal(got.cpu().numpy(), np.lexsort(keys))


def _mac_flow_bits(stream, flows):
    import dataclasses
    return [(dataclasses.asdict(f.req), f.cohort,
             [float(getattr(f, k)).hex() for k in (
                 "rem_bits", "bpp", "granted", "act_slots", "n_tx", "n_retx",
                 "finish_s", "granted_at_admit")],
             [float(v).hex() for v in dataclasses.astuple(stream.report(f))])
            for f in flows]


def _mac_steps_without_sync(monkeypatch):
    """Make every slot and stream step on the card raise if it syncs with
    the host (the loops read the stop code between steps, outside)."""
    from repro_torch.core import ran_vec as V
    for name in ("_slot_step", "_stream_step"):
        step = getattr(V, name)

        def no_sync_step(*a, step=step, **kw):
            if a[0].rem.is_cuda:
                torch.cuda.set_sync_debug_mode("error")
            try:
                return step(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        monkeypatch.setattr(V, name, no_sync_step)


@pytest.mark.parametrize("pol", ["rr", "pf", "edf"])
def test_mac_stream_on_the_card_matches_the_cpu(cuda, pol, monkeypatch):
    """A chaos drain with mass blackouts on the card equals the CPU path
    field for field, with the generators paired after it; no step syncs
    with the host."""
    from repro_torch.core import ran_vec as V
    from repro_torch.core.engine_vec import chaos_drain, synthetic_flows
    from repro_torch.core.ran import RanCell, RanConfig, make_policy
    _mac_steps_without_sync(monkeypatch)
    flows = synthetic_flows(300, seed=3, n_ues=40)
    blk = [(0.05, 0.25, list(range(0, 40, 2))), (0.12, 0.30, [1, 3, 5])]
    out = []
    for dev in ("cpu", cuda):
        s = V.VecRanStream(RanCell(policy=make_policy(pol),
                                   cfg=RanConfig(tti_s=0.002)), 40,
                           device=dev)
        rng = np.random.default_rng(7)
        done = chaos_drain(s, flows, rng, blackouts=blk)
        out.append((_mac_flow_bits(s, done), s.cell._tape.buf.tobytes(),
                    rng.random(), s.n_steps, s.n_ttis))
    assert len(out[0][0]) == 300
    assert out[0] == out[1]


@pytest.mark.parametrize("pol", ["rr", "pf", "edf"])
def test_mac_cells_on_the_card_match_the_cpu(cuda, pol, monkeypatch):
    """``MultiCellVecMac`` and a lone ``VecRanCell`` on the card: every
    report array equal to the CPU path's over two slots, no step syncing
    with the host."""
    from repro_torch.core.engine_vec import MultiCellVecMac, synthetic_city
    from repro_torch.core.ran import RanCell, RanConfig, make_policy
    from repro_torch.core.ran_vec import VecRanCell
    _mac_steps_without_sync(monkeypatch)
    batches = synthetic_city(300, 3, seed=4, mean_bytes=8000)
    got = []
    for dev in ("cpu", cuda):
        mac = MultiCellVecMac([RanCell(policy=make_policy(pol),
                                       cfg=RanConfig(n_prbs=50))
                               for _ in range(3)], device=dev)
        one = VecRanCell.from_cell(RanCell(policy=make_policy(pol),
                                           cfg=RanConfig(n_prbs=50),
                                           record_trace=True), device=dev)
        rngs = [np.random.default_rng(c) for c in range(4)]
        rows = []
        for _ in range(2):
            for out in mac.serve_slot_arrays(batches, rngs[:3]):
                rows.append({k: v.tobytes() for k, v in out.items()})
            b = batches[0]
            out = one.serve_slot_arrays(b["ue"], b["n_bytes"], b["enq"],
                                        b["dead"], b["link_rate_bps"],
                                        rngs[3])
            rows.append({k: v.tobytes() for k, v in out.items()})
            rows.append(one.grant_trace)
        got.append((rows, [r.random() for r in rngs]))
    assert got[0] == got[1]


@pytest.mark.parametrize("tti", [1e-3, 2e-3, 5e-3, 0.0125])
def test_mac_step_arithmetic_on_the_card_matches_the_cpu(cuda, tti):
    """The step's float arithmetic on random operands: PF's observe (dense
    and sparse), PF's grant and the idle jump's ceil(t / tti), bit for bit
    against the CPU.  On the card ``t / python_float`` multiplies by the
    reciprocal, so the step divides by ``_divisor``'s 0-d tensor."""
    from repro_torch.core import ran_vec as V
    g = torch.Generator().manual_seed(int(tti * 1e4))
    C, n, P = 4, 512, 512
    pfa = torch.rand((C, P), generator=g, dtype=torch.float64) * 3e7
    pfa[:, ::7] = 0.0
    ue = torch.stack([torch.randperm(P, generator=g)[:n] for _ in range(C)])
    active = torch.rand((C, n), generator=g) < 0.7
    delivered = (torch.rand((C, n), generator=g, dtype=torch.float64)
                 * 4e5).floor() + torch.rand((C, n), generator=g,
                                             dtype=torch.float64)
    bpp = torch.rand((C, n), generator=g, dtype=torch.float64) * 3e3 + 50.0
    rem = (torch.rand((C, n), generator=g, dtype=torch.float64) * 3e5).floor()
    z = torch.zeros((C, 1), dtype=torch.int64)
    t_end = torch.rand(4096, generator=g, dtype=torch.float64) * 0.3
    gidx = torch.randperm(n, generator=g)[:128]
    outs = []
    for dev in (torch.device("cpu"), cuda):
        d = V._divisor(tti, dev)
        a = [x.to(dev) for x in (pfa, ue, active, delivered, bpp, rem, z)]
        pfa_, ue_, act_, dlv_, bpp_, rem_, z_ = a
        need = V._need_prbs(act_, rem_, bpp_)
        outs.append([
            V._pf_observe(pfa_, act_, dlv_, ue_, d, z_),
            V._pf_observe_sparse(pfa_[0], gidx.to(dev), act_[0][gidx.to(dev)],
                                 ue_[0], dlv_[0][gidx.to(dev)], d, z_[0, 0]),
            V._grant_kernel(V._PF, 100, act_, need, bpp_, ue_, bpp_, d,
                            torch.zeros(C, dtype=torch.int64, device=dev),
                            pfa_),
            torch.ceil(t_end.to(dev) / d)])
    for x, y in zip(*outs):
        y = y.cpu()
        if x.dtype == torch.float64:
            x, y = x.view(torch.int64), y.view(torch.int64)
        assert torch.equal(x, y)
