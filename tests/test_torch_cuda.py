"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA card (a CUDA kernel has no CPU mode): they are
marked ``cuda`` and skip without one.  On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

They import no JAX: the plain versions are held against the JAX package by
the CPU tests, and here the kernels are held against the plain versions on
the same inputs (window attention within 1e-4, both fp32 with sums in other
orders; the codec pair and the quant pair bitwise), and the frame loop on the
card against the same loop on the CPU.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.configs.swin_t_detection import reduced
from repro_torch.core.calibration import calibrate
from repro_torch.core.compression import ActivationCodec
from repro_torch.core.pipeline import SplitInferencePipeline
from repro_torch.core.splitting import SwinSplitPlan, split_option
from repro_torch.kernels import codec as ck
from repro_torch.kernels import ops
from repro_torch.kernels import quant as qk
from repro_torch.kernels import window_attention as wa
from repro_torch.models import swin as SW
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


@pytest.mark.parametrize("block", [256, 1024, 8192])
@pytest.mark.parametrize("delta", [False, True])
def test_codec_kernels_match_plain_bitwise(cuda, block, delta):
    g = torch.Generator().manual_seed(2)
    x = torch.randn((7, block), generator=g) * 9
    x[1] = 0.0
    x[2] = (torch.arange(block) % 9 - 4).float() * 0.5 + 0.25
    x = x.reshape(-1)
    q, s = ck.codec_encode_cuda(x.to(cuda), block, delta)
    q2, s2 = ck.codec_encode_plain(x, block, delta)
    assert torch.equal(q.cpu(), q2)
    assert torch.equal(s.cpu().view(torch.int32), s2.view(torch.int32))
    y = ck.codec_decode_cuda(q, s, block, delta)
    y2 = ck.codec_decode_plain(q2, s2, block, delta)
    assert torch.equal(y.cpu().view(torch.int32), y2.view(torch.int32))


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


def _int_bits(t: torch.Tensor) -> torch.Tensor:
    return t.cpu().view(torch.int16 if t.element_size() == 2 else
                        torch.int8 if t.element_size() == 1 else torch.int32)


@pytest.mark.parametrize("shape", [(1, 136, 200, 96), (311,), (), (0, 4),
                                   (3, 8192), (2, 13, 7, 24)], ids=str)
@pytest.mark.parametrize("block", [128, 8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_kernels_match_plain_bitwise(cuda, shape, block, dtype):
    g = torch.Generator().manual_seed(4)
    x = (torch.randn(shape, generator=g) * 7).to(dtype)
    if x.numel() > 300:
        x.view(-1)[100:300] = 0.0
    q, s, n = qk.quant_cuda(x.to(cuda), block)
    q2, s2, n2 = qk.quant_plain(x, block)
    assert n == n2 and torch.equal(q.cpu(), q2)
    assert torch.equal(_int_bits(s), _int_bits(s2))
    y = qk.dequant_cuda(q, s, n, shape, dtype)
    y2 = qk.dequant_plain(q2, s2, n2, shape, dtype)
    assert y.dtype == dtype and tuple(y.shape) == shape
    assert torch.equal(_int_bits(y), _int_bits(y2))


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
