"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA card (a CUDA kernel has no CPU mode): they are
marked ``cuda`` and skip without one.  On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

They import no JAX: the plain versions are held against the JAX package by
the CPU tests, and here the kernels are held against the plain versions on
the same inputs (window attention within 1e-4, both fp32 with sums in other
orders; the codec bitwise).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.swin_t_detection import reduced
from repro_torch.core.compression import ActivationCodec
from repro_torch.core.splitting import SwinSplitPlan, split_option
from repro_torch.kernels import codec as ck
from repro_torch.kernels import ops
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
