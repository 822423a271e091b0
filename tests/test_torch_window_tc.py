"""A CPU mirror of the tensor-core body of B1 and B7, and the kernels on the
card held against it.

``csrc/window_attention.cu`` runs both products as ``mma.sync`` m16n8k8 TF32
with f32 sums, three products per f32 product (3xTF32).  The mirror below
takes the same arithmetic in f32 on the CPU: cvt.rna rounding to TF32 on the
bit pattern, hi/lo splits, the three products of each k8 step in the
kernel's order, the logits starting at the bias, query rows padded to 16 and
keys to 8 (padded keys at -inf, padded value rows zero), the TPU op's padded
keys in B7's denominator, and the output scaled by 1 / denominator after
P.V.

The mirror documents the arithmetic; on the CPU it checks nothing of the
kernel.  ``tests/test_torch_kernels.py`` holds it against the JAX package's
Pallas kernels (and shows one TF32 product missing them); the ``cuda`` case
here holds the kernels against it on the same inputs, so that a body that
drifts from the mirror shows on the card.  A CPU case also checks B1's
16-byte row pieces (the kernel's offset arithmetic) at every Swin-T stage
width, in f32 and bf16.  This file imports no JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import window_attention as twa
from repro_torch.models import swin as SW

# the kernel against the mirror: the same products in the same k8 steps;
# the MMA sums its eight products with its own rounding, not the CPU's, and
# that error grows with w2 and hd.  One TF32 product missing (1e-3 and more,
# tests/test_torch_kernels.py) is thousands of ulps.
MIRROR_ULPS = 128
F32_EPS = 2.0 ** -23


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero,
    as cvt.rna.tf32.f32 does."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1fff).view(torch.float32)


def _mm_tf32(acc, a, b, products):
    """acc + a @ b in k8 steps, each as the kernel's MMAs on one accumulator:
    a_lo.b_hi, a_hi.b_lo, a_hi.b_hi (products=3) or a_hi.b_hi alone (1)."""
    for k0 in range(0, a.shape[-1], 8):
        ah, bh = _tf32(a[..., k0:k0 + 8]), _tf32(b[..., k0:k0 + 8, :])
        if products == 3:
            acc = acc + _tf32(a[..., k0:k0 + 8] - ah) @ bh
            acc = acc + ah @ _tf32(b[..., k0:k0 + 8, :] - bh)
        acc = acc + ah @ bh
    return acc


def _tc_attend(q, k, v, bias, mask, pad_keys, products=3):
    """The kernels' per-window body: q, k, v (N, nh, w2, hd) f32, bias (nh,
    w2, w2), mask (N, w2, w2) bool or None.  Returns (N, nh, w2, hd)."""
    N, nh, w2, hd = q.shape
    mp, kp = -(-w2 // 16) * 16, -(-w2 // 8) * 8
    qs = torch.zeros((N, nh, mp, hd))
    qs[:, :, :w2] = q * torch.tensor(1.0 / np.sqrt(hd), dtype=torch.float32)
    ks, vs = torch.zeros((N, nh, kp, hd)), torch.zeros((N, nh, kp, hd))
    ks[:, :, :w2], vs[:, :, :w2] = k, v
    s = torch.zeros((N, nh, mp, kp))
    s[:, :, :w2, :w2] = bias                    # S starts at the bias
    s = _mm_tf32(s, qs, ks.transpose(-1, -2), products)
    if mask is not None:
        s[:, :, :w2, :w2] = s[:, :, :w2, :w2].masked_fill(~mask[:, None],
                                                          twa.NEG_INF)
    s[..., w2:] = -torch.inf                    # padded keys weigh exactly 0
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    den = e.sum(-1, keepdim=True)
    if pad_keys:
        den = den + pad_keys * torch.exp(twa.NEG_INF - m)
    o = _mm_tf32(torch.zeros((N, nh, mp, hd)), e, vs, products) * (1.0 / den)
    return o[:, :, :w2]


def _b1_mirror(qkv, bias, mask, *, window, shift, nh, products=3):
    """B1 on the CPU with the body above: roll, partition, attend,
    un-partition, roll back.  qkv (B, Hp, Wp, 3C) numpy; returns numpy."""
    x = torch.from_numpy(qkv)
    B, Hp, Wp, C3 = x.shape
    hd, w2 = C3 // 3 // nh, window * window
    nwh, nww = Hp // window, Wp // window
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    x = x.reshape(B, nwh, window, nww, window, 3, nh, hd)
    x = x.permute(0, 1, 3, 5, 6, 2, 4, 7).reshape(B * nwh * nww, 3, nh, w2, hd)
    m = None
    if mask is not None:
        m = torch.from_numpy(mask).repeat(B, 1, 1)
    o = _tc_attend(x[:, 0], x[:, 1], x[:, 2], torch.from_numpy(bias), m, 0,
                   products)
    o = o.reshape(B, nwh, nww, nh, window, window, hd)
    o = o.permute(0, 1, 4, 2, 5, 3, 6).reshape(B, Hp, Wp, nh * hd)
    if shift:
        o = torch.roll(o, (shift, shift), dims=(1, 2))
    return o.numpy()


def _b7_mirror(q, k, v, bias, mask, products=3):
    """B7 on the CPU with the body above, (nB, w2, nh, hd) numpy in and out."""
    t = [torch.from_numpy(x).permute(0, 2, 1, 3) for x in (q, k, v)]
    o = _tc_attend(*t, torch.from_numpy(bias),
                   None if mask is None else torch.from_numpy(mask),
                   twa.padded_keys(q.shape[1]), products)
    return o.permute(0, 2, 1, 3).numpy()


def _ulps_of_row_max(out, ref):
    """max |out - ref| over each output row, in f32 ulps of that row's
    max |ref|."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max(-1, keepdims=True) * F32_EPS
    return float((np.abs(out - ref) / scale).max())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("window,shift,hd", [(7, 3, 32), (7, 0, 16),
                                             (9, 4, 32)])
def test_b1_kernel_matches_the_mirror(cuda, window, shift, hd):
    """B1 on the card within MIRROR_ULPS of each row's max of the mirror on
    the same inputs (shifted mask where shifted)."""
    rng = np.random.default_rng(window + shift + hd)
    nh, w2 = 2, window * window
    Hp, Wp = 2 * window, 3 * window
    qkv = rng.normal(size=(2, Hp, Wp, 3 * nh * hd)).astype(np.float32)
    bias = rng.normal(size=(nh, w2, w2)).astype(np.float32)
    mask = (np.asarray(SW.shift_attn_mask(Hp, Wp, window, shift))
            if shift else None)
    exp = _b1_mirror(qkv, bias, mask, window=window, shift=shift, nh=nh)
    out = twa.fused_window_attention_cuda(
        torch.from_numpy(qkv).to(cuda), torch.from_numpy(bias).to(cuda),
        None if mask is None else torch.from_numpy(mask).to(cuda),
        window=window, shift=shift, n_heads=nh)
    assert _ulps_of_row_max(out.cpu().numpy(), exp) <= MIRROR_ULPS


@pytest.mark.cuda
@pytest.mark.parametrize("w2,hd", [(49, 32), (81, 64), (144, 128)])
def test_b7_kernel_matches_the_mirror(cuda, w2, hd):
    """B7 in f32 on the card within MIRROR_ULPS of each row's max of the
    mirror on the same inputs, masked, with two fully masked rows."""
    rng = np.random.default_rng(w2 + hd)
    nB, nh = 4, 2
    q, k, v = (rng.normal(size=(nB, w2, nh, hd)).astype(np.float32)
               for _ in range(3))
    bias = rng.normal(size=(nh, w2, w2)).astype(np.float32)
    mask = (rng.random((nB, w2, w2)) < 0.7) | np.eye(w2, dtype=bool)[None]
    mask[1, [0, w2 - 1]] = False
    exp = _b7_mirror(q, k, v, bias, mask)
    out = twa.window_attention_cuda(
        *(torch.from_numpy(x).to(cuda) for x in (q, k, v, bias, mask)))
    assert _ulps_of_row_max(out.cpu().numpy(), exp) <= MIRROR_ULPS


def _swin_stages():
    from repro_torch.configs.swin_t_detection import CONFIG, reduced
    return [(cfg.stage_dim(s), cfg.num_heads[s])
            for cfg in (reduced(), CONFIG) for s in range(cfg.n_stages)]


@pytest.mark.parametrize("C,nh", _swin_stages())
def test_b1_row_pieces_are_16_byte_aligned(C, nh):
    """B1 moves each head's slice of a pixel in 16-byte pieces (4 f32 or 8
    bf16 values) with cp.async and 16-byte stores: at every Swin-T stage
    width, reduced and full, each piece it gathers from qkv (B, Hp, Wp, 3C)
    (q, k at +C, v at +2C) and each it stores into out (B, Hp, Wp, C) starts
    at a multiple of 16 bytes, as the kernel computes the offsets."""
    hd = C // nh
    assert C % nh == 0 and hd in twa.SUPPORTED_HEAD_DIMS
    for esize in (4, 2):
        elems = 16 // esize
        pieces = np.arange(hd // elems) * elems
        for pix in (0, 1, 7, 12345):
            for h in range(nh):
                for part in (0, C, 2 * C):
                    assert ((pix * 3 * C + part + h * hd + pieces) * esize
                            % 16 == 0).all()
                assert ((pix * C + h * hd + pieces) * esize % 16 == 0).all()
