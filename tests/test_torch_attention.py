"""The port's attention (B5 flash attention, B6 flash decode) against the JAX
package, on the CPU.

The plain versions (``repro_torch/kernels/flash_attention.py``,
``decode_attention.py``), which the CPU path runs and the card holds its
kernels against, are compared with the TPU kernels in interpret mode and with
the JAX package's jnp oracles (``kernels/ref.py``) on the same numpy inputs.
Tolerances: float32 within 2e-5 (the reference's own test tolerance; its
mirrors miss its kernels by up to 3.9e-7, and sums run in another order
here); bf16 within 2e-2 (one rounding of the output, as the reference's bf16
test).

The CUDA kernels cannot run here, so their arithmetic is pinned by mirrors
written in this file and held against the JAX package: B5's bf16 tensor-core
numerics (exact bf16 products, scaled f32 scores, a base-2 online softmax
over the kernel's 128-row kv tiles, P.V as P_hi.V + P_lo.V) within
B5_MIRROR_TOL of each
output row's max before the output cast, and B6's cluster (round-robin
sub-tiles, a running softmax a rank, the combine in rank order) in f32 on
the wrapper's own cluster plan within F32_TOL.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

F32_TOL = 2e-5
BF16_TOL = 2e-2
# B5's bf16 mirror against the f32 reference on the same bf16 values, per
# output row: the sums run in another order and P_hi + P_lo keeps P to about
# 2^-18 of itself (P_lo is rounded to bf16); rows miss by up to 5.4e-6 of
# their max here, one bf16 rounding of P by 2.8e-3 to 3.5e-3
B5_MIRROR_TOL = 1e-5
B5_KV_TILE = 128                # kWgBlockKV in csrc/flash_attention.cu


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _bf16_pair(x):
    """The same bf16 values for both sides: jnp rounds, torch takes its bits."""
    j = jnp.asarray(x, jnp.bfloat16)
    t = torch.from_numpy(np.asarray(j).view(np.uint16).copy()).view(torch.bfloat16)
    return j, t


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,causal", [
    (2, 128, 128, 4, 4, 64, True),      # MHA
    (2, 256, 256, 8, 2, 64, True),      # GQA
    (2, 96, 96, 4, 1, 32, True),        # MQA, ragged block
    (2, 128, 128, 4, 2, 128, True),     # wide head
    (2, 96, 96, 4, 1, 32, False),       # non-causal
    (2, 1, 128, 4, 2, 64, True),        # single query row
    (1, 70, 200, 4, 2, 16, True),       # Sq < Skv: q aligned to the end of kv
])
def test_flash_plain_matches_pallas_and_ref(B, Sq, Skv, H, KV, hd, causal):
    q, k, v = _normal(Sq * 7 + Skv, (B, Sq, H, hd), (B, Skv, KV, hd),
                      (B, Skv, KV, hd))
    out = fa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)), causal)
    kern = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=causal, block_q=64, block_kv=64,
                                  interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(kern), rtol=F32_TOL,
                               atol=F32_TOL)
    if causal:                  # the oracle is causal only
        exp = ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v))
        np.testing.assert_allclose(out.numpy(), np.asarray(exp), rtol=F32_TOL,
                                   atol=F32_TOL)


def test_flash_plain_bf16():
    q, k, v = _normal(3, (1, 128, 4, 64), (1, 128, 2, 64), (1, 128, 2, 64))
    (qj, qt), (kj, kt), (vj, vt) = _bf16_pair(q), _bf16_pair(k), _bf16_pair(v)
    out = fa.flash_attention_plain(qt, kt, vt, True)
    assert out.dtype == torch.bfloat16
    for exp in (flash_attention_pallas(qj, kj, vj, interpret=True),
                ref.flash_attention_ref(qj, kj, vj)):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(exp, np.float32),
                                   rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,w", [
    (2, 40, 40, 4, 2, 16, 16),          # Hymba's reduced window
    (1, 37, 37, 4, 2, 32, 1),           # w = 1: each row its own v row
    (2, 20, 53, 6, 2, 16, 8),           # Sq < Skv
    (1, 24, 24, 4, 4, 64, 100),         # w >= Skv: the causal mask alone
])
def test_flash_plain_with_a_window_matches_the_reference(B, Sq, Skv, H, KV,
                                                         hd, w):
    """B5's plain version with a sliding window against the JAX package's
    windowed prefill: ``plain_attention`` and the blockwise XLA path at
    blocks of 8 (``flash_attention_xla``, taken above ``attn_block_q``),
    float32 within F32_TOL."""
    from repro.models.attention_flash import flash_attention_xla
    from repro.models.layers import plain_attention
    q, k, v = _normal(Sq * 3 + w, (B, Sq, H, hd), (B, Skv, KV, hd),
                      (B, Skv, KV, hd))
    out = fa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)), True, w)
    qj, kj, vj = map(jnp.asarray, (q, k, v))
    refs = [flash_attention_xla(qj, kj, vj, causal=True, sliding_window=w,
                                block_q=8, block_kv=8)]
    if Sq == Skv:                # plain_attention aligns q to kv's start
        refs.append(plain_attention(qj, kj, vj, causal=True, sliding_window=w))
    for exp in refs:
        np.testing.assert_allclose(out.numpy(), np.asarray(exp), rtol=F32_TOL,
                                   atol=F32_TOL)
    if w == 1:
        vg = np.repeat(v, H // KV, axis=2)[:, Skv - Sq:]
        np.testing.assert_allclose(out.numpy(), vg, rtol=F32_TOL, atol=F32_TOL)
    if w >= Skv:
        torch.testing.assert_close(
            out, fa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                          True), rtol=0, atol=0)


def test_flash_window_takes_causal_attention_only():
    """The window is the causal mask's companion, as in ``plain_attention``;
    the CUDA wrapper makes the same check (``check_window``)."""
    t = torch.zeros((1, 8, 2, 16))
    for causal, w in ((False, 4), (True, -1)):
        with pytest.raises(ValueError, match="sliding window"):
            fa.flash_attention_plain(t, t, t, causal, w)


def test_ops_flash_attention_routes_cpu_tensors_to_the_plain_version():
    q, k, v = map(torch.from_numpy,
                  _normal(4, (1, 40, 4, 32), (1, 40, 2, 32), (1, 40, 2, 32)))
    torch.testing.assert_close(ops.flash_attention(q, k, v),
                               fa.flash_attention_plain(q, k, v, True),
                               rtol=0, atol=0)


@pytest.mark.parametrize("S,H,KV,hd,lens", [
    (512, 8, 2, 64, (170, 256, 512)),   # GQA, ragged lengths
    (300, 4, 4, 64, (0, 1, 300)),       # kv_len = 0 edge
    (64, 4, 4, 64, (10, 32, 64)),
    (100, 12, 1, 32, (99, 7, 0)),       # MQA, 12 query heads per kv head
])
def test_decode_plain_matches_pallas_and_ref(S, H, KV, hd, lens):
    B = len(lens)
    q, k, v = _normal(S + H, (B, 1, H, hd), (B, S, KV, hd), (B, S, KV, hd))
    kv_len = np.asarray(lens, np.int32)
    # the op keeps the reference's (B, S, KV, hd) cache and transposes it
    out = ops.decode_attention(*map(torch.from_numpy, (q, k, v, kv_len)))
    kern = decode_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(kv_len), block_kv=128,
                                   interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(kern), rtol=F32_TOL,
                               atol=F32_TOL)
    exp = np.asarray(ref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v), jnp.asarray(kv_len)))
    live = kv_len > 0           # the oracle spreads an empty row's softmax evenly
    np.testing.assert_allclose(out.numpy()[live], exp[live], rtol=F32_TOL,
                               atol=F32_TOL)
    assert not out.numpy()[~live].any()


def test_decode_kv_major_is_the_op_without_the_transpose():
    q, k, v = map(torch.from_numpy,
                  _normal(5, (2, 1, 8, 32), (2, 50, 2, 32), (2, 50, 2, 32)))
    kv_len = torch.tensor([17, 50], dtype=torch.int32)
    a = ops.decode_attention(q, k, v, kv_len)
    b = ops.decode_attention_kv_major(q, k.transpose(1, 2).contiguous(),
                                      v.transpose(1, 2).contiguous(), kv_len)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(b, da.decode_attention_plain(
        q, k.transpose(1, 2), v.transpose(1, 2), kv_len), rtol=0, atol=0)


def test_decode_plain_bf16():
    q, k, v = _normal(6, (2, 1, 4, 64), (2, 96, 2, 64), (2, 96, 2, 64))
    (qj, qt), (kj, kt), (vj, vt) = _bf16_pair(q), _bf16_pair(k), _bf16_pair(v)
    kv_len = np.asarray([96, 40], np.int32)
    out = ops.decode_attention(qt, kt, vt, torch.from_numpy(kv_len))
    assert out.dtype == torch.bfloat16
    exp = decode_attention_pallas(qj, kj, vj, jnp.asarray(kv_len), interpret=True)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(exp, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("fn,args", [
    (fa.flash_attention_cuda, lambda t: (t((1, 8, 2, 16)), t((1, 8, 2, 16)),
                                         t((1, 8, 2, 16)), True)),
    (da.decode_attention_cuda, lambda t: (t((1, 1, 2, 16)), t((1, 2, 8, 16)),
                                          t((1, 2, 8, 16)),
                                          torch.ones(1, dtype=torch.int32))),
])
def test_cuda_wrappers_refuse_host_tensors(fn, args):
    """A wrapper launches its kernel or raises: it never runs the plain
    version on the tensors it was given."""
    with pytest.raises(ValueError, match="CUDA device"):
        fn(*args(lambda s: torch.zeros(s)))


def _row_rel(out, ref):
    """The worst output row's max |out - ref| over that row's max |ref| (a
    row is one head's hd values at one position)."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    top = np.maximum(np.abs(ref).max(-1), 1e-30)
    return float((np.abs(out - ref).max(-1) / top).max())


def _b5_bf16_mirror(q, k, v, causal, split_p=True, tile=B5_KV_TILE,
                    softcap=0.0, cap_in_base2=False, window=0):
    """B5's bf16 arithmetic on the CPU, in f32: q.k^T of the bf16 values (each
    product exact in f32), times hd^-1/2 log2(e) rounded to f32, the
    online softmax in base 2 over kv tiles of ``tile`` rows, and P.V as
    P_hi.V + P_lo.V with P_hi = bf16(P), P_lo = bf16(P - P_hi) (or bf16(P).V
    with ``split_p`` off).  With ``softcap`` c the score is tanh(s hd^-1/2 /
    c) c log2(e), the cap in natural units as the kernel applies it, or with
    ``cap_in_base2`` the cap on the base-2 score, the mistake the kernel's
    note warns of.  A ``window`` w also masks keys at or below q_pos - w; the
    mirror walks every tile from 0, which the kernel's note shows is bitwise
    its skipping of tiles dead for all of a CTA's rows.  Returns (B, Sq, H,
    hd) f32, before the cast."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, Sq, KV, H // KV, hd).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]          # (B, KV, 1, Skv, hd)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    sm_scale = torch.tensor(1 / math.sqrt(hd), dtype=torch.float32)
    log2e = torch.tensor(math.log2(math.e), dtype=torch.float32)
    scale2 = sm_scale * log2e
    q_pos = torch.arange(Sq) + (Skv - Sq)
    m = torch.full(qf.shape[:-1], -1e30)
    l = torch.zeros(qf.shape[:-1])
    acc = torch.zeros(qf.shape)
    for j0 in range(0, Skv, tile):
        s = qf @ kf[..., j0:j0 + tile, :].transpose(-1, -2)
        if softcap and not cap_in_base2:
            s = torch.tanh(s * sm_scale / softcap) * softcap * log2e
        else:
            s = s * scale2
            if softcap:
                s = torch.tanh(s / softcap) * softcap
        if causal:
            k_pos = torch.arange(j0, min(j0 + tile, Skv))
            dead = k_pos[None, :] > q_pos[:, None]
            if window:
                dead |= k_pos[None, :] <= q_pos[:, None] - window
            s = s.masked_fill(dead, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        hi = p.to(torch.bfloat16).float()
        vt = vf[..., j0:j0 + tile, :]
        pv = hi @ vt
        if split_p:
            pv = pv + (p - hi).to(torch.bfloat16).float() @ vt
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,causal", [
    (2, 128, 128, 4, 2, 64, True),      # GQA, two kv tiles
    (1, 70, 200, 4, 2, 32, True),       # Sq < Skv, ragged last tile
    (1, 100, 100, 3, 1, 16, True),      # three query heads per kv head
    (2, 96, 130, 4, 2, 128, False),     # non-causal, wide head
])
def test_b5_bf16_tensor_core_numerics_match_the_reference(B, Sq, Skv, H, KV, hd,
                                                         causal):
    """B5's bf16 design (tensor-core products, P split into bf16 hi and lo)
    against the JAX package on the same bf16 values, before the output cast;
    one bf16 rounding of P instead misses by more than the tolerance, which
    is why the kernel pays for the second P.V product."""
    q, k, v = _normal(Sq * 11 + hd, (B, Sq, H, hd), (B, Skv, KV, hd),
                      (B, Skv, KV, hd))
    pairs = [_bf16_pair(x) for x in (q, k, v)]
    qt, kt, vt = (t for _, t in pairs)
    qj, kj, vj = (jnp.asarray(t.float().numpy()) for t in (qt, kt, vt))
    exps = [flash_attention_pallas(qj, kj, vj, causal=causal, block_q=64,
                                   block_kv=64, interpret=True)]
    if causal:                  # the oracle is causal only
        exps.append(ref.flash_attention_ref(qj, kj, vj))
    split = _b5_bf16_mirror(qt, kt, vt, causal).numpy()
    single = _b5_bf16_mirror(qt, kt, vt, causal, split_p=False).numpy()
    for exp in exps:
        assert _row_rel(split, exp) <= B5_MIRROR_TOL
        assert _row_rel(single, exp) > B5_MIRROR_TOL


def test_b5_mirror_tiles_as_the_kernel_does():
    """The mirror's kv tile is the kernel's: B5_KV_TILE is kWgBlockKV in
    the CUDA source, so the cases below sit at the kernel's tile edges."""
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / "flash_attention.cu").read_text()
    assert int(re.search(r"kWgBlockKV = (\d+);", src).group(1)) == B5_KV_TILE


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,w", [
    (1, 150, 200, 6, 2, 64, 0),         # Sq not a multiple of 128, a ragged kv tile, G = 3
    (1, 130, 130, 5, 1, 32, 0),         # G = 5, one row past a q tile
    (2, 129, 255, 10, 2, 16, 0),        # G = 5, Sq < Skv, a ragged kv tile
    (1, 200, 300, 6, 2, 64, 100),       # the window of row 128 starts mid-tile
])
def test_b5_bf16_mirror_at_the_kernels_tiles(B, Sq, Skv, H, KV, hd, w):
    """B5's bf16 design at the kernel's 128-row kv tiles, at the edges of
    its tiles, against the JAX package on the same bf16 values, before the
    output cast: the Pallas kernel (interpret mode) and ``ref.py``'s oracle,
    or, with a window, which neither takes, ``plain_attention``, where the
    JAX package runs windowed prefill; one bf16 rounding of P misses."""
    from repro.models.layers import plain_attention
    q, k, v = _normal(Sq * 13 + w + hd, (B, Sq, H, hd), (B, Skv, KV, hd),
                      (B, Skv, KV, hd))
    qt, kt, vt = (_bf16_pair(x)[1] for x in (q, k, v))
    qj, kj, vj = (jnp.asarray(t.float().numpy()) for t in (qt, kt, vt))
    if w:
        exps = [plain_attention(qj, kj, vj, causal=True, sliding_window=w)]
    else:
        exps = [flash_attention_pallas(qj, kj, vj, causal=True,
                                       block_q=B5_KV_TILE,
                                       block_kv=B5_KV_TILE, interpret=True),
                ref.flash_attention_ref(qj, kj, vj)]
    split = _b5_bf16_mirror(qt, kt, vt, True, window=w).numpy()
    single = _b5_bf16_mirror(qt, kt, vt, True, split_p=False, window=w).numpy()
    for exp in exps:
        assert _row_rel(split, exp) <= B5_MIRROR_TOL
        assert _row_rel(single, exp) > B5_MIRROR_TOL


@pytest.mark.parametrize("cap", [1.0, 50.0])
def test_b5_bf16_soft_cap_acts_in_natural_units(cap):
    """B5's bf16 body with a cap against the JAX package's capped blockwise
    attention on the same bf16 values: the cap on s = q.k hd^-1/2, then the
    base-2 factor, within B5_MIRROR_TOL.  The cap on the base-2 score
    instead misses a binding cap of 1.0 by far more than a bf16 kernel's
    tolerance (0.25 of a row's max here) and hides under it at a cap of 50,
    which seldom binds (6e-3): a check at a cap of 50 alone would pass it."""
    from repro.models.attention_flash import flash_attention_xla
    B, Sq, H, KV, hd = 2, 96, 4, 2, 64
    q, k, v = _normal(int(cap) + 21, (B, Sq, H, hd), (B, Sq, KV, hd),
                      (B, Sq, KV, hd))
    qt, kt, vt = (_bf16_pair(x)[1] for x in (q, k, v))
    qj, kj, vj = (jnp.asarray(t.float().numpy()) for t in (qt, kt, vt))
    exp = flash_attention_xla(qj, kj, vj, causal=True, block_q=32,
                              block_kv=32, logit_softcap=cap)
    right = _b5_bf16_mirror(qt, kt, vt, True, softcap=cap).numpy()
    wrong = _b5_bf16_mirror(qt, kt, vt, True, softcap=cap,
                            cap_in_base2=True).numpy()
    assert _row_rel(right, exp) <= B5_MIRROR_TOL
    assert (_row_rel(wrong, exp) > BF16_TOL) == (cap == 1.0)
    assert _row_rel(wrong, exp) > B5_MIRROR_TOL


@pytest.mark.parametrize("cap", [0.5, 50.0])
@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,w", [
    (2, 40, 40, 4, 2, 16, 0),
    (2, 40, 40, 4, 2, 16, 16),          # Hymba's reduced window
    (2, 20, 53, 6, 2, 16, 8),           # Sq < Skv, windowed
    (1, 33, 33, 3, 3, 64, 0),           # one query head per kv head
])
def test_flash_plain_with_a_softcap_matches_the_reference(B, Sq, Skv, H, KV,
                                                          hd, w, cap):
    """B5's plain version with ``logit_softcap`` against the JAX package's
    capped prefill, ``plain_attention`` and ``flash_attention_xla`` at
    blocks of 8, float32 within F32_TOL; with or without a window."""
    from repro.models.attention_flash import flash_attention_xla
    from repro.models.layers import plain_attention
    q, k, v = _normal(Sq * 5 + w, (B, Sq, H, hd), (B, Skv, KV, hd),
                      (B, Skv, KV, hd))
    out = fa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)), True, w,
                                   cap)
    qj, kj, vj = map(jnp.asarray, (q, k, v))
    refs = [flash_attention_xla(qj, kj, vj, causal=True, sliding_window=w,
                                block_q=8, block_kv=8, logit_softcap=cap)]
    if Sq == Skv:
        refs.append(plain_attention(qj, kj, vj, causal=True, sliding_window=w,
                                    logit_softcap=cap))
    for exp in refs:
        np.testing.assert_allclose(out.numpy(), np.asarray(exp), rtol=F32_TOL,
                                   atol=F32_TOL)
    torch.testing.assert_close(
        ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                            sliding_window=w, logit_softcap=cap), out,
        rtol=0, atol=0)


@pytest.mark.parametrize("cap", [0.5, 50.0])
@pytest.mark.parametrize("ring", [False, True])
def test_decode_plain_with_a_softcap_matches_the_reference(ring, cap):
    """B6's plain version with ``logit_softcap`` against the JAX package's
    ``cache_attention``: on a global cache masked by length, and on a ring
    of 16 rows masked as ``attn_apply`` masks it (rows up to the cache
    index, all of them once it wraps), which B6 reads as kv_len = min(index
    + 1, 16) rows as they lie; float32 within F32_TOL."""
    from repro.models.layers import cache_attention
    B, H, KV, hd, S = 2, 6, 2, 32, 16 if ring else 40
    q, ck, cv = _normal(S + int(cap), (B, 1, H, hd), (B, KV, S, hd),
                        (B, KV, S, hd))
    for index in ((5, 15, 23) if ring else (0, 17, 39)):
        if ring:
            exp = cache_attention(jnp.asarray(q), jnp.asarray(ck),
                                  jnp.asarray(cv),
                                  explicit_mask=jnp.arange(S) <= index,
                                  logit_softcap=cap)
            lens = np.full((B,), min(index + 1, S), np.int32)
        else:
            lens = np.full((B,), index + 1, np.int32)
            exp = cache_attention(jnp.asarray(q), jnp.asarray(ck),
                                  jnp.asarray(cv), kv_len=jnp.asarray(lens),
                                  logit_softcap=cap)
        out = ops.decode_attention_kv_major(
            *map(torch.from_numpy, (q, ck, cv, lens)), logit_softcap=cap)
        np.testing.assert_allclose(out.numpy(), np.asarray(exp), rtol=F32_TOL,
                                   atol=F32_TOL)


@pytest.mark.parametrize("cap", [-1.0, float("inf"), float("nan")])
def test_attention_takes_a_finite_nonnegative_softcap(cap):
    """A cap is 0 (none) or a finite c > 0, in the plain versions and (the
    same ``check_softcap``) the CUDA wrappers."""
    t = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="soft-cap"):
        fa.flash_attention_plain(t, t, t, True, 0, cap)
    with pytest.raises(ValueError, match="soft-cap"):
        da.decode_attention_plain(t[:, :1], t.transpose(1, 2),
                                  t.transpose(1, 2),
                                  torch.ones(1, dtype=torch.int32), cap)


def test_a_zero_softcap_is_the_uncapped_call():
    q, k, v = map(torch.from_numpy,
                  _normal(9, (1, 40, 4, 32), (1, 40, 2, 32), (1, 40, 2, 32)))
    torch.testing.assert_close(fa.flash_attention_plain(q, k, v, True, 0, 0.0),
                               fa.flash_attention_plain(q, k, v, True),
                               rtol=0, atol=0)
    lens = torch.tensor([40], dtype=torch.int32)
    ck, cv = k.transpose(1, 2), v.transpose(1, 2)
    torch.testing.assert_close(
        da.decode_attention_plain(q[:, :1], ck, cv, lens, 0.0),
        da.decode_attention_plain(q[:, :1], ck, cv, lens), rtol=0, atol=0)


@pytest.mark.parametrize("hd", fa.SUPPORTED_HEAD_DIMS)
def test_decode_split_plan_covers_the_cache_once(hd):
    """Every S from 0 to past the largest sub-tile, in both dtypes and at
    grids of a few to many (batch row, kv head) pairs: the cluster's ranks,
    dealt sub-tiles r, r + C, ... of T rows, cover rows [0, S) exactly once;
    C is a power of two up to 16, no larger than the sub-tiles, and keeps
    the grid within CTAS_PER_SM an SM unless C is 1; the plan is the same on
    every call (a function of the shapes)."""
    for S in list(range(0, 1100, 7)) + [127, 128, 129, 255, 256, 257, 511,
                                          512, 513, 2048, 2080, 4096]:
        for esize in (2, 4):
            for B, KV in ((1, 1), (2, 1), (4, 8), (4, 24), (8, 32)):
                C, T = da.cluster_plan(B, KV, S, hd, esize)
                assert (C, T) == da.cluster_plan(B, KV, S, hd, esize)
                assert T * hd * esize == da.SUBTILE_BYTES
                n = max(1, -(-S // T))
                assert C in (1, 2, 4, 8, 16) and C <= n
                assert C == 1 or B * KV * C <= da.CTAS_PER_SM * da.SMS
                rows = sorted(r for rank in range(C)
                              for t in range(rank, n, C)
                              for r in range(t * T, min(t * T + T, S)))
                assert rows == list(range(S))
    # the serving shapes: qwen3-1.7b's decode and its half cache, musicgen
    assert da.cluster_plan(4, 8, 2080, 128, 2) == (8, 32)
    assert da.cluster_plan(4, 8, 1040, 128, 2) == (8, 32)
    assert da.cluster_plan(4, 24, 2080, 64, 2) == (4, 64)


class _NoHostRead(torch.Tensor):
    """A kv_len that raises when its values are read on the host."""
    @classmethod
    def __torch_function__(cls, func, types_, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in {"item", "tolist", "cpu", "numpy", "to", "__int__",
                    "__index__", "__bool__", "__getitem__", "__iter__"}:
            raise AssertionError(f"kv_len read on the host through {name}")
        return super().__torch_function__(func, types_, args, kwargs or {})


def test_decode_wrapper_launch_ignores_kv_len_values(monkeypatch):
    """The wrapper's launch (the cluster of each (batch row, kv head), no
    scratch) is a function of the shapes: the same arguments reach the C
    entry point whatever kv_len holds, and kv_len is never read on the
    host, so a decode step can be captured in a CUDA graph.  The C function
    is replaced by a recorder, so this runs on the CPU."""
    calls = []
    monkeypatch.setattr(da._build, "check_operands", lambda *a: None)
    monkeypatch.setattr(da._build, "LAUNCHES", type(da._build.LAUNCHES)())
    monkeypatch.setattr(da._build, "current_stream", lambda device: 0)
    monkeypatch.setattr(da, "_fn", lambda: lambda *a: calls.append(a) or 0)
    B, H, KV, S, hd = 3, 8, 2, 2080, 128
    q, ck, cv = (torch.zeros(s) for s in ((B, 1, H, hd), (B, KV, S, hd),
                                          (B, KV, S, hd)))
    for lens in ((0, 0, 0), (1, 128, 129), (S, S, S), (2048, 7, 0)):
        kv_len = torch.tensor(lens, dtype=torch.int32).as_subclass(_NoHostRead)
        out = da.decode_attention_cuda(q, ck, cv, kv_len)
        assert calls[-1][4] == out.data_ptr() and len(calls[-1]) == 15
    C, _ = da.cluster_plan(B, KV, S, hd, 4)
    shapes = {a[5:12] for a in calls}       # B, S, H, KV, hd, C, dtype
    assert shapes == {(B, S, H, KV, hd, C, 0)} and len(calls) == 4
    assert da._build.LAUNCHES["decode_attention"] == 4


def _b6_split_mirror(q, ck, cv, kv_len, softcap=0.0, return_lse=False):
    """B6's one-launch arithmetic in f32: ``cluster_plan``'s C ranks of a
    (batch row, kv head) take its sub-tiles of T rows round-robin (rank r
    sub-tiles r, r + C, ...), skip those at or past kv_len and keep a
    running (m, l, acc), rescaled once a sub-tile (m = -1e30, l = 0,
    acc = 0 on a rank with no live row; the scores capped at ``softcap``
    first); then the combine over the ranks in rank order.  q (B, 1, H, hd),
    ck, cv (B, KV, S, hd), kv_len (B,) -> (B, 1, H, hd) f32, and with
    ``return_lse`` also (B, H) lse = m* + log l (-inf where kv_len is 0)."""
    B, _, H, hd = q.shape
    KV, S = ck.shape[1], ck.shape[2]
    G = H // KV
    C, T = da.cluster_plan(B, KV, S, hd, 4)
    qs = q.reshape(B, KV, G, hd) * np.float32(1 / math.sqrt(hd))
    m = np.full((C, B, KV, G), -1e30, np.float32)
    l = np.zeros_like(m)
    acc = np.zeros((C, B, KV, G, hd), np.float32)
    for b in range(B):
        live = min(max(int(kv_len[b]), 0), S)
        for r in range(C):
            for t in range(r, -(-live // T), C):
                lo, hi = t * T, min(t * T + T, live)
                s = qs[b] @ ck[b, :, lo:hi].transpose(0, 2, 1)  # (KV, G, rows)
                if softcap:
                    s = np.tanh(s / np.float32(softcap)) * np.float32(softcap)
                mn = np.maximum(m[r, b], s.max(-1))
                alpha = np.exp(m[r, b] - mn)
                p = np.exp(s - mn[..., None])
                l[r, b] = l[r, b] * alpha + p.sum(-1)
                acc[r, b] = acc[r, b] * alpha[..., None] + p @ cv[b, :, lo:hi]
                m[r, b] = mn
    m_star = m.max(0)
    lt = np.zeros_like(m_star)
    at = np.zeros_like(acc[0])
    for r in range(C):
        w = np.exp(m[r] - m_star)
        lt += l[r] * w
        at += acc[r] * w[..., None]
    out = (at / np.maximum(lt, 1e-30)[..., None]).reshape(B, 1, H, hd)
    if not return_lse:
        return out.astype(np.float32)
    with np.errstate(divide="ignore"):
        lse = np.where(lt > 0, m_star + np.log(lt), -np.inf)
    return out.astype(np.float32), lse.reshape(B, H).astype(np.float32)


def _b6_edges(S, hd):
    """kv_len at 0, 1, T - 1, T, T + 1, one row into the cache's last
    sub-tile (the last of some rank's) and the full cache."""
    _, T = da.cluster_plan(1, 1, S, hd, 4)
    return [0, 1, T - 1, T, T + 1, (-(-S // T) - 1) * T + 1, S]


@pytest.mark.parametrize("S,H,KV,hd", [
    (300, 8, 2, 128),           # f32 sub-tiles of 16 rows, G = 4
    (600, 4, 4, 64),            # sub-tiles of 32, one query head per kv head
    (1100, 12, 1, 32),          # sub-tiles of 64, twelve query heads
    (700, 12, 2, 64),           # G = 6, InternVL's
    (600, 16, 1, 32),           # G = 16, the most the kernel takes
])
def test_b6_split_kv_numerics_match_the_reference(S, H, KV, hd):
    """B6's cluster arithmetic against the TPU kernel in interpret mode, at
    kv_len 0, 1, T - 1, T, T + 1, one row into the last sub-tile and the
    full cache, on a cluster of several ranks each taking more than one
    sub-tile."""
    lens = np.asarray(_b6_edges(S, hd), np.int32)
    B = len(lens)
    C, T = da.cluster_plan(B, KV, S, hd, 4)
    assert C >= 4 and -(-S // T) > C
    q, ck, cv = _normal(S + hd, (B, 1, H, hd), (B, KV, S, hd), (B, KV, S, hd))
    out = _b6_split_mirror(q, ck, cv, lens)
    kern = decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(ck.transpose(0, 2, 1, 3)),
        jnp.asarray(cv.transpose(0, 2, 1, 3)), jnp.asarray(lens), block_kv=256,
        interpret=True)
    np.testing.assert_allclose(out, np.asarray(kern), rtol=F32_TOL, atol=F32_TOL)
    assert not out[0].any()


@pytest.mark.parametrize("cap", [0.5, 50.0])
def test_b6_split_kv_numerics_with_a_softcap_match_the_reference(cap):
    """The scores capped before the running max, the combine unchanged,
    against the JAX package's capped ``cache_attention`` at kv_len 1, one
    sub-tile + 1 and the full cache."""
    from repro.models.layers import cache_attention
    S, H, KV, hd = 600, 4, 4, 64
    _, T = da.cluster_plan(3, KV, S, hd, 4)
    lens = np.asarray([1, T + 1, S], np.int32)
    q, ck, cv = _normal(S + 3, (3, 1, H, hd), (3, KV, S, hd), (3, KV, S, hd))
    out = _b6_split_mirror(q, ck, cv, lens, softcap=cap)
    exp = cache_attention(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                          kv_len=jnp.asarray(lens), logit_softcap=cap)
    np.testing.assert_allclose(out, np.asarray(exp), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("cap", [0.0, 1.0])
def test_b6_split_kv_partial_mode_matches_the_plain_lse(cap):
    """The partial mode's arithmetic: the mirror's f32 out and lse against
    ``decode_attention_plain(..., return_lse=True)`` at the edges of the
    sub-tiles, -inf and zeros where kv_len is 0."""
    S, H, KV, hd = 520, 8, 2, 64
    lens = np.asarray(_b6_edges(S, hd), np.int32)
    B = len(lens)
    q, ck, cv = _normal(S + 5, (B, 1, H, hd), (B, KV, S, hd), (B, KV, S, hd))
    out, lse = _b6_split_mirror(q, ck, cv, lens, softcap=cap, return_lse=True)
    ref, ref_lse = da.decode_attention_plain(
        *map(torch.from_numpy, (q, ck, cv, lens)), cap, True)
    np.testing.assert_allclose(out, ref.numpy(), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(lse[1:], ref_lse.numpy()[1:], rtol=F32_TOL,
                               atol=F32_TOL)
    assert np.isneginf(lse[0]).all() and np.isneginf(ref_lse[0].numpy()).all()
    assert not out[0].any()
