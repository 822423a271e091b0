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
"""
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
