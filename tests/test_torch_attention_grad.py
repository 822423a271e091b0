"""B5's gradient on the CPU against the JAX package's.

The JAX package trains through XLA's autodiff of ``plain_attention`` (below
``attn_block_q``) and of the blockwise ``flash_attention_xla`` (above it);
the port runs B5's own backward, ``flash_attention_bwd_plain`` on the CPU
and the CUDA kernels that ``chip_smoke.py`` holds to it on the card.  Here
the plain backward, and autograd through ``FlashAttentionFn`` (the path a
training step takes), are held to ``jax.grad`` of both JAX functions on the
same numpy inputs and the same random output gradient, in float32.

Tolerance: GRAD_TOL of each gradient's max |x| (of dv's where a gradient
is 0 analytically, at w = 1).  Both sides are float32 with
sums in other orders (the JAX side differentiates a softmax, the port
recomputes P from the log-sum-exp), which reaches a few 1e-7 of the max.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention_flash import flash_attention_xla
from repro.models.layers import plain_attention
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

GRAD_TOL = 1e-5


def _inputs(seed, B, S, H, KV, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    g = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    return q, k, v, g


def _jax_grads(fn, q, k, v, g):
    def f(q, k, v):
        return jnp.sum(fn(q, k, v) * g)
    return [np.asarray(x) for x in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _close(got, want, what):
    for name, a, b in zip("qkv", got, want):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        # with w = 1 each row's P is 1 and dS = dP - D cancels to 0: dq and dk
        # are then held to dv's max, the size of the terms that cancel
        scale = float(np.abs(b).max()) or float(np.abs(want[2]).max())
        err = float(np.abs(a - b).max())
        assert err <= GRAD_TOL * scale, f"{what} d{name}: {err} of max {scale}"


CASES = [
    # B, S, H, KV, hd, window, cap
    (2, 64, 4, 2, 16, 0, 0.0),          # GQA 4 over 2
    (1, 96, 15, 5, 64, 0, 0.0),         # smollm's 15 over 5
    (2, 80, 4, 2, 128, 0, 0.0),         # wide head, ragged length
    (2, 70, 4, 4, 64, 0, 0.0),          # G = 1, ragged
    (2, 96, 4, 2, 16, 1, 0.0),          # w = 1: each row its own key
    (2, 100, 4, 2, 64, 24, 0.0),        # w < S
    (1, 64, 4, 2, 64, 200, 0.0),        # w >= S
    (2, 72, 4, 2, 64, 0, 1.0),          # a binding cap
    (2, 72, 4, 2, 64, 0, 50.0),         # Gemma 2's cap
    (2, 100, 6, 2, 32, 24, 1.0),        # window and cap
]


@pytest.mark.parametrize("B,S,H,KV,hd,w,cap", CASES)
def test_plain_backward_matches_jax_grad(B, S, H, KV, hd, w, cap):
    q, k, v, g = _inputs(S * 3 + hd + int(cap), B, S, H, KV, hd)
    want = _jax_grads(lambda q, k, v: plain_attention(
        q, k, v, causal=True, sliding_window=w, logit_softcap=cap), q, k, v, g)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    out, lse = fa.flash_attention_plain(tq, tk, tv, True, w, cap, with_lse=True)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, out, lse, tg, True, w, cap)
    _close(got, want, "plain backward vs plain_attention")


@pytest.mark.parametrize("B,S,H,KV,hd,w,cap", CASES)
def test_autograd_through_b5_matches_blockwise_xla(B, S, H, KV, hd, w, cap):
    """``ops.flash_attention`` on tensors that require grad goes through
    ``FlashAttentionFn``; its gradients against XLA's autodiff of the
    blockwise path the JAX package trains with above ``attn_block_q``
    (blocks of 32, so ragged tiles and band skipping run)."""
    q, k, v, g = _inputs(S * 5 + hd + int(cap), B, S, H, KV, hd)
    want = _jax_grads(lambda q, k, v: flash_attention_xla(
        q, k, v, causal=True, sliding_window=w, block_q=32, block_kv=32,
        logit_softcap=cap), q, k, v, g)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, sliding_window=w, logit_softcap=cap)
    assert out.grad_fn is not None and "FlashAttentionFn" in type(out.grad_fn).__name__
    (out * torch.from_numpy(g)).sum().backward()
    _close((tq.grad, tk.grad, tv.grad), want, "autograd vs flash_attention_xla")


@pytest.mark.parametrize("w,cap", [(0, 0.0), (24, 0.0), (0, 1.0)])
def test_lse_is_the_logsumexp_of_the_plain_logits(w, cap):
    q, k, v, _ = _inputs(7, 2, 100, 6, 2, 32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = fa.flash_attention_plain(tq, tk, tv, True, w, cap, with_lse=True)
    assert torch.equal(out, fa.flash_attention_plain(tq, tk, tv, True, w, cap))
    logits = torch.einsum("bqhd,bkhd->bhqk", tq.double(),
                          tk.double().repeat_interleave(3, dim=2)) / 32 ** 0.5
    if cap:
        logits = torch.tanh(logits / cap) * cap
    logits = logits.masked_fill(fa.dead_pairs(100, 100, w, "cpu"), -1e30)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(logits, -1).numpy(),
                               rtol=1e-6, atol=1e-5)


def test_backward_takes_square_attention_only():
    q = torch.zeros((1, 8, 2, 16))
    k = torch.zeros((1, 12, 2, 16))
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="Sq = Skv"):
        fa.flash_attention_bwd_plain(q, k, k, q, lse, q)


def test_serving_takes_no_autograd_path():
    """Under no_grad, or on operands that need no grad, ``ops`` calls the
    forward alone (no log-sum-exp, no saved tensors)."""
    q, k, v, _ = _inputs(3, 1, 32, 4, 2, 16)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    with torch.no_grad():
        assert ops.flash_attention(tq, tk, tv).grad_fn is None
    plain = [torch.from_numpy(x) for x in (q, k, v)]
    assert ops.flash_attention(*plain).grad_fn is None
    assert torch.equal(ops.flash_attention(*plain),
                       ops.flash_attention(tq, tk, tv).detach())
