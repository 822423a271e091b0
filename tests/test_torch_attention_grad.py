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


# B5's backward in bf16 runs its products as wgmma on the tensor cores
# (csrc/flash_attention_bwd.cu: flash_attention_bwd_dkdv_wgmma_kernel and
# flash_attention_bwd_dq_wgmma_kernel): bf16 q, k, v and dO enter the
# products exactly, every sum is f32, and the two f32 operands the kernels
# build in registers, P (for dV = P^T dO) and dS (for dK = dS^T Q and dQ =
# dS K), are each rounded to bf16 once.  chip_smoke.py's BF16_TOL, per
# (batch row, head) slice's max |x|.
BF16_TOL = 1e-2


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _tc_backward_model(q, k, v, o, lse, dout, w, cap):
    """The bf16 body's arithmetic in plain torch (f32 tensors holding bf16
    values), as flash_attention_bwd_dkdv_wgmma_kernel and
    flash_attention_bwd_dq_wgmma_kernel round: P = exp(s - LSE) in f32; dV
    = bf16(P)^T dO; dP = dO V^T; dS = P (dP - D) (times 1 - t^2 under a
    cap) in f32; dK = bf16(dS)^T Q and dQ = bf16(dS) K, times hd^-1/2; each
    output rounded to bf16."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qg = q.reshape(B, S, KV, G, hd)
    dog = dout.reshape(B, S, KV, G, hd)
    s = torch.einsum("bqngd,bknd->bngqk", qg, k) * scale
    if cap:
        t = torch.tanh(s / cap)
        s = t * cap
    p = torch.exp(s - lse.reshape(B, KV, G, S, 1))
    p = p.masked_fill(fa.dead_pairs(S, S, w, "cpu"), 0.0)
    delta = (dout * o).sum(-1).reshape(B, S, KV, G).permute(0, 2, 3, 1)
    dv = torch.einsum("bngqk,bqngd->bknd", _bf16(p), dog)
    ds = p * (torch.einsum("bqngd,bknd->bngqk", dog, v) - delta[..., None])
    if cap:
        ds = ds * (1.0 - t * t)
    ds = _bf16(ds)
    dq = torch.einsum("bngqk,bknd->bqngd", ds, k).reshape(B, S, H, hd) * scale
    dk = torch.einsum("bngqk,bqngd->bknd", ds, qg) * scale
    return _bf16(dq), _bf16(dk), _bf16(dv)


def _worst_slice(got, want, fallback: float) -> float:
    """The worst (batch row, head) slice of |got - want|, relative to that
    slice's max |want| (or ``fallback`` where the slice is 0 analytically:
    with w = 1, dS cancels exactly)."""
    d = np.abs(got - want).max(axis=(1, 3))
    top = np.abs(want).max(axis=(1, 3))
    return float((d / np.where(top > 0, top, fallback)).max())


@pytest.mark.parametrize("B,S,H,KV,hd,w,cap", CASES)
def test_bf16_tensor_core_rounding_matches_jax_grad(B, S, H, KV, hd, w, cap):
    """The rounding model of the bf16 body (P and dS rounded to bf16 once,
    f32 sums, bf16 outputs) against ``jax.grad`` of ``plain_attention`` in
    f32 on the same bf16 values: dq, dk and dv within BF16_TOL of each
    (batch row, head) slice's max, with D from the forward's output rounded
    to bf16, as training hands it to the kernels, and with D from the f32
    output, which leaves the kernels' own roundings alone.  The bf16 output
    moves D for every backward, this one or the f32 body: it is most of dq's
    error (0.0099 of the slice max at smollm's heads, 0.0048 without it)."""
    q, k, v, g = (_bf16(torch.from_numpy(x)).numpy()
                  for x in _inputs(S * 7 + hd + int(cap), B, S, H, KV, hd))
    want = _jax_grads(lambda q, k, v: plain_attention(
        q, k, v, causal=True, sliding_window=w, logit_softcap=cap), q, k, v, g)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    out, lse = fa.flash_attention_plain(tq, tk, tv, True, w, cap, with_lse=True)
    fallback = float(np.abs(want[2]).max())
    for o_kind, o in (("bf16", _bf16(out)), ("f32", out)):
        got = _tc_backward_model(tq, tk, tv, o, lse, tg, w, cap)
        errs = [_worst_slice(a.numpy(), b, fallback) for a, b in zip(got, want)]
        print(f"bf16 rounding model, case {(B, S, H, KV, hd, w, cap)}, {o_kind} "
              f"forward output: worst slice dq {errs[0]:.3g}, dk {errs[1]:.3g}, "
              f"dv {errs[2]:.3g} (tol {BF16_TOL})")
        assert max(errs) <= BF16_TOL, (o_kind, errs)
