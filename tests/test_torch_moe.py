"""The port's MoE FFN and MLA attention against the JAX package, on the CPU.

``repro_torch.models.layers.moe_apply`` and ``mla_apply`` run on the JAX
package's weights (one layer of ``T.init(cfg, PRNGKey)`` carried across by
``bridge.lm_params_from_numpy``) and the same numpy inputs as
``repro.models.layers``.  Routing is integer work and must be equal: the
top-k experts against ``jax.lax.top_k``'s (captured while the JAX layer
runs), and the keep mask and buffer slots against a numpy oracle of the
cumsum-position dispatch on those experts.  Float outputs at float32 are
within LM_TOL (2e-5) of the input's max |x| (sums in other orders; the gap
seen is under 2e-7), the load-balance term within 1e-6.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jget_reduced
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.configs import get_reduced_config
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves

MOE = ("granite-moe-3b-a800m", "deepseek-v2-lite-16b")
LM_TOL = 2e-5
AUX_TOL = 1e-6
# bf16 against the float32 layer on the same bf16 values: the port rounds
# four times on the way (h, each expert's output, the gate-weighted rows,
# their sum over k), each by up to 2^-9 of the value, about 2^-7 of an
# output element in all; the gap seen is 7.2e-3 of the max |y| (4 inputs
# per arch).  The repo's bf16 tolerance, 2e-2, leaves room for that.
BF16_TOL = 2e-2
CPU = torch.device("cpu")


def _rel(port, ref, scale):
    port = port.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape
    return float(np.abs(port - ref).max()) / scale


def _layer(arch, dtype, run=-1):
    """(JAX config, port config, one layer's params of run ``run``: JAX tree
    as numpy, port tree)."""
    jcfg = jget_reduced(arch).replace(dtype=dtype)
    tcfg = get_reduced_config(arch).replace(dtype=dtype)
    jp = jax.tree.map(np.asarray, JT.init(jcfg, jax.random.PRNGKey(11)))
    layer = jax.tree.map(lambda a: a[0], jp["runs"][run])
    return jcfg, tcfg, layer, lm_params_from_numpy(layer, CPU)


def _input(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    j = jnp.asarray(x, getattr(jnp, dtype))
    if dtype == "bfloat16":
        t = torch.from_numpy(np.asarray(j).view(np.uint16).copy()).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(x)
    return j, t


def _dispatch_oracle(idx, E, cap):
    """keep and slot of the cumsum-position dispatch, by a loop: per batch
    row, an assignment's position is how many earlier assignments (token-
    major over the S k of the row) chose its expert."""
    B, S, k = idx.shape
    keep = np.zeros((B, S, k), bool)
    slot = np.zeros((B, S, k), np.int64)
    for b in range(B):
        count = [0] * E
        for s in range(S):
            for j in range(k):
                e = int(idx[b, s, j])
                keep[b, s, j] = count[e] < cap
                slot[b, s, j] = e * cap + count[e] if keep[b, s, j] else E * cap
                count[e] += 1
    return keep, slot


def _run_moe(monkeypatch, jcfg, tcfg, jparams, tparams, xj, xt):
    """Both layers on the same input, the JAX one jitted (XLA:CPU runs a
    bf16 batched product with a float32 result only compiled): ((y, aux)
    JAX, (y, aux) port, JAX's top-k experts, the port's recorded
    routing)."""
    seen = []
    top_k = jax.lax.top_k

    def spy(operand, k):
        vals, idx = top_k(operand, k)
        jax.debug.callback(lambda i: seen.append(np.asarray(i)), idx)
        return vals, idx

    monkeypatch.setattr(jax.lax, "top_k", spy)
    jy, jaux = jax.jit(lambda p, x: JL.moe_apply(jcfg, p, x))(
        jax.tree.map(jnp.asarray, jparams), xj)
    jax.block_until_ready((jy, jaux))
    monkeypatch.setattr(jax.lax, "top_k", top_k)
    with torch.no_grad(), L.record_routing() as rec:
        ty, taux = L.moe_apply(tcfg, tparams, xt)
    assert len(seen) == 1 and len(rec) == 1
    return (jy, jaux), (ty, taux), seen[0], rec[0]


def _check_routing(jidx, routing, cfg, S):
    cap = L.moe_capacity(cfg, S)
    np.testing.assert_array_equal(routing["idx"].numpy(), jidx)
    keep, slot = _dispatch_oracle(jidx, cfg.n_experts, cap)
    np.testing.assert_array_equal(routing["keep"].numpy(), keep)
    np.testing.assert_array_equal(routing["slot"].numpy(), slot)
    return keep


@pytest.mark.parametrize("case", ["prefill", "drops", "decode", "ties"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_apply_matches_the_reference(arch, case, monkeypatch):
    """float32: the default capacity (1.25) on 2 x 24 tokens; a capacity
    factor of 0.5 that drops assignments; one token (a decode step, capacity
    1, nothing dropped); a zero router, whose uniform probabilities put
    every token on experts 0..k-1 (ties go to the lowest index, as with
    ``lax.top_k``), beyond their capacity."""
    jcfg, tcfg, jp, tp = _layer(arch, "float32")
    if case == "drops":
        jcfg, tcfg = (c.replace(moe_capacity_factor=0.5) for c in (jcfg, tcfg))
    if case == "ties":
        jp["ffn"]["router"] = np.zeros_like(jp["ffn"]["router"])
        tp["ffn"]["router"] = torch.zeros_like(tp["ffn"]["router"])
    S = 1 if case == "decode" else 24
    xj, xt = _input((2, S, jcfg.d_model), "float32", seed=len(case))
    (jy, jaux), (ty, taux), jidx, routing = _run_moe(
        monkeypatch, jcfg, tcfg, jp["ffn"], tp["ffn"], xj, xt)
    keep = _check_routing(jidx, routing, tcfg, S)
    if case in ("drops", "ties"):
        assert not keep.all()
    if case == "decode":
        assert keep.all()
    if case == "ties":
        np.testing.assert_array_equal(
            jidx, np.broadcast_to(np.arange(tcfg.moe_top_k), jidx.shape))
    assert _rel(ty, jy, float(np.abs(np.asarray(xj)).max())) <= LM_TOL
    assert taux.dtype == torch.float32
    assert abs(float(taux) - float(jaux)) <= AUX_TOL


@pytest.mark.parametrize("arch", MOE)
def test_moe_apply_bf16_matches_the_reference(arch, monkeypatch):
    """bf16 weights and input, the router float32.  XLA:CPU has no bf16
    batched product with a float32 result, so the JAX package's layer cannot
    run in bf16 here: the reference is its float32 layer on the same bf16
    values.  Routing sees the same float32 logits on both sides and must be
    equal; y within BF16_TOL of its max |y|."""
    jcfg, tcfg, jp, tp = _layer(arch, "bfloat16")
    assert tp["ffn"]["router"].dtype == torch.float32
    assert tp["ffn"]["w_gate"].dtype == torch.bfloat16
    xj, xt = _input((2, 24, jcfg.d_model), "bfloat16", seed=5)
    up = lambda a: np.asarray(a, np.float32)            # noqa: E731
    (jy, jaux), (ty, taux), jidx, routing = _run_moe(
        monkeypatch, jcfg.replace(dtype="float32"), tcfg,
        jax.tree.map(up, jp["ffn"]), tp["ffn"], up(xj), xt)
    _check_routing(jidx, routing, tcfg, 24)
    assert ty.dtype == torch.bfloat16
    assert _rel(ty, jy, float(np.abs(np.asarray(jy)).max())) <= BF16_TOL
    assert abs(float(taux) - float(jaux)) <= AUX_TOL


def test_moe_capacity_matches_the_reference_formula():
    """``int(S k / E cf + 0.5)`` within [1, S], as ``moe_apply`` there."""
    cfg = get_reduced_config("granite-moe-3b-a800m")
    for S, cf in ((1, 1.25), (12, 1.25), (24, 0.5), (9, 16.0), (2048, 1.25)):
        c = cfg.replace(moe_capacity_factor=cf)
        want = max(min(int(S * c.moe_top_k / c.n_experts * cf + 0.5), S), 1)
        assert L.moe_capacity(c, S) == want


@pytest.mark.parametrize("block_q", [1024, 8])
def test_mla_prefill_matches_the_reference(block_q):
    """Prefill of 2 x 24 tokens: the output and the (latent, k_rope) cache
    rows.  At ``attn_block_q`` 1024 the JAX package takes
    ``plain_attention``, at 8 its blockwise ``flash_attention_xla``; the
    port's one plain softmax matches both."""
    jcfg, tcfg, jp, tp = _layer("deepseek-v2-lite-16b", "float32", run=0)
    jcfg = jcfg.replace(attn_block_q=block_q, attn_block_kv=block_q)
    xj, xt = _input((2, 24, jcfg.d_model), "float32", seed=3)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24))
    jy, jc = JL.mla_apply(jcfg, jax.tree.map(jnp.asarray, jp["attn"]), xj,
                          jnp.asarray(pos))
    with torch.no_grad():
        ty, tc = L.mla_apply(tcfg, tp["attn"], xt, torch.from_numpy(pos.copy()))
    scale = float(np.abs(np.asarray(xj)).max())
    assert _rel(ty, jy, scale) <= LM_TOL
    for name in ("latent", "k_rope"):
        assert tc[name].shape == jc[name].shape
        assert _rel(tc[name], jc[name], scale) <= LM_TOL


@pytest.mark.parametrize("steps", [1, 3])
def test_mla_decode_into_a_cache_matches_the_reference(steps):
    """The absorbed decode: a 10-token prompt written into a 16-row cache,
    then ``steps`` one-token steps at cache_index 10.. into it (the port in
    place, the JAX package by ``dynamic_update_slice``): outputs and every
    cache row within LM_TOL."""
    jcfg, tcfg, jp, tp = _layer("deepseek-v2-lite-16b", "float32", run=1)
    ja, ta = jax.tree.map(jnp.asarray, jp["attn"]), tp["attn"]
    xj, xt = _input((2, 10 + steps, jcfg.d_model), "float32", seed=4)
    pos = np.broadcast_to(np.arange(10 + steps, dtype=np.int32),
                          (2, 10 + steps)).copy()
    _, jrows = JL.mla_apply(jcfg, ja, xj[:, :10], jnp.asarray(pos[:, :10]))
    jcache = {n: jnp.zeros((2, 16, a.shape[-1]), jnp.float32).at[:, :10].set(a)
              for n, a in jrows.items()}
    tcache = T.block_cache_init(tcfg, T.LayerKind(attn="mla", ffn="moe"), 2,
                                16, CPU)["attn"]
    with torch.no_grad():
        _, trows = L.mla_apply(tcfg, ta, xt[:, :10],
                               torch.from_numpy(pos[:, :10]))
        for n in tcache:
            tcache[n][:, :10] = trows[n]
    scale = float(np.abs(np.asarray(xj)).max())
    for i in range(10, 10 + steps):
        jy, jcache = JL.mla_apply(jcfg, ja, xj[:, i:i + 1],
                                  jnp.asarray(pos[:, i:i + 1]), cache=jcache,
                                  cache_index=jnp.asarray(i, jnp.int32))
        with torch.no_grad():
            ty, got = L.mla_apply(tcfg, ta, xt[:, i:i + 1],
                                  torch.from_numpy(pos[:, i:i + 1]),
                                  cache=tcache, cache_index=i)
        assert got is tcache
        assert _rel(ty, jy, scale) <= LM_TOL
        for n in tcache:
            assert _rel(tcache[n], jcache[n], scale) <= LM_TOL
    assert not tcache["latent"][:, 10 + steps:].any()


def test_mla_prefill_attention_is_causal_with_the_reference_scale():
    """q and k at head dim 24 against v at 16: each row's softmax over the
    keys at or before it, scaled by 1/sqrt(24), checked row by row."""
    g = torch.Generator().manual_seed(0)
    q, k = (torch.randn((1, 5, 2, 24), generator=g) for _ in range(2))
    v = torch.randn((1, 5, 2, 16), generator=g)
    out = L.mla_prefill_attention(q, k, v)
    for i in range(5):
        w = torch.softmax(torch.einsum("hd,khd->hk", q[0, i], k[0, :i + 1])
                          / math.sqrt(24), dim=-1)
        torch.testing.assert_close(out[0, i],
                                   torch.einsum("hk,khd->hd", w, v[0, :i + 1]),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", MOE)
def test_port_init_has_the_reference_tree(arch):
    """The port's own ``init`` in bf16: the JAX package's tree, leaf for
    leaf in shape and dtype, the router float32, the leading dense layer of
    deepseek its own run."""
    jcfg = jget_reduced(arch).replace(dtype="bfloat16")
    tcfg = get_reduced_config(arch).replace(dtype="bfloat16")
    shapes = jax.eval_shape(lambda: JT.init(jcfg, jax.random.PRNGKey(0)))
    tp = T.init(tcfg, torch.Generator().manual_seed(0), CPU)
    jleaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    tleaves = tree_leaves(tp)
    assert len(jleaves) == len(tleaves)
    for (path, a), b in zip(jleaves, tleaves):
        assert tuple(b.shape) == a.shape, path
        assert str(b.dtype).removeprefix("torch.") == str(a.dtype), path
    kinds = [kind.ffn for kind, _ in T.layer_runs(tcfg)]
    assert kinds == (["dense", "moe"] if tcfg.first_dense_layers else ["moe"])
    assert all(r["ffn"]["router"].dtype == torch.float32
               for r in tp["runs"] if "router" in r["ffn"])
