"""The port's LM serving path against the JAX package, on the CPU.

Reduced configs of the four dense archs, the two MoE archs (granite:
GQA and 40 capacity-routed experts; deepseek: MLA, a leading dense layer,
routed and shared experts), xLSTM (mLSTM and sLSTM blocks) and Hymba
(attention and mamba heads in parallel, a sliding window of 16 on its
middle layer and the ring-buffer decode cache) run with the JAX package's weights
(``T.init(cfg, PRNGKey)`` carried across by ``bridge.lm_params_from_numpy``)
and the same numpy token ids on both sides: prefill logits and caches,
three greedy decode steps, and the split (head, int8 codec, tail) at every
default candidate.  The reduced configs are float32; logits and caches must
agree within LM_TOL of their max |x| (float32 with sums in other orders: the
largest gap seen is about 3e-6).  Then the port's own prefill -> decode
consistency (on a drop-free copy of a MoE config: capacity dropping depends
on the sequence length), bf16, the serving driver on the CPU with and
without ``--split`` and the accounting of ``LMSplitPlan`` (the frontend
archs too).  The frontends and logit soft-capping have their own file,
``tests/test_torch_frontends.py``.
"""
import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_config as jget_config
from repro.configs import get_reduced_config as jget_reduced
from repro.core import compression as jcomp
from repro.core import splitting as jsplit
from repro.launch import serve as jserve
from repro.models import transformer as JT
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.configs.base import InputShape, count_active_params, count_params
from repro_torch.core.compression import ActivationCodec
from repro_torch.core.splitting import (SERVER_ONLY, UE_ONLY, LMSplitPlan,
                                        Workload, default_candidates,
                                        split_option)
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_model
from repro_torch.tree import tree_flatten, tree_leaves, tree_map

DENSE = ("qwen3-1.7b", "qwen3-4b", "smollm-360m", "starcoder2-15b")
MOE = ("granite-moe-3b-a800m", "deepseek-v2-lite-16b")
RECURRENT = ("xlstm-350m", "hymba-1.5b")
FRONTENDS = ("musicgen-medium", "internvl2-26b")
LM_TOL = 2e-5
CPU = torch.device("cpu")


def _close(port, ref, tol=LM_TOL):
    port = port.detach().float().numpy() if torch.is_tensor(port) else port
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= tol, err


@pytest.fixture(scope="module", params=DENSE + MOE + RECURRENT)
def lm(request):
    """(arch, JAX config, port config, JAX params, port params)."""
    arch = request.param
    jcfg, tcfg = jget_reduced(arch), get_reduced_config(arch)
    jp = jax.tree.map(np.asarray, JT.init(jcfg, jax.random.PRNGKey(7)))
    return arch, jcfg, tcfg, jp, lm_params_from_numpy(jp, CPU)


def _drop_free(cfg):
    """A MoE config whose capacity holds every assignment at any length
    (as ``tests/test_models_smoke.py`` takes it); others as they are."""
    return cfg.replace(moe_capacity_factor=16.0) if cfg.n_experts else cfg


def _close_caches(port, ref):
    """Every leaf of every run's cache: GQA's KV-major (layers, B, KV,
    max_len, hd) k and v (a windowed layer's ring of w rows), MLA's
    (layers, B, max_len, r) latent and rope key, the recurrent states."""
    assert len(port) == len(ref)
    for tc, jc in zip(port, ref):
        leaves, treedef = tree_flatten(tc)
        jleaves, jdef = jax.tree.flatten(jc)
        assert treedef.num_leaves == jdef.num_leaves
        for a, b in zip(leaves, jleaves):
            _close(a, b)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (B, S)).astype(np.int32)


def test_prefill_and_decode_match_the_reference(lm):
    _, jcfg, tcfg, jp, tp = lm
    toks = _tokens(jcfg, 2, 12)
    jl, jc = jax.jit(lambda p, b: JT.prefill(jcfg, p, b, 16))(
        jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, tc = T.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)}, 16)
    _close(tl, jl)
    _close_caches(tc, jc)
    step = jax.jit(lambda p, c, b, i: JT.decode_step(jcfg, p, c, b, i))
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for i in range(3):
        jl, jc = step(jp, jc, {"tokens": jnp.asarray(tok)},
                      jnp.asarray(12 + i, jnp.int32))
        with torch.no_grad():
            tl, tc = T.decode_step(tcfg, tp, tc, {"tokens": torch.from_numpy(tok)},
                                   12 + i)
        _close(tl, jl)
        _close_caches(tc, jc)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


def test_split_head_codec_tail_match_the_reference(lm):
    _, jcfg, tcfg, jp, tp = lm
    toks = _tokens(jcfg, 2, 10, seed=1)
    assert default_candidates(tcfg) == jsplit.default_candidates(jcfg)
    jplan = jsplit.LMSplitPlan(jcfg, jp, workload=jsplit.Workload(n_tokens=10))
    tplan = LMSplitPlan(tcfg, tp, workload=Workload(n_tokens=10), device=CPU)
    assert tplan.options == jplan.options
    jcodec, tcodec = jcomp.ActivationCodec(), ActivationCodec(device=CPU)
    batch_j, batch_t = {"tokens": jnp.asarray(toks)}, {"tokens": toks}
    with torch.no_grad():
        _close(tplan.head(batch_t, UE_ONLY)[1], jplan.head(batch_j, UE_ONLY)[1])
        _close(tplan.tail(batch_t, SERVER_ONLY), jplan.tail(batch_j, SERVER_ONLY))
        for l in tplan.candidates:
            opt = split_option(l)
            jpay, _ = jplan.head(batch_j, opt)
            tpay, _ = tplan.head(batch_t, opt)
            _close(tpay["h"], jpay["h"])
            h, _, _ = T.forward_slice(tcfg, tp, T.embed_inputs(
                tcfg, tp, {"tokens": torch.from_numpy(toks)}),
                T.positions_for(torch.zeros(2, 10)), 0, l)
            torch.testing.assert_close(h, tpay["h"], rtol=0, atol=0)
            # the JAX payload decoded by the port is the JAX decode, bitwise;
            # the tail on it matches the JAX tail
            jcomp_p = jcodec.compress(jpay)
            tdec = tcodec.decompress(jcomp_p)
            np.testing.assert_array_equal(
                tdec["h"].numpy(), np.asarray(jcodec.decompress(jcomp_p)["h"]))
            _close(tplan.tail(tdec, opt),
                   jplan.tail(jcodec.decompress(jcomp_p), opt))
            # the port end to end through its own codec
            tcomp = tcodec.compress(tpay)
            assert tcomp.raw_bytes == tplan.raw_payload_bytes(opt, batch=2)
            out = tplan.tail(tcodec.decompress(tcomp), opt)
            assert out.shape == (2, 1, tcfg.vocab_size)
            assert torch.isfinite(out).all()


def test_port_prefill_decode_consistency(lm):
    """Prefill to S-1 plus one decode step gives the logits of a prefill to
    S (float32: the two paths differ by sum order only; MLA's absorbed
    decode against its materialised prefill by rounding only)."""
    _, _, tcfg, _, tp = lm
    model = get_model(_drop_free(tcfg), CPU)
    toks = torch.from_numpy(_tokens(tcfg, 2, 12, seed=2))
    with torch.no_grad():
        full, _ = model.prefill(tp, {"tokens": toks}, 12)
        _, caches = model.prefill(tp, {"tokens": toks[:, :-1]}, 12)
        dec, caches = model.decode_step(tp, caches, {"tokens": toks[:, -1:]}, 11)
    _close(dec, full.numpy())
    for c in caches:                  # the decoded token's row was written
        if "attn" in c:
            rows = c["attn"]["latent"] if "latent" in c["attn"] else \
                c["attn"]["k"].transpose(2, 3)
            assert rows[:, :, 11].abs().sum() > 0


@pytest.mark.parametrize("arch", DENSE)
def test_lm_bridge_keeps_layout_and_bf16_bits(arch):
    cfg = jget_reduced(arch).replace(dtype="bfloat16")
    jp = jax.tree.map(np.asarray, JT.init(cfg, jax.random.PRNGKey(3)))
    tp = lm_params_from_numpy(jp, CPU)
    leaves_j, leaves_t = jax.tree.leaves(jp), tree_leaves(tp)
    assert len(leaves_j) == len(leaves_t)
    wq = tp["runs"][0]["attn"]["wq"]
    assert wq.shape == (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim)
    for a, b in zip(leaves_j, leaves_t):
        assert b.dtype == torch.bfloat16 and tuple(b.shape) == a.shape
        np.testing.assert_array_equal(b.view(torch.int16).numpy(),
                                      a.view(np.int16))


@pytest.mark.parametrize("arch", DENSE)
def test_bf16_reduced_model_runs_and_agrees(arch):
    """The bf16 path (the full configs' dtype) at the reduced width, against
    the JAX package on the same weights: logits within 2e-2 of their max
    |x|, a few bf16 roundings (2^-8 each) of the stream through two layers
    taken where the two frameworks' sums differ (the gap seen is 8e-3)."""
    jcfg = jget_reduced(arch).replace(dtype="bfloat16")
    tcfg = get_reduced_config(arch).replace(dtype="bfloat16")
    jp = jax.tree.map(np.asarray, JT.init(jcfg, jax.random.PRNGKey(4)))
    tp = lm_params_from_numpy(jp, CPU)
    toks = _tokens(jcfg, 2, 9, seed=4)
    jl, _ = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, 9)
    with torch.no_grad():
        tl, tc = T.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)}, 9)
    assert tl.dtype == torch.float32 and tc[0]["attn"]["k"].dtype == torch.bfloat16
    _close(tl, jl, tol=2e-2)


@pytest.mark.parametrize("arch", MOE)
def test_moe_bf16_reduced_model_runs_and_agrees(arch):
    """The MoE archs in bf16 (the router float32, as the JAX tree has it).
    XLA:CPU has no bf16 batched product with a float32 result, so the JAX
    package's MoE cannot run in bf16 here: the reference is its float32
    model on the same bf16 weights.  A bf16 stream and a float32 one may
    route a near-tied token to different experts, a difference of O(gate)
    that is no fault; so every expert is chosen (k = E) and none drops
    (capacity factor 16), and the two differ by the bf16 stream's roundings
    only: logits within 5e-2 of their max |x| (gaps seen 0.7e-2 to 2.2e-2
    over eight weight seeds per arch)."""
    kw = dict(dtype="bfloat16", moe_top_k=4, moe_capacity_factor=16.0)
    jcfg = jget_reduced(arch).replace(**kw)
    tcfg = get_reduced_config(arch).replace(**kw)
    assert tcfg.n_experts == 4
    jp = jax.tree.map(np.asarray, JT.init(jcfg, jax.random.PRNGKey(4)))
    tp = lm_params_from_numpy(jp, CPU)
    assert tp["runs"][-1]["ffn"]["router"].dtype == torch.float32
    jp32 = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    toks = _tokens(jcfg, 2, 9, seed=4)
    jl, _ = jax.jit(lambda p, b: JT.prefill(jcfg.replace(dtype="float32"), p,
                                            b, 9))(jp32,
                                                   {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, tc = T.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)}, 9)
    assert tl.dtype == torch.float32
    assert all(leaf.dtype == torch.bfloat16 for leaf in tree_leaves(tc))
    _close(tl, jl, tol=5e-2)


@pytest.mark.parametrize("include_state", [False, True])
@pytest.mark.parametrize("arch", DENSE + MOE + RECURRENT + FRONTENDS)
def test_split_accounting_matches_the_reference(arch, include_state):
    """Field-exact with the JAX package's plan; with ``include_state`` the
    SSM (mLSTM C) and hybrid (mamba h) payloads gain the head layers'
    state.  ``SERVER_ONLY`` counts S token ids for every arch, musicgen's
    float frames included, as the JAX package counts them."""
    jcfg, tcfg = jget_config(arch), get_config(arch)
    assert count_params(tcfg) == jbase.count_params(jcfg)
    assert count_active_params(tcfg) == jbase.count_active_params(jcfg)
    jplan = jsplit.LMSplitPlan(jcfg, None, workload=jsplit.Workload(
        n_tokens=2048, include_state=include_state))
    tplan = LMSplitPlan(tcfg, None, workload=Workload(
        n_tokens=2048, include_state=include_state), device=CPU)
    assert tplan.options == jplan.options
    for opt in tplan.options:
        assert tplan.payload_specs(opt) == jplan.payload_specs(opt)
        assert tplan.raw_payload_bytes(opt, 3) == jplan.raw_payload_bytes(opt, 3)
        assert tplan.head_flops(opt) == jplan.head_flops(opt)
        assert tplan.tail_flops(opt) == jplan.tail_flops(opt)


def _serve_args(**kw):
    args = dict(arch="qwen3-1.7b", reduced=True, prompt_len=16, gen=4, batch=2,
                split=0.0, device="cpu", status_out=None)
    args.update(kw)
    return argparse.Namespace(**args)


@pytest.mark.parametrize("split", [0.0, 0.5])
def test_serve_on_the_cpu(split, tmp_path, capsys):
    """Counters against the JAX package's driver (those that do not depend
    on the weights) and the status JSON round trip."""
    st = tserve.serve(_serve_args(split=split))
    ref = jserve.serve(argparse.Namespace(arch="qwen3-1.7b", reduced=True,
                                          prompt_len=16, gen=4, batch=2,
                                          split=split))
    ctr, rctr = st["metrics"]["counters"], ref["metrics"]["counters"]
    for name in ("requests_total", "tokens_generated_total",
                 "boundary_raw_bytes_total"):
        assert ctr[name] == rctr[name]
    assert ctr["requests_total"] == 2 and st["tokens_generated"] == 8
    assert ctr["nonfinite_logits_total"] == 0
    assert (ctr["boundary_raw_bytes_total"] > 0) == (split > 0)
    hist = st["metrics"]["histograms"]
    assert hist["prefill_s"]["count"] == 1 and hist["decode_step_s"]["count"] == 4
    assert ("split_s" in hist) == (split > 0)
    out = tmp_path / "status.json"
    argv = ["--reduced", "--device", "cpu", "--prompt-len", "16", "--gen", "4",
            "--batch", "2", "--split", str(split), "--status-out", str(out)]
    assert tserve.main(argv) == 0
    back = json.loads(out.read_text())
    assert back["status"] == "ok" and back["tokens_generated"] == 8
    assert back["metrics"]["counters"] == json.loads(json.dumps(ctr))
    assert "decode 4 steps" in capsys.readouterr().out


@pytest.mark.parametrize("split", [0.0, 0.5])
@pytest.mark.parametrize("arch", MOE + RECURRENT)
def test_moe_serve_on_the_cpu(arch, split, capsys):
    """``serve --arch`` of a MoE, SSM or hybrid arch on the CPU: the
    counters against the JAX package's driver, every logit finite, the
    split's payload the (B, S, d) stream in the config's dtype alone, as the
    JAX package's head ships it.  A prompt of 20 and 6 steps take Hymba's
    reduced window of 16 past its wrap."""
    st = tserve.serve(_serve_args(arch=arch, split=split, prompt_len=20,
                                  gen=6))
    ref = jserve.serve(argparse.Namespace(arch=arch, reduced=True,
                                          prompt_len=20, gen=6, batch=2,
                                          split=split))
    ctr, rctr = st["metrics"]["counters"], ref["metrics"]["counters"]
    for name in ("requests_total", "tokens_generated_total",
                 "boundary_raw_bytes_total"):
        assert ctr[name] == rctr[name]
    cfg = get_reduced_config(arch)
    assert ctr["boundary_raw_bytes_total"] == (2 * 20 * cfg.d_model * 4
                                               if split else 0)
    assert ctr["nonfinite_logits_total"] == 0 and st["tokens_generated"] == 12
    assert st["metrics"]["histograms"]["decode_step_s"]["count"] == 6
    assert "decode 6 steps" in capsys.readouterr().out


@pytest.mark.parametrize("arch", MOE + RECURRENT)
def test_moe_entry_points_default_to_the_card(arch, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced_config(arch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--arch", arch, "--reduced", "--gen", "1",
                     "--prompt-len", "4"])
    for make in (get_model, lambda c: LMSplitPlan(c, None),
                 lambda c: T.init(c, torch.Generator().manual_seed(0))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(cfg)


def test_serve_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--reduced", "--gen", "1", "--prompt-len", "4"])
    cfg = get_reduced_config("qwen3-1.7b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init(cfg, torch.Generator().manual_seed(0))


def test_registry_input_specs():
    cfg = get_reduced_config("smollm-360m")
    model = get_model(cfg, CPU)
    shape = InputShape("t", seq_len=7, global_batch=3, kind="prefill")
    spec = model.prefill_inputs(shape)["tokens"]
    assert spec.shape == (3, 7) and spec.dtype == torch.int32
    assert model.decode_inputs(shape)["tokens"].shape == (3, 1)
    toks = model.concrete(model.prefill_inputs(shape),
                          torch.Generator().manual_seed(0))["tokens"]
    assert toks.shape == (3, 7) and toks.dtype == torch.int32
    assert int(toks.max()) < cfg.vocab_size and int(toks.min()) >= 0
    caches = model.cache_init(3, 11)
    assert caches[0]["attn"]["k"].shape == (cfg.n_layers, 3, cfg.n_kv_heads, 11,
                                            cfg.head_dim)


@pytest.fixture(scope="module")
def hymba():
    """Reduced hymba-1.5b (3 layers, the middle one windowed at 16): (JAX
    config, port config, JAX params, port params)."""
    jcfg, tcfg = jget_reduced("hymba-1.5b"), get_reduced_config("hymba-1.5b")
    assert [k.sliding_window for k in T.layer_plan(tcfg)] == [0, 16, 0]
    jp = jax.tree.map(np.asarray, JT.init(jcfg, jax.random.PRNGKey(11)))
    return jcfg, tcfg, jp, lm_params_from_numpy(jp, CPU)


@pytest.mark.parametrize("prompt", [12, 16, 20, 37])
def test_hymba_ring_decode_past_the_wrap_matches_the_reference(hymba, prompt):
    """Prompts below, at and past the window of 16 (the prefill merge rolls
    the last 16 rows by prompt % 16), then 20 greedy decode steps, which
    wrap the ring: logits and every cache leaf (the ring as it lies, the
    global caches, the mamba states) against the JAX ``decode_step``."""
    jcfg, tcfg, jp, tp = hymba
    toks = _tokens(jcfg, 2, prompt, seed=prompt)
    max_len = prompt + 20
    jl, jc = jax.jit(lambda p, b: JT.prefill(jcfg, p, b, max_len))(
        jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, tc = T.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                           max_len)
    _close(tl, jl)
    _close_caches(tc, jc)
    assert tc[1]["attn"]["k"].shape[3] == 16      # the ring, whatever max_len
    step = jax.jit(lambda p, c, b, i: JT.decode_step(jcfg, p, c, b, i))
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for i in range(20):
        jl, jc = step(jp, jc, {"tokens": jnp.asarray(tok)},
                      jnp.asarray(prompt + i, jnp.int32))
        with torch.no_grad():
            tl, tc = T.decode_step(tcfg, tp, tc,
                                   {"tokens": torch.from_numpy(tok)}, prompt + i)
        _close(tl, jl)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    _close_caches(tc, jc)


@pytest.mark.parametrize("prompt", [15, 16, 37])
def test_hymba_port_prefill_decode_consistency_across_the_window(hymba, prompt):
    """Prefill to S-1 plus one decode step (on the ring) against a prefill
    to S (B5's plain version with the window), float32."""
    _, tcfg, _, tp = hymba
    toks = torch.from_numpy(_tokens(tcfg, 2, prompt, seed=3))
    with torch.no_grad():
        full, _ = T.prefill(tcfg, tp, {"tokens": toks}, prompt)
        _, caches = T.prefill(tcfg, tp, {"tokens": toks[:, :-1]}, prompt)
        dec, _ = T.decode_step(tcfg, tp, caches, {"tokens": toks[:, -1:]},
                               prompt - 1)
    _close(dec, full.numpy())


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_decode_writes_its_states_into_the_caches(arch):
    """A decode step leaves the stacked caches holding the new states: the
    tree ``decode_step`` returns is views of the caches it was given, and a
    second step from them equals a second step from a copy."""
    cfg = get_reduced_config(arch)
    params = T.init(cfg, torch.Generator().manual_seed(5), CPU)
    toks = torch.from_numpy(_tokens(cfg, 2, 9, seed=5))
    with torch.no_grad():
        _, caches = T.prefill(cfg, params, {"tokens": toks}, 11)
        before = [tree_map(torch.clone, c) for c in caches]
        _, after = T.decode_step(cfg, params, caches, {"tokens": toks[:, :1]}, 9)
        for c, b, a in zip(caches, before, after):
            for x, y, z in zip(tree_leaves(c), tree_leaves(b), tree_leaves(a)):
                assert x.data_ptr() == z.data_ptr()
            assert any(not torch.equal(x, y) for x, y in
                       zip(tree_leaves(c), tree_leaves(b)))
        copies = [tree_map(torch.clone, c) for c in caches]
        l1, _ = T.decode_step(cfg, params, caches, {"tokens": toks[:, 1:2]}, 10)
        l2, _ = T.decode_step(cfg, params, copies, {"tokens": toks[:, 1:2]}, 10)
    torch.testing.assert_close(l1, l2, rtol=0, atol=0)
