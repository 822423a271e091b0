"""The port's audio and vision frontends and logit soft-capping against the
JAX package, on the CPU.

musicgen-reduced (2 codebooks of 64 entries: precomputed EnCodec frame
embeddings in, one head per codebook out, codebook tokens or frames in
decode) and internvl2-reduced (8 precomputed patch embeddings prepended to
the text tokens) run with the JAX package's weights (``T.init(cfg,
PRNGKey)`` carried across by ``bridge.lm_params_from_numpy``) and the same
numpy inputs on both sides: prefill logits and caches, three greedy decode
steps, the split at every default candidate and ``SERVER_ONLY`` with the
raw inputs in its payload, the accounting, the serving driver, and the
port's own prefill -> decode consistency.  Then reduced qwen3-1.7b and
hymba-1.5b with ``attn_logit_softcap`` set (B5 and B6 cap their logits,
Hymba's on its ring too), and a capped deepseek, whose MLA ignores the cap
in both packages.  The reduced configs are float32; logits and caches must
agree within LM_TOL of their max |x| (``tests/test_torch_lm.py``'s).
"""
import argparse
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jget_reduced
from repro.core import compression as jcomp
from repro.core import splitting as jsplit
from repro.launch import serve as jserve
from repro.models import registry as JR
from repro.models import transformer as JT
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import InputShape
from repro_torch.core.compression import ActivationCodec
from repro_torch.core.splitting import (SERVER_ONLY, UE_ONLY, LMSplitPlan,
                                        Workload, default_candidates,
                                        split_option)
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_model
from repro_torch.tree import tree_flatten, tree_leaves

FRONTENDS = ("musicgen-medium", "internvl2-26b")
LM_TOL = 2e-5
CPU = torch.device("cpu")


def _close(port, ref, tol=LM_TOL):
    port = port.detach().float().numpy() if torch.is_tensor(port) else port
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= tol, err


def _close_caches(port, ref):
    assert len(port) == len(ref)
    for tc, jc in zip(port, ref):
        leaves, treedef = tree_flatten(tc)
        jleaves, jdef = jax.tree.flatten(jc)
        assert treedef.num_leaves == jdef.num_leaves
        for a, b in zip(leaves, jleaves):
            _close(a, b)


def _bridge(jcfg, seed):
    jp = jax.tree.map(np.asarray, JT.init(jcfg, jax.random.PRNGKey(seed)))
    return jp, lm_params_from_numpy(jp, CPU)


@pytest.fixture(scope="module", params=FRONTENDS)
def fe(request):
    """(arch, JAX config, port config, JAX params, port params)."""
    arch = request.param
    jcfg, tcfg = jget_reduced(arch), get_reduced_config(arch)
    return (arch, jcfg, tcfg) + _bridge(jcfg, 7)


def _prompt(cfg, B, S, seed=0):
    """The prompt as numpy arrays: musicgen's frames (B, S, d); InternVL's
    patches (B, P, d) and S - P text tokens."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_frames":
        return {"frames": rng.standard_normal((B, S, cfg.d_model))
                .astype(np.float32)}
    P = cfg.n_frontend_tokens
    return {"patches": rng.standard_normal((B, P, cfg.d_model))
            .astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (B, S - P))
            .astype(np.int32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _greedy(cfg, logits):
    """The next decode input from (B, 1, V) or (B, 1, ncb, V) logits, as the
    drivers take it: (B, 1) or one token per codebook (B, 1, ncb)."""
    return np.asarray(jnp.argmax(logits[:, -1:], -1)).astype(np.int32)


def test_prefill_and_decode_match_the_reference(fe):
    arch, jcfg, tcfg, jp, tp = fe
    batch = _prompt(jcfg, 2, 12)
    jl, jc = jax.jit(lambda p, b: JT.prefill(jcfg, p, b, 16))(jp, _jax(batch))
    with torch.no_grad():
        tl, tc = T.prefill(tcfg, tp, _torch(batch), 16)
    shape = (2, 1, tcfg.n_codebooks, 64) if tcfg.n_codebooks else (2, 1, 128)
    assert tuple(tl.shape) == shape
    _close(tl, jl)
    _close_caches(tc, jc)
    step = jax.jit(lambda p, c, b, i: JT.decode_step(jcfg, p, c, b, i))
    tok = _greedy(jcfg, jl)
    for i in range(3):
        jl, jc = step(jp, jc, {"tokens": jnp.asarray(tok)},
                      jnp.asarray(12 + i, jnp.int32))
        with torch.no_grad():
            tl, tc = T.decode_step(tcfg, tp, tc,
                                   {"tokens": torch.from_numpy(tok)}, 12 + i)
        _close(tl, jl)
        _close_caches(tc, jc)
        tok = _greedy(jcfg, jl)
        assert tok.shape == ((2, 1, 2) if tcfg.n_codebooks else (2, 1))


def test_musicgen_decodes_frames_like_the_reference():
    """musicgen's decode step also takes a frame (B, 1, d), as the JAX
    package's ``decode_step`` does: three of them after the prompt."""
    jcfg, tcfg = jget_reduced("musicgen-medium"), get_reduced_config(
        "musicgen-medium")
    jp, tp = _bridge(jcfg, 8)
    frames = _prompt(jcfg, 2, 13, seed=3)["frames"]
    jl, jc = JT.prefill(jcfg, jp, {"frames": jnp.asarray(frames[:, :10])}, 13)
    with torch.no_grad():
        tl, tc = T.prefill(tcfg, tp, {"frames": torch.from_numpy(
            frames[:, :10])}, 13)
    _close(tl, jl)
    for i in range(10, 13):
        f = frames[:, i:i + 1]
        jl, jc = JT.decode_step(jcfg, jp, jc, {"frames": jnp.asarray(f)},
                                jnp.asarray(i, jnp.int32))
        with torch.no_grad():
            tl, tc = T.decode_step(tcfg, tp, tc,
                                   {"frames": torch.from_numpy(f)}, i)
        _close(tl, jl)
        _close_caches(tc, jc)


def test_split_head_codec_tail_match_the_reference(fe):
    """Every default candidate through the int8 codec, ``UE_ONLY`` and
    ``SERVER_ONLY``, whose payload is the raw batch (float frames or
    patches included) as the JAX package's head ships it."""
    _, jcfg, tcfg, jp, tp = fe
    batch = _prompt(jcfg, 2, 10, seed=1)
    assert default_candidates(tcfg) == jsplit.default_candidates(jcfg)
    jplan = jsplit.LMSplitPlan(jcfg, jp, workload=jsplit.Workload(n_tokens=10))
    tplan = LMSplitPlan(tcfg, tp, workload=Workload(n_tokens=10), device=CPU)
    assert tplan.options == jplan.options
    jcodec, tcodec = jcomp.ActivationCodec(), ActivationCodec(device=CPU)
    with torch.no_grad():
        _close(tplan.head(batch, UE_ONLY)[1], jplan.head(_jax(batch),
                                                        UE_ONLY)[1])
        payload, out = tplan.head(batch, SERVER_ONLY)
        assert out is None and set(payload) == set(batch)
        assert all(payload[k] is batch[k] for k in batch)
        _close(tplan.tail(payload, SERVER_ONLY),
               jplan.tail(_jax(batch), SERVER_ONLY))
        for l in tplan.candidates:
            opt = split_option(l)
            jpay, _ = jplan.head(_jax(batch), opt)
            tpay, _ = tplan.head(batch, opt)
            _close(tpay["h"], jpay["h"])
            assert tuple(tpay["h"].shape) == (2, 10, tcfg.d_model)
            jcomp_p = jcodec.compress(jpay)
            tdec = tcodec.decompress(jcomp_p)
            np.testing.assert_array_equal(
                tdec["h"].numpy(), np.asarray(jcodec.decompress(jcomp_p)["h"]))
            _close(tplan.tail(tdec, opt),
                   jplan.tail(jcodec.decompress(jcomp_p), opt))
            tcomp = tcodec.compress(tpay)
            assert tcomp.raw_bytes == tplan.raw_payload_bytes(opt, batch=2)
            assert torch.isfinite(tplan.tail(tcodec.decompress(tcomp),
                                             opt)).all()


def _handoff_batches(cfg, S, seed):
    """(prompt to S, prompt to S-1, the decode input of position S-1), torch
    tensors, with the same embedding at S-1 on both paths: musicgen's last
    frame is the sum of its codebook tokens' embeddings in the tests that
    decode tokens (``last_tokens``), InternVL's last text token follows the
    patches."""
    batch = _torch(_prompt(cfg, 2, S, seed=seed))
    if cfg.frontend == "audio_frames":
        return (batch, {"frames": batch["frames"][:, :-1]},
                {"frames": batch["frames"][:, -1:]})
    return (batch, {"patches": batch["patches"],
                    "tokens": batch["tokens"][:, :-1]},
            {"tokens": batch["tokens"][:, -1:]})


@pytest.mark.parametrize("last", ["frame", "codebook tokens"])
def test_musicgen_port_prefill_decode_consistency(last):
    """Prefill to S-1 plus one decode step against a prefill to S, float32:
    the decoded position is a frame, or codebook tokens whose summed
    embeddings are the prefill's frame at that position."""
    cfg = get_reduced_config("musicgen-medium")
    model = get_model(cfg, CPU)
    params = model.init(torch.Generator().manual_seed(2))
    full_b, pre_b, step_b = _handoff_batches(cfg, 12, seed=2)
    if last == "codebook tokens":
        tok = torch.randint(0, cfg.vocab_size, (2, 1, cfg.n_codebooks),
                            generator=torch.Generator().manual_seed(3),
                            dtype=torch.int32)
        step_b = {"tokens": tok}
        frame = T.embed_inputs(cfg, params, step_b)
        full_b = {"frames": torch.cat([pre_b["frames"], frame], dim=1)}
    with torch.no_grad():
        full, _ = model.prefill(params, full_b, 12)
        _, caches = model.prefill(params, pre_b, 12)
        dec, _ = model.decode_step(params, caches, step_b, 11)
    assert tuple(dec.shape) == (2, 1, cfg.n_codebooks, cfg.vocab_size)
    _close(dec, full.numpy())


def test_internvl_port_prefill_decode_consistency():
    """The last text token decoded after the patches (at position S-1, the
    patches counted) against a prefill to S, float32."""
    cfg = get_reduced_config("internvl2-26b")
    model = get_model(cfg, CPU)
    params = model.init(torch.Generator().manual_seed(2))
    full_b, pre_b, step_b = _handoff_batches(cfg, 13, seed=4)
    assert pre_b["patches"].shape[1] + pre_b["tokens"].shape[1] == 12
    with torch.no_grad():
        full, _ = model.prefill(params, full_b, 13)
        _, caches = model.prefill(params, pre_b, 13)
        dec, _ = model.decode_step(params, caches, step_b, 12)
    _close(dec, full.numpy())


def test_codebook_embeddings_sum_as_the_reference_in_bf16():
    """The codebook sum in codebook order in bf16 (the JAX package's
    ``sum(parts)``), bitwise; and a prepended patch stream cast to bf16."""
    for arch in FRONTENDS:
        jcfg = jget_reduced(arch).replace(dtype="bfloat16", n_codebooks=(
            4 if arch == "musicgen-medium" else 0))
        jp, tp = _bridge(jcfg, 9)
        rng = np.random.default_rng(9)
        if jcfg.n_codebooks:
            batch = {"tokens": rng.integers(0, jcfg.vocab_size, (2, 5, 4))
                     .astype(np.int32)}
        else:
            batch = _prompt(jcfg, 2, 12, seed=9)
        ref = np.asarray(JT.embed_inputs(jcfg, jp, _jax(batch)))
        got = T.embed_inputs(jcfg, tp, _torch(batch))
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      ref.view(np.int16))


def test_bf16_frontends_run_and_agree(fe):
    """bf16 at the reduced width against the JAX package on the same
    weights and inputs: logits within 2e-2 of their max |x|, as
    ``tests/test_torch_lm.py`` holds the dense archs."""
    _, jcfg, tcfg, _, _ = fe
    jcfg, tcfg = (c.replace(dtype="bfloat16") for c in (jcfg, tcfg))
    jp, tp = _bridge(jcfg, 4)
    batch = _prompt(jcfg, 2, 12, seed=4)
    jl, _ = JT.prefill(jcfg, jp, _jax(batch), 12)
    with torch.no_grad():
        tl, tc = T.prefill(tcfg, tp, _torch(batch), 12)
    assert tl.dtype == torch.float32 and tc[0]["attn"]["k"].dtype == torch.bfloat16
    _close(tl, jl, tol=2e-2)


def test_init_tree_matches_the_reference(fe):
    """The port's ``init`` against the JAX tree: the same leaves, shapes and
    dtypes (bf16 as the full configs have it), and the codebook scales: the
    (ncb, V, d) embedding at 0.02 and the (ncb, d, V) heads at d^-1/2, not
    the default fan-in of ncb."""
    _, jcfg, tcfg, _, _ = fe
    jcfg, tcfg = (c.replace(dtype="bfloat16", d_model=256, n_heads=4,
                            n_kv_heads=2) for c in (jcfg, tcfg))
    ref = jax.eval_shape(lambda: JT.init(jcfg, jax.random.PRNGKey(0)))
    got = T.init(tcfg, torch.Generator().manual_seed(0), CPU)
    jleaves, t_leaves = jax.tree.leaves(ref), tree_leaves(got)
    assert len(jleaves) == len(t_leaves)
    assert jax.tree.structure(ref).num_leaves == tree_flatten(got)[1].num_leaves
    for a, b in zip(jleaves, t_leaves):
        assert tuple(b.shape) == a.shape
        assert str(b.dtype).removeprefix("torch.") == str(a.dtype)
    d, V = tcfg.d_model, tcfg.vocab_size
    ncb = tcfg.n_codebooks
    if ncb:
        assert tuple(got["embed"].shape) == (ncb, V, d)
        assert tuple(got["lm_head"].shape) == (ncb, d, V)
    for name, scale in (("embed", 0.02), ("lm_head", 1 / math.sqrt(d))):
        std = float(got[name].float().std())
        assert abs(std / scale - 1) < 0.05, (name, std, scale)


def test_bridge_keeps_the_codebook_layout_and_bf16_bits():
    cfg = jget_reduced("musicgen-medium").replace(dtype="bfloat16")
    jp = jax.tree.map(np.asarray, JT.init(cfg, jax.random.PRNGKey(3)))
    tp = lm_params_from_numpy(jp, CPU)
    assert tuple(tp["embed"].shape) == (2, 64, 64) == jp["embed"].shape
    assert tuple(tp["lm_head"].shape) == (2, 64, 64) == jp["lm_head"].shape
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        np.testing.assert_array_equal(b.view(torch.int16).numpy(),
                                      a.view(np.int16))


def test_registry_input_specs_for_the_frontends():
    """``prefill_inputs``: the JAX package's ``train_inputs`` without labels;
    ``decode_inputs`` (B, 1, ncb) for audio; ``concrete`` draws the floats
    normal and the ids below the vocabulary."""
    shape = InputShape("t", seq_len=12, global_batch=3, kind="prefill")
    for arch in FRONTENDS:
        cfg, jcfg = get_reduced_config(arch), jget_reduced(arch)
        model, jmodel = get_model(cfg, CPU), JR.get_model(jcfg)
        spec, jspec = model.prefill_inputs(shape), jmodel.prefill_inputs(shape)
        assert set(spec) == set(jspec)
        for name, s in spec.items():
            assert s.shape == jspec[name].shape
            assert str(s.dtype).removeprefix("torch.") == str(jspec[name].dtype)
        dspec, jdspec = model.decode_inputs(shape), jmodel.decode_inputs(shape)
        assert {k: s.shape for k, s in dspec.items()} == {
            k: s.shape for k, s in jdspec.items()}
        got = model.concrete(spec, torch.Generator().manual_seed(0))
        for name, s in spec.items():
            assert tuple(got[name].shape) == s.shape
            assert got[name].dtype == s.dtype
        if "frames" in got:
            assert abs(float(got["frames"].std()) - 1) < 0.1
        if "tokens" in got:
            assert 0 <= int(got["tokens"].min())
            assert int(got["tokens"].max()) < cfg.vocab_size
        toks = model.concrete(dspec, torch.Generator().manual_seed(1))["tokens"]
        assert int(toks.max()) < cfg.vocab_size


def _serve_args(**kw):
    args = dict(reduced=True, prompt_len=16, gen=4, batch=2, split=0.0,
                device="cpu", status_out=None)
    args.update(kw)
    return argparse.Namespace(**args)


@pytest.mark.parametrize("split", [0.0, 0.5])
@pytest.mark.parametrize("arch", FRONTENDS)
def test_frontend_serve_on_the_cpu(arch, split, capsys):
    """``serve --arch`` on the CPU: the counters against the JAX package's
    driver, every logit finite, the split's payload the (B, S, d) stream
    (patches included)."""
    st = tserve.serve(_serve_args(arch=arch, split=split))
    ref = jserve.serve(argparse.Namespace(arch=arch, reduced=True,
                                          prompt_len=16, gen=4, batch=2,
                                          split=split))
    ctr, rctr = st["metrics"]["counters"], ref["metrics"]["counters"]
    for name in ("requests_total", "tokens_generated_total",
                 "boundary_raw_bytes_total"):
        assert ctr[name] == rctr[name]
    cfg = get_reduced_config(arch)
    assert ctr["boundary_raw_bytes_total"] == (2 * 16 * cfg.d_model * 4
                                               if split else 0)
    assert ctr["nonfinite_logits_total"] == 0 and st["tokens_generated"] == 8
    assert st["metrics"]["histograms"]["decode_step_s"]["count"] == 4
    assert "decode 4 steps" in capsys.readouterr().out


@pytest.mark.parametrize("arch", FRONTENDS)
def test_frontend_entry_points_default_to_the_card(arch, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced_config(arch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--arch", arch, "--reduced", "--gen", "1",
                     "--prompt-len", "12"])
    for make in (get_model, lambda c: LMSplitPlan(c, None),
                 lambda c: T.init(c, torch.Generator().manual_seed(0))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(cfg)


# ---------------------------------------------------------------------------
# logit soft-capping through the LM
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[("qwen3-1.7b", 0.5),
                                        ("qwen3-1.7b", 50.0),
                                        ("hymba-1.5b", 0.5)],
                ids=lambda p: f"{p[0]}-cap{p[1]}")
def capped(request):
    arch, cap = request.param
    jcfg = jget_reduced(arch).replace(attn_logit_softcap=cap)
    tcfg = get_reduced_config(arch).replace(attn_logit_softcap=cap)
    return (arch, jcfg, tcfg) + _bridge(jcfg, 12)


def test_softcapped_prefill_and_decode_match_the_reference(capped):
    """Prefill and 20 greedy decode steps with the cap: a prompt of 20 takes
    Hymba's reduced window of 16 past its wrap, so the ring is capped too;
    logits and every cache leaf against the JAX package."""
    arch, jcfg, tcfg, jp, tp = capped
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size,
                                             (2, 20)).astype(np.int32)
    jl, jc = jax.jit(lambda p, b: JT.prefill(jcfg, p, b, 40))(
        jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, tc = T.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)}, 40)
    _close(tl, jl)
    _close_caches(tc, jc)
    step = jax.jit(lambda p, c, b, i: JT.decode_step(jcfg, p, c, b, i))
    tok = _greedy(jcfg, jl)
    for i in range(20):
        jl, jc = step(jp, jc, {"tokens": jnp.asarray(tok)},
                      jnp.asarray(20 + i, jnp.int32))
        with torch.no_grad():
            tl, tc = T.decode_step(tcfg, tp, tc,
                                   {"tokens": torch.from_numpy(tok)}, 20 + i)
        _close(tl, jl)
        tok = _greedy(jcfg, jl)
    _close_caches(tc, jc)


def test_softcapped_split_matches_the_reference(capped):
    _, jcfg, tcfg, jp, tp = capped
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size,
                                             (2, 20)).astype(np.int32)
    jplan = jsplit.LMSplitPlan(jcfg, jp, workload=jsplit.Workload(n_tokens=20))
    tplan = LMSplitPlan(tcfg, tp, workload=Workload(n_tokens=20), device=CPU)
    jcodec, tcodec = jcomp.ActivationCodec(), ActivationCodec(device=CPU)
    with torch.no_grad():
        for l in tplan.candidates:
            opt = split_option(l)
            jpay, _ = jplan.head({"tokens": jnp.asarray(toks)}, opt)
            tpay, _ = tplan.head({"tokens": toks}, opt)
            _close(tpay["h"], jpay["h"])
            jcomp_p = jcodec.compress(jpay)
            _close(tplan.tail(tcodec.decompress(jcomp_p), opt),
                   jplan.tail(jcodec.decompress(jcomp_p), opt))


def test_the_cap_moves_the_logits(capped):
    """A binding cap changes the model's output (the test above would pass
    on a cap that did nothing only if both packages ignored it)."""
    _, _, tcfg, _, tp = capped
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, tcfg.vocab_size, (2, 20)).astype(np.int32))
    with torch.no_grad():
        a, _ = T.prefill(tcfg, tp, {"tokens": toks}, 20)
        b, _ = T.prefill(tcfg.replace(attn_logit_softcap=0.0), tp,
                         {"tokens": toks}, 20)
    moved = float((a - b).abs().max()) / float(b.abs().max())
    assert moved > (1e-6 if tcfg.attn_logit_softcap > 1 else 1e-3)


def test_mla_ignores_the_cap_as_the_reference():
    """deepseek's MLA reads no ``attn_logit_softcap`` in either package: a
    capped reduced deepseek equals the uncapped one, bitwise on the port,
    and matches the JAX package's capped model."""
    jcfg = jget_reduced("deepseek-v2-lite-16b").replace(attn_logit_softcap=0.5)
    tcfg = get_reduced_config("deepseek-v2-lite-16b")
    jp, tp = _bridge(jcfg, 13)
    toks = np.random.default_rng(8).integers(0, jcfg.vocab_size,
                                             (2, 12)).astype(np.int32)
    jl, _ = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, 12)
    with torch.no_grad():
        capped_, _ = T.prefill(tcfg.replace(attn_logit_softcap=0.5), tp,
                               {"tokens": torch.from_numpy(toks)}, 12)
        plain, _ = T.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)}, 12)
    torch.testing.assert_close(capped_, plain, rtol=0, atol=0)
    _close(capped_, jl)
