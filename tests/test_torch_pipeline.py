"""The port's single-UE adaptive frame loop against the JAX package's.

Module by module, on the same numpy inputs and seeds:

- calibration from one cache table (written by the test): every field of
  ``Calibrated`` and its per-option times and bytes are exactly equal;
- the channel and energy models: the same seeds give the same draws, bit
  for bit;
- the throughput estimator: identical datasets; predictions with the JAX
  estimator's parameters carried across within PRED_RTOL (float32 through
  three layers and ``10 ** y``); training from the JAX init within
  TRAIN_RTOL after TRAIN_STEPS steps (sums in other orders compound in
  Adam);
- distance correlation within DCOR_TOL;
- the controller's decisions over a seeded KPM sequence, with every
  feedback hook, are the same options;
- the accounting run of the paper's loop (full Swin-T, the example's
  24-frame jammer sweep, ``Objective(w_privacy=3.0)``): the same option in
  every frame and every ``FrameLog`` field equal apart from ``predicted``;
- an executed run at the reduced size on the JAX package's weights, fused
  and legacy codec, adaptive and fixed options: the same options and raw
  bytes, compressed bytes within COMP_RTOL (head activations that differ by
  float32 rounding can land on neighbouring int8 grid points).

The port never writes the JAX package's ``.calibration_cache.json``.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.swin_t_detection import CONFIG as JCONFIG, reduced as jreduced
from repro.core import adaptive as JA
from repro.core import calibration as JC
from repro.core import channel as JCH
from repro.core import energy as JE
from repro.core import privacy as JP
from repro.core import throughput as JT
from repro.core.compression import ActivationCodec as JCodec
from repro.core.pipeline import FrameLog as JFrameLog
from repro.core.pipeline import encode_group_stage as j_encode_group_stage
from repro.core.pipeline import SplitInferencePipeline as JPipeline
from repro.core.splitting import SwinSplitPlan as JPlan
from repro.data.video import SyntheticVideo as JVideo, VideoConfig as JVideoConfig
from repro.models import swin as JSW
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.swin_t_detection import CONFIG, reduced
from repro_torch.core import adaptive as A
from repro_torch.core import calibration as C
from repro_torch.core import channel as CH
from repro_torch.core import energy as E
from repro_torch.core import privacy as P
from repro_torch.core import throughput as T
from repro_torch.core.compression import ActivationCodec
from repro_torch.core.pipeline import (FrameLog, SplitInferencePipeline,
                                       build_pipeline, encode_group_stage)
from repro_torch.core.splitting import SwinSplitPlan

PRED_RTOL = 2e-5
TRAIN_STEPS = 60
TRAIN_RTOL = 2e-5
DCOR_TOL = 1e-5
COMP_RTOL = 0.02

# payload sizes as the JAX package measured them at full width (a
# .calibration_cache.json of this repository)
CACHE = {
    "ue_only": {"raw": 0, "compressed": 0},
    "split1": {"raw": 15667200, "compressed": 3352860},
    "split2": {"raw": 18278400, "compressed": 3814666},
    "split3": {"raw": 19584000, "compressed": 4073777},
    "split4": {"raw": 19584000, "compressed": 4065219},
    "server_only": {"raw": 1305600, "compressed": 1305600},
}
REF_CACHE = os.path.abspath(JC.CACHE_PATH)


def _sweep(n=24):
    """The jammer sweep of examples/adaptive_split_video.py."""
    t = np.linspace(0, 1, n)
    return -40 + 35 * np.exp(-((t - 0.55) / 0.18) ** 2)


def _ref_cache_state():
    if not os.path.exists(REF_CACHE):
        return None
    with open(REF_CACHE, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def ref_cache_before():
    return _ref_cache_state()


@pytest.fixture(scope="module")
def cache_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("calib") / "cache.json"
    path.write_text(json.dumps(CACHE))
    return str(path)


@pytest.fixture(scope="module")
def systems(cache_file, ref_cache_before):
    return (C.calibrate(cache_path=cache_file, device="cpu"),
            JC.calibrate(cache_path=cache_file))


@pytest.fixture(scope="module")
def estimators(systems):
    """The example's estimator, trained by the JAX package, and the same
    parameters carried across to the port."""
    _, jsys = systems
    jest = JT.train_estimator(jsys.channel, "kpm+spec", n_train=1500, steps=250)
    est = T.ThroughputEstimator(
        mode=jest.mode, params=params_from_numpy(
            jax.tree.map(np.asarray, jest.params), "cpu"),
        y_mean=jest.y_mean, y_std=jest.y_std, device="cpu")
    return est, jest


def _controllers(systems, estimators, objective):
    (sysm, jsys), (est, jest) = systems, estimators
    ctrl = A.AdaptiveController(
        system=sysm, estimator=est, objective=A.Objective(**objective),
        path=CH.dupf_path(), privacy_profile=dict(A.DEFAULT_PRIVACY_PROFILE))
    jctrl = JA.AdaptiveController(
        system=jsys, estimator=jest, objective=JA.Objective(**objective),
        path=JCH.dupf_path(), privacy_profile=dict(JA.DEFAULT_PRIVACY_PROFILE))
    return ctrl, jctrl


def _assert_same_prediction(p, jp):
    assert (p.option, p.feasible) == (jp.option, jp.feasible)
    for f in ("delay_s", "energy_j", "privacy", "cost"):
        np.testing.assert_allclose(getattr(p, f), getattr(jp, f), rtol=1e-5)


# -- calibration ---------------------------------------------------------------

class _DuckPlan:
    """A plan that is no Swin plan of either package: calibration estimates
    its bytes from its own payload specs."""
    def raw_payload_bytes(self, option):
        return 4 * 1000
    def payload_specs(self, option):
        return [((10, 100), "float32")]


def test_calibration_is_field_exact(systems):
    sysm, jsys = systems
    for name in ("ue", "edge", "radio"):
        assert (dataclasses.astuple(getattr(sysm, name))
                == dataclasses.astuple(getattr(jsys, name)))
    assert sysm.channel.rate_table == jsys.channel.rate_table
    assert ((sysm.channel.fading_sigma, sysm.channel.min_rate)
            == (jsys.channel.fading_sigma, jsys.channel.min_rate))
    assert sysm.raw_bytes == jsys.raw_bytes
    assert sysm.compressed_bytes == jsys.compressed_bytes
    assert dataclasses.astuple(sysm.swin_cfg) == dataclasses.astuple(jsys.swin_cfg)
    assert C.PAPER == JC.PAPER
    for cfg, jcfg in ((CONFIG, JCONFIG), (reduced(), jreduced())):
        plan = SwinSplitPlan(cfg, None, device="cpu")
        jplan = JPlan(jcfg, None)
        for opt in plan.options:
            assert sysm.head_time_s(opt) == jsys.head_time_s(opt)
            assert sysm.tail_time_s(opt) == jsys.tail_time_s(opt)
            assert (sysm.payload_bytes(plan, opt)
                    == jsys.payload_bytes(jplan, opt))
    for opt in ("split1", "server_only"):
        assert (sysm.payload_bytes(_DuckPlan(), opt)
                == jsys.payload_bytes(_DuckPlan(), opt))


def test_calibration_writes_only_its_own_cache(monkeypatch, tmp_path):
    """A forced calibration measures (here: the table above stands in for
    the full-width measurement) and writes the cache it was given; the
    port's default cache is not the JAX package's file."""
    assert os.path.abspath(C.CACHE_PATH) != REF_CACHE
    writes = []
    real_open = open

    def spy(path, mode="r", *a, **kw):
        if "w" in mode:
            writes.append(os.path.abspath(path))
        return real_open(path, mode, *a, **kw)

    monkeypatch.setattr(C, "open", spy, raising=False)
    monkeypatch.setattr(C, "_measure_payloads", lambda *a, **kw: CACHE)
    path = tmp_path / "forced.json"
    sysm = C.calibrate(force=True, cache_path=str(path), device="cpu")
    assert writes == [os.path.abspath(path)]
    assert json.loads(path.read_text()) == CACHE
    assert sysm.compressed_bytes["split1"] == CACHE["split1"]["compressed"]


def test_measure_payloads_at_reduced_size():
    """The port's head + codec per option; the raw sizes are the JAX
    package's (the compressed ones follow other weights)."""
    out = C._measure_payloads(reduced(), ActivationCodec(device="cpu"),
                              device="cpu")
    jout = JC._measure_payloads(jreduced(), JCodec())
    assert out.keys() == jout.keys()
    for opt in out:
        assert out[opt]["raw"] == jout[opt]["raw"]
        assert 0 < out[opt]["compressed"] <= out[opt]["raw"] or opt == "ue_only"


def test_entry_points_raise_without_a_card(monkeypatch, cache_file):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        C.calibrate(cache_path=cache_file)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.ThroughputEstimator()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_pipeline(execute_model=False)


# -- channel and energy ---------------------------------------------------------

def test_channel_and_energy_draws_are_identical(systems):
    sysm, jsys = systems
    for seed in (0, 7):
        r, jr = np.random.default_rng(seed), np.random.default_rng(seed)
        for lvl in (-40.0, -22.5, -5.0):
            for nb in (False, True):
                assert (dataclasses.astuple(CH.observe_kpms(lvl, nb, r))
                        == dataclasses.astuple(JCH.observe_kpms(lvl, nb, jr)))
                np.testing.assert_array_equal(CH.iq_spectrogram(lvl, nb, r),
                                              JCH.iq_spectrogram(lvl, nb, jr))
                assert (sysm.channel.sample_rate(lvl, r, narrowband=nb)
                        == jsys.channel.sample_rate(lvl, jr, narrowband=nb))
        lv = np.array([-40.0, -12.0, -5.0])
        nbs = np.array([False, True, False])
        for a, b in zip(dataclasses.astuple(CH.observe_kpms(lv, nbs, r)),
                        dataclasses.astuple(JCH.observe_kpms(lv, nbs, jr))):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(sysm.channel.sample_rate(lv, r, nbs),
                                      jsys.channel.sample_rate(lv, jr, nbs))
        for path, jpath in ((CH.dupf_path(), JCH.dupf_path()),
                            (CH.cupf_path(), JCH.cupf_path())):
            assert path.sample_latency(r) == jpath.sample_latency(jr)
            np.testing.assert_array_equal(path.sample_latency(r, size=5),
                                          jpath.sample_latency(jr, size=5))
        np.testing.assert_array_equal(
            CH.sample_path_latencies([CH.dupf_path(), CH.cupf_path()], r, 2),
            JCH.sample_path_latencies([JCH.dupf_path(), JCH.cupf_path()], jr, 2))
    assert sysm.channel.db_slope() == jsys.channel.db_slope()
    assert CH.effective_level(-10.0, True) == JCH.effective_level(-10.0, True)
    for prof, jprof in ((sysm.ue, jsys.ue), (sysm.edge, jsys.edge)):
        for b in (0, 1, 4):
            assert (prof.batch_compute_time_s(1e9, b)
                    == jprof.batch_compute_time_s(1e9, b))
        assert prof.compute_energy_j(3e9) == jprof.compute_energy_j(3e9)
        assert (E.interval_energy_j(prof, 0.3, 1.0)
                == JE.interval_energy_j(jprof, 0.3, 1.0))
    for lvl in (-40.0, -20.0, -5.0):
        assert (sysm.radio.tx_energy_j(0.2, lvl)
                == jsys.radio.tx_energy_j(0.2, lvl))
    assert E.WH_PER_J == JE.WH_PER_J


# -- throughput estimator -----------------------------------------------------------

@pytest.mark.parametrize("mode", ["kpm", "kpm+spec"])
def test_make_dataset_is_identical(systems, mode):
    sysm, jsys = systems
    X, y, nb = T.make_dataset(sysm.channel, 64, mode, seed=5)
    jX, jy, jnb = JT.make_dataset(jsys.channel, 64, mode, seed=5)
    assert X.shape == (64, T.feature_dim(mode)) and T.feature_dim(mode) == JT.feature_dim(mode)
    for a, b in ((X, jX), (y, jy), (nb, jnb)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_predictions_with_bridged_parameters(systems, estimators):
    sysm, _ = systems
    est, jest = estimators
    X, _, _ = T.make_dataset(sysm.channel, 256, "kpm+spec", seed=11)
    pred, jpred = est.predict_batch(X), jest.predict_batch(X)
    assert pred.dtype == jpred.dtype == np.float32
    np.testing.assert_allclose(pred, jpred, rtol=PRED_RTOL)
    r = np.random.default_rng(3)
    for lvl, nb in ((-35.0, False), (-8.0, True)):
        kpm = CH.observe_kpms(lvl, nb, r)
        spec = CH.iq_spectrogram(lvl, nb, r)
        np.testing.assert_allclose(est.predict(kpm, spec),
                                   jest.predict(kpm, spec), rtol=PRED_RTOL)
    assert (T.ConstantRateEstimator(5e7).predict(None, None)
            == JT.ConstantRateEstimator(5e7).predict(None, None))


def test_training_from_the_jax_init(systems):
    """The same init, dataset, minibatches and Adam: the trained estimators
    predict within TRAIN_RTOL of each other."""
    sysm, jsys = systems
    init = JT.ThroughputEstimator(mode="kpm+spec").init(jax.random.PRNGKey(0))
    est = T.train_estimator(
        sysm.channel, "kpm+spec", n_train=512, steps=TRAIN_STEPS, seed=0,
        device="cpu",
        params=params_from_numpy(jax.tree.map(np.asarray, init.params), "cpu"))
    jest = JT.train_estimator(jsys.channel, "kpm+spec", n_train=512,
                              steps=TRAIN_STEPS, seed=0)
    assert (est.y_mean, est.y_std) == (jest.y_mean, jest.y_std)
    X, _, _ = T.make_dataset(sysm.channel, 256, "kpm+spec", seed=12)
    np.testing.assert_allclose(est.predict_batch(X), jest.predict_batch(X),
                               rtol=TRAIN_RTOL)
    ev, jev = (T.eval_estimator(est, sysm.channel, n=128),
               JT.eval_estimator(jest, jsys.channel, n=128))
    for k in jev:
        np.testing.assert_allclose(ev[k], jev[k], rtol=0, atol=TRAIN_RTOL)


def test_fresh_training_on_the_port_learns(systems):
    """The port's own init (a torch generator) trains to a useful
    estimator: its error is of the JAX package's order."""
    sysm, _ = systems
    est = T.train_estimator(sysm.channel, "kpm+spec", n_train=512, steps=150,
                            seed=0, device="cpu")
    assert T.eval_estimator(est, sysm.channel, n=256)["median_rel_err"] < 0.3


# -- privacy ----------------------------------------------------------------------------

def test_distance_correlation_matches(rng):
    n = 24
    x = rng.normal(size=(n, 3, 40)).astype(np.float32)
    for y in (x * 2 + 1, rng.normal(size=(n, 50)).astype(np.float32),
              np.tanh(x.reshape(n, -1) @ rng.normal(size=(120, 9000))
                      ).astype(np.float32)):
        got = P.distance_correlation(torch.from_numpy(x), torch.from_numpy(y))
        want = JP.distance_correlation(jnp.asarray(x), jnp.asarray(y))
        assert abs(got - want) <= DCOR_TOL
    tree = {"feats": [x * 0.5, np.maximum(x, 0)], "s": np.float32(3.0)}
    got = P.payload_privacy(torch.from_numpy(x),
                            {"feats": [torch.from_numpy(a) for a in tree["feats"]],
                             "s": torch.tensor(3.0)})
    want = JP.payload_privacy(jnp.asarray(x), jax.tree.map(jnp.asarray, tree))
    assert abs(got - want) <= DCOR_TOL
    assert P.payload_privacy(torch.from_numpy(x), {}) == 0.0


# -- controller ---------------------------------------------------------------------------

@pytest.mark.parametrize("objective", [{"w_privacy": 3.0}, {},
                                       {"w_delay": 1.0, "w_energy": 0.15,
                                        "w_privacy": 0.05, "d_max_s": 2.0}])
def test_controller_decides_the_same(systems, estimators, objective):
    ctrl, jctrl = _controllers(systems, estimators, objective)
    options = SwinSplitPlan(CONFIG, None, device="cpu").options
    r = np.random.default_rng(21)
    for k in range(40):
        lvl = float(r.uniform(-42, -4))
        nb = bool(r.random() < 0.5)
        kpm, spec = CH.observe_kpms(lvl, nb, r), CH.iq_spectrogram(lvl, nb, r)
        for c in (ctrl, jctrl):
            c.interference_db = lvl
            if k == 10:
                c.frame_period_s = 0.5
            if k % 7 == 3:
                c.observe_ratio(2_000_000 + 1000 * k, 15_667_200)
            if k % 5 == 1:
                c.observe_grant(4e7 + 1e6 * k)
            if k % 6 == 2:
                c.observe_stream(0.4 + 0.01 * k, dropped=k % 12 == 2)
            if k % 9 == 4:
                c.relax_grant(6e7)
            if k == 20:
                c.notify_handover()
            if k == 30:
                c.notify_outage()
        _assert_same_prediction(ctrl.decide(kpm, spec, options),
                                jctrl.decide(kpm, spec, options))
    clones = ctrl.spawn(2)
    assert clones[0]._current is None and clones[0].estimator is ctrl.estimator


@pytest.mark.parametrize("fused", [True, False])
def test_encode_group_stage_matches(systems, fused):
    """The multi-UE encode stage: per-UE results byte-identical to the JAX
    package's, and the same accounting for the options it does not run."""
    sysm, jsys = systems
    rng = np.random.default_rng(8)
    trees = [{"feats": [rng.normal(size=(1, 14, 14, 16)).astype(np.float32)],
              "x": rng.normal(size=(1, 7, 7, 32)).astype(np.float32)}
             for _ in range(3)]
    plan, jplan = SwinSplitPlan(reduced(), None, device="cpu"), JPlan(jreduced(), None)
    codec = ActivationCodec(fused=fused, device="cpu")
    jcodec = JCodec(fused=fused)
    for opt, execute in (("split1", True), ("split1", False),
                         ("server_only", True), ("ue_only", True)):
        ctrls, jctrls = [None] * 3, [None] * 3
        out = encode_group_stage(
            plan, sysm, codec,
            [jax.tree.map(torch.from_numpy, t) for t in trees], opt, execute,
            ctrls)
        jout = j_encode_group_stage(
            jplan, jsys, jcodec, [jax.tree.map(jnp.asarray, t) for t in trees],
            opt, execute, jctrls)
        for r, jr in zip(out, jout):
            assert (r.raw_bytes, r.compressed_bytes) == (jr.raw_bytes,
                                                         jr.compressed_bytes)
            if execute and opt == "split1":
                for a, b in zip(jax.tree.leaves(r.payload),
                                jax.tree.leaves(jr.payload)):
                    assert a.numpy().tobytes() == np.asarray(b).tobytes()


# -- the loop -----------------------------------------------------------------------------

LOG_FIELDS = [f.name for f in dataclasses.fields(JFrameLog)]


@pytest.mark.parametrize("narrowband", [False, True])
def test_accounting_run_is_field_exact(systems, estimators, narrowband):
    (sysm, jsys) = systems
    ctrl, jctrl = _controllers(systems, estimators, {"w_privacy": 3.0})
    pipe = SplitInferencePipeline(
        plan=SwinSplitPlan(CONFIG, None, device="cpu"), system=sysm,
        codec=ActivationCodec(device="cpu"), controller=ctrl,
        path=CH.dupf_path(), narrowband=narrowband, execute_model=False)
    jpipe = JPipeline(
        plan=JPlan(JCONFIG, None), system=jsys, codec=JCodec(),
        controller=jctrl, path=JCH.dupf_path(), narrowband=narrowband,
        execute_model=False)
    logs, jlogs = pipe.run_trace(None, _sweep()), jpipe.run_trace(None, _sweep())
    assert [l.option for l in logs] == [l.option for l in jlogs]
    assert len({l.option for l in logs}) > 1          # the loop adapts
    assert [f.name for f in dataclasses.fields(FrameLog)] == LOG_FIELDS
    for log, jlog in zip(logs, jlogs):
        for name in LOG_FIELDS:
            if name != "predicted":
                assert getattr(log, name) == getattr(jlog, name), name
        _assert_same_prediction(log.predicted, jlog.predicted)
        assert log.energy_j == jlog.energy_j


@pytest.fixture(scope="module")
def executed_setup():
    cfg, jcfg = reduced(), jreduced()
    init = jax.jit(lambda key: JSW.init(jcfg, key))
    jparams = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(4)
    for stage in jparams["stages"]:
        for bp in stage["blocks"]:
            bp["rel_bias"] = rng.normal(size=bp["rel_bias"].shape).astype(np.float32)
    video = JVideo(JVideoConfig(h=cfg.img_h, w=cfg.img_w, seed=0))
    imgs = [video.frame(t)[0][None] for t in range(4)]
    return cfg, jcfg, jparams, imgs


@pytest.mark.parametrize("fused", [True, False])
def test_executed_run_matches(systems, estimators, executed_setup, fused,
                              ref_cache_before):
    sysm, jsys = systems
    cfg, jcfg, jparams, imgs = executed_setup
    ctrl, jctrl = _controllers(systems, estimators, {"w_privacy": 3.0})
    plan = SwinSplitPlan(cfg, params_from_numpy(jparams, "cpu"), device="cpu")
    jplan = JPlan(jcfg, jax.tree.map(jnp.asarray, jparams))
    pipe = SplitInferencePipeline(
        plan=plan, system=sysm, codec=ActivationCodec(fused=fused, device="cpu"),
        controller=ctrl, execute_model=True)
    jpipe = JPipeline(plan=jplan, system=jsys, codec=JCodec(fused=fused),
                      controller=jctrl, execute_model=True)
    trace = _sweep(len(imgs))
    logs = pipe.run_trace([torch.from_numpy(i) for i in imgs], trace)
    jlogs = jpipe.run_trace([jnp.asarray(i) for i in imgs], trace)
    for i, opt in enumerate(plan.options):
        logs.append(pipe.run_frame(torch.from_numpy(imgs[i % 4]), -20.0, opt))
        jlogs.append(jpipe.run_frame(jnp.asarray(imgs[i % 4]), -20.0, opt))
    assert [l.option for l in logs] == [l.option for l in jlogs]
    for log, jlog in zip(logs, jlogs):
        for name in ("raw_bytes", "rate_bps", "head_s", "tail_s", "path_s",
                     "interference_db"):
            assert getattr(log, name) == getattr(jlog, name), name
        np.testing.assert_allclose(log.compressed_bytes, jlog.compressed_bytes,
                                   rtol=COMP_RTOL)
        assert np.isfinite(log.delay_s) and log.quant_s >= 0.0
    # the JAX package's cache file is as it was when this module started
    if ref_cache_before is not None:
        assert _ref_cache_state() == ref_cache_before
