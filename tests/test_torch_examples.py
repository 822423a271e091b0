"""The port's examples (``src/repro_torch/examples``) against the JAX
package's ``examples/``, on the CPU at the reduced size.

The Swin examples run on the JAX package's weights (``SW.init(cfg,
PRNGKey(0))``, carried across by ``bridge.params_from_numpy``), one
calibration table written here, and the throughput estimator trained from
the JAX package's init.  The JAX examples calibrate from the shared
``.calibration_cache.json`` and take no cache path, so their calls are
replayed here through the JAX API, calibrated from the same table:

- quickstart: the boundary's tensor count and raw bytes equal, compressed
  bytes within COMP_RTOL, the codec drift within CODEC_TOL of the JAX
  drift, the controller's three options equal with delay and energy within
  TRAIN_RTOL;
- adaptive_split_video at 6 frames: the interference trace bitwise, and
  each frame's option, raw bytes, rate and times equal, compressed bytes
  within COMP_RTOL (``tests/test_torch_pipeline.py``'s executed run);
- cell_video at 2 UEs and 3 frames, lock-step at a fixed split and three
  event-engine runs (EDF, mobility under PF, chaos with a trace): held as
  ``tests/test_torch_cell.py`` holds its executed runs, the trace's span
  names and counts equal to the JAX export's, and the argument errors the
  JAX example's;
- split_serve_lm and train_lm run their CLIs in subprocesses: both exit 0,
  the served logits are finite, no kernel is launched on the CPU, and the
  restart resumes at step 100 from the first run's checkpoint, bitwise the
  same restart in this process.

Every entry point raises without a card unless given ``--device cpu``.
"""
import collections
import importlib.util
import json
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.swin_t_detection import reduced as jreduced
from repro.core import adaptive as JA
from repro.core import calibration as JC
from repro.core import channel as JCH
from repro.core import throughput as JT
from repro.core.cell import CellSimulator as JCell
from repro.core.cell import cell_interference_traces as j_cell_traces
from repro.core.compression import ActivationCodec as JCodec
from repro.core.pipeline import SplitInferencePipeline as JPipeline
from repro.core.pipeline import build_controller as j_build_controller
from repro.core.splitting import SwinSplitPlan as JPlan
from repro.data.video import SyntheticVideo as JVideo, VideoConfig as JVideoConfig
from repro.models import swin as JSW
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import store as CK
from repro_torch.core import calibration as C
from repro_torch.examples import ROOT
from repro_torch.examples import adaptive_split_video as ASV
from repro_torch.examples import cell_video as CV
from repro_torch.examples import quickstart as QS
from repro_torch.examples import split_serve_lm as SSL
from repro_torch.examples import train_lm as TLM
from repro_torch.launch import train as TR
from repro_torch.tree import tree_leaves

from test_torch_cell import CACHE, CODEC_TOL, _assert_executed_match
from test_torch_pipeline import COMP_RTOL, TRAIN_RTOL

CPU = ["--reduced", "--device", "cpu"]
TIMEOUT_S = 300.0


@pytest.fixture(scope="module")
def systems(tmp_path_factory):
    path = tmp_path_factory.mktemp("calib") / "cache.json"
    path.write_text(json.dumps(CACHE))
    return (C.calibrate(cache_path=str(path), device="cpu"),
            JC.calibrate(cache_path=str(path)))


@pytest.fixture(scope="module")
def jparams():
    """The JAX examples' weights (their init, jitted), as numpy."""
    init = jax.jit(lambda key: JSW.init(jreduced(), key))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def port_inputs(systems, jparams):
    """What the port's examples take in place of their own weights,
    calibration and estimator init: the JAX package's."""
    init = JT.ThroughputEstimator(mode="kpm+spec").init(jax.random.PRNGKey(0))
    return dict(params=params_from_numpy(jparams, "cpu"), system=systems[0],
                estimator_init=params_from_numpy(
                    jax.tree.map(np.asarray, init.params), "cpu"))


def _jax_setup(jparams, frames, seed=None):
    cfg = jreduced()
    kw = {} if seed is None else {"seed": seed}
    video = JVideo(JVideoConfig(h=cfg.img_h, w=cfg.img_w, **kw))
    imgs = [jnp.asarray(video.frame(t)[0])[None] for t in range(frames)]
    return cfg, jax.tree.map(jnp.asarray, jparams), imgs


def _jax_controller(jsys, estimator, **objective):
    return JA.AdaptiveController(
        system=jsys, estimator=estimator, objective=JA.Objective(**objective),
        path=JCH.dupf_path(), privacy_profile=dict(JA.DEFAULT_PRIVACY_PROFILE))


# -- quickstart ------------------------------------------------------------------

def test_quickstart_matches_the_jax_example(systems, jparams, port_inputs):
    res = QS.run(QS.parse_args(CPU), **port_inputs)
    # examples/quickstart.py's calls
    jsys = systems[1]
    cfg, params, (img,) = _jax_setup(jparams, 1)
    plan = JPlan(cfg, params)
    full = JSW.forward_full(cfg, params, img)
    payload, _ = plan.head(img, "split2")
    leaves = jax.tree.leaves(payload)
    codec = JCodec()
    comp = codec.compress(payload)
    out = plan.tail(codec.decompress(comp), "split2")
    drift = np.abs(np.asarray(out[0]["cls"]) - np.asarray(full[0]["cls"])).mean()
    est = JT.train_estimator(jsys.channel, "kpm+spec", n_train=800, steps=150)
    ctrl = _jax_controller(jsys, est, w_delay=1.0, w_energy=0.2, w_privacy=0.1)
    rng = np.random.default_rng(0)
    decisions = []
    for lvl in QS.LEVELS:
        ctrl.interference_db = lvl
        decisions.append(ctrl.decide(JCH.observe_kpms(lvl, False, rng),
                                     JCH.iq_spectrogram(lvl, False, rng),
                                     plan.options))

    assert QS.LEVELS == (-40, -20, -5)
    assert res["n_tensors"] == len(leaves)
    assert res["raw_bytes"] == sum(x.size * x.dtype.itemsize for x in leaves)
    np.testing.assert_allclose(res["compressed_bytes"], comp.compressed_bytes,
                               rtol=COMP_RTOL)
    assert abs(res["drift"] - drift) <= CODEC_TOL
    for d, jd in zip(res["decisions"], decisions):
        assert d.option == jd.option
        np.testing.assert_allclose(d.delay_s, jd.delay_s, rtol=TRAIN_RTOL)
        np.testing.assert_allclose(d.energy_j, jd.energy_j, rtol=TRAIN_RTOL)
        assert d.privacy == jd.privacy


# -- adaptive_split_video ------------------------------------------------------------

def test_adaptive_split_video_matches_the_jax_example(systems, jparams,
                                                      port_inputs):
    frames = 6
    res = ASV.run(ASV.parse_args(CPU + ["--frames", str(frames)]),
                  **port_inputs)
    # examples/adaptive_split_video.py's calls
    jsys = systems[1]
    cfg, params, imgs = _jax_setup(jparams, frames, seed=0)
    est = JT.train_estimator(jsys.channel, "kpm+spec", n_train=1500, steps=250)
    pipe = JPipeline(
        plan=JPlan(cfg, params), system=jsys, codec=JCodec(),
        controller=_jax_controller(jsys, est, w_delay=1.0, w_energy=0.15,
                                   w_privacy=0.05),
        path=JCH.dupf_path(), narrowband=False, execute_model=True, seed=0)
    t = np.linspace(0, 1, frames)
    trace = -40 + 35 * np.exp(-((t - 0.55) / 0.18) ** 2)
    jlogs = [pipe.run_frame(img, float(lvl)) for img, lvl in zip(imgs, trace)]

    assert res["trace"].tobytes() == trace.tobytes()
    logs = res["logs"]
    assert [l.option for l in logs] == [l.option for l in jlogs]
    for log, jlog in zip(logs, jlogs):
        for name in ("raw_bytes", "rate_bps", "head_s", "tail_s", "path_s",
                     "interference_db"):
            assert getattr(log, name) == getattr(jlog, name), name
        np.testing.assert_allclose(log.compressed_bytes, jlog.compressed_bytes,
                                   rtol=COMP_RTOL)
        assert np.isfinite(log.delay_s) and log.quant_s >= 0.0


# -- cell_video ---------------------------------------------------------------------------

CELL_RUNS = {
    "lockstep_fixed": ["--fixed", "split2"],
    "edf_stream": ["--policy", "edf", "--fps", "0.5", "--jitter", "0.05",
                   "--inflight", "2"],
    "mobility_pf": ["--mobility", "--policy", "pf", "--fps", "0.5"],
    "chaos_trace": ["--chaos", "--fps", "0.5"],
}


def _jax_cell_run(args, jparams, jsys):
    """examples/cell_video.py's cell on the same arguments, and its
    telemetry (written to ``args.trace`` + ".jax" where asked)."""
    from repro.core.mobility import (MobilityConfig, MobilityModel,
                                     WaypointTrajectory, two_cell_sites)
    from repro.core.ran import MultiCell, RanCell, RanConfig, make_policy
    from repro.core.telemetry import Telemetry
    from repro.core.trace_export import write_chrome_trace
    cfg, params, imgs = _jax_setup(jparams, args.frames + args.ues, seed=0)
    controller = None
    if args.fixed is None:
        controller = j_build_controller(
            jsys, objective=JA.Objective(w_delay=1.0, w_energy=0.15,
                                         w_privacy=0.05))
    mobility = None
    if args.mobility:
        mobility = MobilityModel(
            two_cell_sites(400.0),
            [WaypointTrajectory(((30.0 + 40.0 * u, 0.0), (370.0, 0.0)),
                                speed_mps=args.speed, loop=True)
             for u in range(args.ues)],
            MobilityConfig(a3_ttt_s=2.0, relocation_gap_s=0.2))
    ran = None
    if args.policy is not None:
        if args.mobility:
            ran = MultiCell([RanCell(policy=make_policy(args.policy),
                                     cfg=RanConfig(tti_s=0.002))
                             for _ in range(2)])
        else:
            ran = RanCell(policy=make_policy(args.policy),
                          cfg=RanConfig(tti_s=0.002))
    chaos = None
    if args.chaos:
        from repro.core.chaos import (ChaosConfig, ChaosModel, ChurnSpec,
                                      OutageSpec)
        horizon = args.frames / args.fps
        chaos = ChaosModel(ChaosConfig(
            edge_outage=OutageSpec(
                schedule=((0.20 * horizon, 0.10 * horizon),)),
            edge_policy="drop",
            upf_outage=OutageSpec(
                schedule=((0.45 * horizon, 0.15 * horizon),)),
            failover=True, failover_path=JCH.cupf_path(),
            blackout=OutageSpec(
                schedule=((0.75 * horizon, 0.08 * horizon),)),
            blackout_ues=(0,),
            churn=ChurnSpec(initial_p=1.0, mean_on_s=0.5 * horizon,
                            mean_off_s=0.15 * horizon),
            heartbeat_period_s=0.01 * horizon,
            heartbeat_timeout_s=0.025 * horizon))
    telemetry = Telemetry() if args.trace is not None else None
    cell = JCell(
        plan=JPlan(cfg, params), system=jsys, codec=JCodec(),
        controller=controller, n_ues=args.ues, seed=0, execute_model=True,
        batching=not args.no_batching, max_wait_s=30.0, ran=ran,
        frame_budget_s=args.budget, mobility=mobility, chaos=chaos,
        telemetry=telemetry)
    trace = j_cell_traces(args.frames, args.ues, seed=1)
    if args.fps is not None:
        res = cell.run_stream(trace, imgs=imgs, option=args.fixed,
                              fps=args.fps, jitter_s=args.jitter,
                              inflight=args.inflight, keep_outputs=True)
    else:
        res = cell.run(trace, imgs=imgs, option=args.fixed, keep_outputs=True)
    if telemetry is not None:
        write_chrome_trace(telemetry, args.trace + ".jax")
    return res, telemetry


def _span_counts(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return collections.Counter(e["name"] for e in events if e["ph"] == "X")


@pytest.mark.parametrize("run", sorted(CELL_RUNS))
def test_cell_video_matches_the_jax_example(systems, jparams, port_inputs,
                                            tmp_path, capsys, run):
    argv = CPU + ["--ues", "2", "--frames", "3"] + CELL_RUNS[run]
    if run == "chaos_trace":
        argv += ["--trace", str(tmp_path / "cell.json")]
    args = CV.parse_args(argv)
    out = CV.run(args, **port_inputs)
    jres, jtele = _jax_cell_run(args, jparams, systems[1])
    _assert_executed_match(out["res"], jres)
    CV.report(args, out)
    printed = capsys.readouterr().out
    assert "mean E2E delay over the cell" in printed
    if args.trace is not None:
        tele = out["telemetry"]
        assert (len(tele.spans), len(tele.instants)) == (len(jtele.spans),
                                                         len(jtele.instants))
        counts = _span_counts(args.trace)
        assert counts and counts == _span_counts(args.trace + ".jax")
        assert "missed/lost frames" in printed
        assert out["res"].recovery and len(out["res"].recovery) == len(jres.recovery)


def _load_jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("flag", ["--mobility", "--chaos"])
def test_cell_video_argument_errors_are_the_jax_examples(flag, capsys,
                                                         monkeypatch):
    with pytest.raises(SystemExit) as port:
        CV.parse_args([flag])
    port_err = capsys.readouterr().err.strip().splitlines()[-1]
    monkeypatch.setattr(sys, "argv", ["cell_video.py", flag])
    with pytest.raises(SystemExit) as ref:
        _load_jax_example("cell_video").main()
    ref_err = capsys.readouterr().err.strip().splitlines()[-1]
    assert port.value.code == ref.value.code == 2
    assert port_err.split(" error: ")[1] == ref_err.split(" error: ")[1]


# -- the LM examples ---------------------------------------------------------------------

def test_split_serve_lm_serves_both_archs(tmp_path):
    out = SSL.run(SSL.parse_args(CPU), status_dir=str(tmp_path),
                  timeout=TIMEOUT_S)
    assert list(out) == ["qwen3-1.7b", "hymba-1.5b"]
    for arch, got in out.items():
        counters = got["status"]["metrics"]["counters"]
        assert counters["nonfinite_logits_total"] == 0, arch
        assert (counters["boundary_raw_bytes_total"]
                > counters["boundary_compressed_bytes_total"] > 0), arch
        assert counters["tokens_generated_total"] == 2 * 8, arch
        assert got["status"]["launches"] == {}, arch    # plain versions
        assert "split at layer" in got["stdout"], arch


def test_train_lm_resumes_from_the_first_runs_checkpoint(tmp_path,
                                                         monkeypatch):
    # one thread in the trainers here and in this process: the CPU's
    # threaded reductions of a step are not bitwise run to run
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    # the example's two trainer runs, with the checkpoints the first left
    # copied at the failure (the restart's retention removes step 100's)
    snap, ck = tmp_path / "at_failure", str(tmp_path / "ck")
    args = TLM.parse_args(CPU)
    first = TLM.train(args, ck, "--steps", "100", timeout=TIMEOUT_S)
    shutil.copytree(ck, snap)
    out = TLM.result(first, TLM.train(args, ck, "--steps", "200", "--resume",
                                      timeout=TIMEOUT_S), ck)
    assert sorted(out["first_losses"]) == [0, 20, 40, 60, 80, 99]
    assert out["resumed_from"] == 100
    assert sorted(out["resumed_losses"]) == [100, 120, 140, 160, 180, 199]
    assert out["checkpoints"] == ["step_00000120", "step_00000160",
                                  "step_00000200"]
    assert CK.latest_step(str(snap)) == 100
    assert np.isfinite(out["resumed_losses"][199])
    assert out["resumed_losses"][199] < out["first_losses"][0]
    assert out["launches"] == {}        # the CPU runs the plain versions
    # the same restart in this process from the checkpoint the first run
    # left: the subprocess restored it bitwise, so it ends bitwise the same
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        replay = TR.main(TLM.argv(args, str(snap)) + ["--steps", "200",
                                                      "--resume"])
    finally:
        torch.set_num_threads(threads)
    assert replay["steps"][0]["step"] == 100
    for m in replay["steps"]:
        if m["step"] in out["resumed_losses"]:
            assert f"{m['loss']:.4f}" == f"{out['resumed_losses'][m['step']]:.4f}"
    like = (replay["params"], replay["opt_state"])
    saved = CK.restore(out["ckpt"], 200, like, torch.device("cpu"))
    for a, b in zip(tree_leaves(saved), tree_leaves(like)):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b


# -- without a card ------------------------------------------------------------------------

def test_entry_points_raise_without_a_card(monkeypatch, tmp_path, capfd):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod, argv in ((QS, []), (ASV, ["--frames", "1"]),
                      (CV, ["--ues", "1", "--frames", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.main(["--reduced"] + argv)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    with pytest.raises(subprocess.CalledProcessError):
        SSL.main(["--reduced"])
    assert "device='cpu'" in capfd.readouterr().err
    with pytest.raises(subprocess.CalledProcessError):
        TLM.run(TLM.parse_args(["--reduced"]), ckpt=str(tmp_path / "ck"),
                timeout=TIMEOUT_S)
    assert "device='cpu'" in capfd.readouterr().err
