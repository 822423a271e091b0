"""The port's multi-UE cell, event engine, MAC, mobility and chaos against
the JAX package's, live, on the same seeds and the same cache table.

- Accounting runs (``execute_model=False``) are numpy on both sides, so
  they are held field-exact: every ``FrameLog`` field (the ``Prediction`` by
  all of its fields), ``CellStats``, ``RecoveryMetrics``, the per-UE wall
  energy and the Perfetto/JSONL export of an attached ``Telemetry``.  The
  scenarios are those of ``tests/test_goldens.py``, run against the live
  reference rather than its committed fixtures, whose payload bytes predate
  the current calibration.
- The MAC's grants under rr/pf/edf, mobility's handover events and the
  heartbeat/straggler detectors are compared call by call.
- Executed runs at the reduced Swin-T size on the JAX package's weights
  (bridged with ``params_from_numpy``): the same options and raw bytes per
  UE-frame, the same compressed bytes, and detections within
  ``tests/test_torch_split.py``'s CODEC_TOL of the largest |value| (int8
  grid points of head activations that differ by float rounding).
"""
import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.swin_t_detection import CONFIG as JCONFIG, reduced as jreduced
from repro.core import adaptive as JA
from repro.core import calibration as JC
from repro.core import cell as JCELL
from repro.core import chaos as JCHAOS
from repro.core import channel as JCH
from repro.core import mobility as JMOB
from repro.core import ran as JRAN
from repro.core import telemetry as JTEL
from repro.core import trace_export as JEXP
from repro.core.compression import ActivationCodec as JCodec
from repro.core.pipeline import SplitInferencePipeline as JPipeline
from repro.core.splitting import SwinSplitPlan as JPlan
from repro.data.video import SyntheticVideo as JVideo, VideoConfig as JVideoConfig
from repro.models import swin as JSW
from repro.runtime import failures as JFAIL
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.swin_t_detection import CONFIG, reduced
from repro_torch.core import adaptive as A
from repro_torch.core import calibration as C
from repro_torch.core import cell as CELL
from repro_torch.core import chaos as CHAOS
from repro_torch.core import channel as CH
from repro_torch.core import mobility as MOB
from repro_torch.core import ran as RAN
from repro_torch.core.ran_vec import VecRanCell
from repro_torch.core import telemetry as TEL
from repro_torch.core import trace_export as EXP
from repro_torch.core.compression import ActivationCodec
from repro_torch.core.pipeline import FrameLog, SplitInferencePipeline
from repro_torch.core.splitting import SwinSplitPlan
from repro_torch.runtime import failures as FAIL
from repro_torch.tree import tree_flatten

CODEC_TOL = 2e-3           # tests/test_torch_split.py: detections via int8

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
LOG_FIELDS = [f.name for f in dataclasses.fields(FrameLog)]


@pytest.fixture(scope="module")
def systems(tmp_path_factory):
    path = tmp_path_factory.mktemp("calib") / "cache.json"
    path.write_text(json.dumps(CACHE))
    return (C.calibrate(cache_path=str(path), device="cpu"),
            JC.calibrate(cache_path=str(path)))


PORT = types.SimpleNamespace(
    A=A, CELL=CELL, CHAOS=CHAOS, CH=CH, MOB=MOB, RAN=RAN, TEL=TEL, EXP=EXP,
    FAIL=FAIL, cfg=CONFIG, kw={"device": "cpu"},
    plan=lambda cfg, params=None: SwinSplitPlan(cfg, params, device="cpu"))
REF = types.SimpleNamespace(
    A=JA, CELL=JCELL, CHAOS=JCHAOS, CH=JCH, MOB=JMOB, RAN=JRAN, TEL=JTEL,
    EXP=JEXP, FAIL=JFAIL, cfg=JCONFIG, kw={},
    plan=lambda cfg, params=None: JPlan(cfg, params))


def _sides(systems):
    """(namespace, calibrated system) for the port, then the reference."""
    return (PORT, systems[0]), (REF, systems[1])


# -- the golden scenarios (tests/test_goldens.py), on either package ---------

class KpmTableEstimator:
    """tests/test_goldens.py's deterministic estimator: invert the KPM
    generator's SINR line to an interference level and read the mean rate
    from the calibrated table."""

    def __init__(self, channel):
        self.channel = channel

    def predict(self, kpm, spec):
        eff = (kpm.sinr_db - 22.0) / 0.45
        return float(self.channel.mean_rate(float(np.clip(eff, -40.0, -5.0))))


def _controller(ns, system, **objective):
    objective = objective or dict(w_delay=1.0, w_energy=0.5, w_privacy=2.5)
    return ns.A.AdaptiveController(
        system=system, estimator=KpmTableEstimator(system.channel),
        objective=ns.A.Objective(**objective), path=ns.CH.dupf_path(),
        privacy_profile=dict(ns.A.DEFAULT_PRIVACY_PROFILE))


def _trace():
    return np.array([[-40.0, -30.0, -20.0],
                     [-20.0, -10.0, -5.0],
                     [-5.0, -20.0, -40.0],
                     [-30.0, -40.0, -10.0]])


def _edf(ns):
    return ns.RAN.RanCell(policy=ns.RAN.make_policy("edf"),
                          cfg=ns.RAN.RanConfig(tti_s=0.005))


def legacy_lockstep(ns, system, telemetry=None):
    sim = ns.CELL.CellSimulator(
        plan=ns.plan(ns.cfg), system=system, n_ues=3, seed=11,
        execute_model=False, controller=_controller(ns, system),
        telemetry=telemetry, **ns.kw)
    return sim.run(_trace())


def ran_streaming(ns, system, telemetry=None):
    sim = ns.CELL.CellSimulator(
        plan=ns.plan(ns.cfg), system=system, n_ues=3, seed=11,
        execute_model=False, frame_budget_s=3.0, ran=_edf(ns),
        telemetry=telemetry, **ns.kw)
    return sim.run_stream(_trace(), option="split3", fps=0.4, jitter_s=0.05,
                          inflight=2)


def chaos_outage(ns, system, telemetry=None):
    X = ns.CHAOS
    chaos = X.ChaosModel(X.ChaosConfig(
        edge_outage=X.OutageSpec(schedule=((4.0, 2.0),)), edge_policy="drop",
        upf_outage=X.OutageSpec(schedule=((10.0, 3.0),)),
        failover=True, failover_path=ns.CH.cupf_path(),
        blackout=X.OutageSpec(schedule=((16.0, 1.5),)), blackout_ues=(0,),
        churn=X.ChurnSpec(initial_p=1.0, mean_on_s=9.0, mean_off_s=3.0),
        heartbeat_period_s=0.25, heartbeat_timeout_s=0.6))
    sim = ns.CELL.CellSimulator(
        plan=ns.plan(ns.cfg), system=system, n_ues=3, seed=11,
        execute_model=False, frame_budget_s=3.0,
        controller=_controller(ns, system), ran=_edf(ns), chaos=chaos,
        telemetry=telemetry, **ns.kw)
    return sim.run_stream(np.tile(_trace(), (2, 1)), option=None, fps=0.4,
                          jitter_s=0.05, inflight=2)


def chaos_correlated(ns, system, telemetry=None):
    X, M = ns.CHAOS, ns.MOB
    sites = M.two_cell_sites(400.0)
    traj = [M.StaticTrajectory(150.0, 0.0), M.StaticTrajectory(250.0, 0.0),
            M.StaticTrajectory(30.0, 0.0)]
    mob = M.MobilityModel(sites, traj,
                          M.MobilityConfig(a3_ttt_s=0.5, relocation_gap_s=0.05))
    chaos = X.ChaosModel(X.ChaosConfig(
        upf_outage=X.OutageSpec(schedule=((10.0, 3.0),)),
        churn=X.ChurnSpec(initial_p=0.6, mean_on_s=9.0, mean_off_s=6.0),
        correlation=X.CorrelationSpec(
            site_power=((4.0, 2.0),), weather_front=((15.0, 2.0),),
            front_offset_s=1.5, surge_boost=6.0, surge_duration_s=3.0),
        heartbeat_period_s=0.25, heartbeat_timeout_s=0.6))
    sim = ns.CELL.CellSimulator(
        plan=ns.plan(ns.cfg), system=system, n_ues=3, seed=11,
        execute_model=False, frame_budget_s=3.0,
        controller=_controller(ns, system),
        ran=ns.RAN.MultiCell([_edf(ns) for _ in sites]), mobility=mob,
        chaos=chaos, telemetry=telemetry, **ns.kw)
    return sim.run_stream(np.tile(_trace(), (2, 1)), option=None, fps=0.4,
                          jitter_s=0.05, inflight=2)


SCENARIOS = {"legacy_lockstep": legacy_lockstep,
             "ran_streaming": ran_streaming, "chaos_outage": chaos_outage,
             "chaos_correlated": chaos_correlated}


def _same(a, b) -> bool:
    """Equality that walks dicts, lists and tuples and takes NaN as equal to
    NaN (``RecoveryMetrics`` of a window that never cleared)."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, float) and isinstance(b, float) and a != a:
        return b != b
    return bool(a == b)


def _assert_logs_equal(logs, jlogs):
    assert len(logs) == len(jlogs) > 0
    for log, jlog in zip(logs, jlogs):
        for name in LOG_FIELDS:
            a, b = getattr(log, name), getattr(jlog, name)
            if name == "predicted":
                assert (a is None) == (b is None)
                if a is not None:
                    assert _same(dataclasses.asdict(a), dataclasses.asdict(b))
            else:
                assert _same(a, b), (name, a, b)


def _assert_results_equal(res, jres):
    _assert_logs_equal(res.logs, jres.logs)
    assert _same(dataclasses.asdict(res.stats), dataclasses.asdict(jres.stats))
    assert _same(res.ue_wall_energy_j, jres.ue_wall_energy_j)
    assert (res.recovery is None) == (jres.recovery is None)
    if res.recovery is not None:
        assert _same([dataclasses.asdict(r) for r in res.recovery],
                     [dataclasses.asdict(r) for r in jres.recovery])


def _exports(ns, tele, tmp_path, tag):
    """The chrome trace as written, the JSONL lines as written, and the
    registry snapshot."""
    trace = tmp_path / f"{tag}.json"
    lines = tmp_path / f"{tag}.jsonl"
    ns.EXP.write_chrome_trace(tele, str(trace))
    ns.EXP.write_jsonl(tele, str(lines))
    assert ns.EXP.validate_chrome_trace(ns.EXP.chrome_trace(tele)) == []
    return (trace.read_text(), lines.read_text(),
            json.dumps(tele.registry.snapshot(), sort_keys=True))


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_golden_scenario_is_field_exact(systems, scenario):
    (p, sysm), (r, jsys) = _sides(systems)
    res = SCENARIOS[scenario](p, sysm)
    jres = SCENARIOS[scenario](r, jsys)
    _assert_results_equal(res, jres)
    if scenario != "legacy_lockstep":
        assert res.stats.n_completed > 0


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_golden_scenario_telemetry_export_is_exact(systems, scenario,
                                                   tmp_path):
    (p, sysm), (r, jsys) = _sides(systems)
    tele, jtele = p.TEL.Telemetry(), r.TEL.Telemetry()
    res = SCENARIOS[scenario](p, sysm, telemetry=tele)
    jres = SCENARIOS[scenario](r, jsys, telemetry=jtele)
    _assert_results_equal(res, jres)
    # attaching a recorder changes nothing
    _assert_results_equal(SCENARIOS[scenario](p, sysm), res)
    assert tele.spans
    assert (_exports(p, tele, tmp_path, "port")
            == _exports(r, jtele, tmp_path, "ref"))


# -- the MAC -------------------------------------------------------------------------

def _requests(ns, seed, t0=0.0):
    rng = np.random.default_rng(seed)
    n = 6
    sizes = rng.integers(50_000, 2_000_000, n)
    rates = rng.uniform(2e7, 2e8, n)
    enq = rng.uniform(0.0, 0.05, n)
    dead = rng.uniform(0.2, 1.5, n)
    return [ns.RAN.UplinkRequest(ue_id=i, n_bytes=int(sizes[i]),
                                 enqueue_s=t0 + float(enq[i]),
                                 deadline_s=float(dead[i]),
                                 link_rate_bps=float(rates[i]))
            for i in range(n)]


@pytest.mark.parametrize("policy", ["rr", "pf", "edf"])
def test_ran_cell_grants_are_exact(policy):
    out = []
    for ns in (PORT, REF):
        cell = ns.RAN.RanCell(policy=ns.RAN.make_policy(policy),
                              cfg=ns.RAN.RanConfig(tti_s=0.002),
                              record_trace=True)
        cell.reset(6)
        hr = np.random.default_rng(3)
        slots = []
        for seed in (1, 2):
            reps = cell.serve_slot(_requests(ns, seed), hr)
            slots.append(({u: dataclasses.asdict(rep) for u, rep in reps.items()},
                          cell.grant_trace))
        out.append(slots)
    assert _same(out[0], out[1])
    assert out[0][0][1]                 # the trace was recorded


@pytest.mark.parametrize("policy", ["rr", "pf", "edf"])
def test_ran_stream_reports_are_exact(policy):
    out = []
    for ns in (PORT, REF):
        cell = ns.RAN.RanCell(policy=ns.RAN.make_policy(policy),
                              cfg=ns.RAN.RanConfig(tti_s=0.002))
        cell.reset(6)
        strm = ns.RAN.RanStream(cell)
        hr = np.random.default_rng(4)
        got = []
        for cohort, seed in enumerate((5, 6)):
            for req in _requests(ns, seed, t0=0.03 * cohort):
                strm.enqueue(req, cohort)
            for f in strm.advance(0.03 * (cohort + 1), hr):
                got.append(dataclasses.asdict(strm.report(f)))
            got.append(strm.telemetry_sample())
        got += [dataclasses.asdict(strm.report(f))
                for f in strm.advance(float("inf"), hr)]
        out.append(got)
    assert _same(out[0], out[1])
    assert len(out[0]) == 12 + 2


# -- mobility, chaos primitives ----------------------------------------------------

def test_mobility_handovers_are_exact(systems):
    out = []
    for ns, system in _sides(systems):
        M = ns.MOB
        sites = M.two_cell_sites(400.0)
        traj = [M.WaypointTrajectory(((0.0, 0.0), (400.0, 0.0)), 30.0,
                                     loop=True),
                M.StaticTrajectory(100.0, 20.0),
                M.WaypointTrajectory(((380.0, 10.0), (20.0, -10.0)), 25.0)]
        mob = M.MobilityModel(sites, traj, M.MobilityConfig(
            shadow_sigma_db=4.0, doppler_sigma_db=2.0, a3_ttt_s=0.3))
        mob.reset(3, np.random.default_rng(9), system.channel)
        obs = []
        for t in np.arange(0.0, 40.0, 0.25):
            for u in range(3):
                o = mob.observe(u, float(t))
                obs.append(dataclasses.asdict(o))
        out.append((obs, mob.handover_count.tolist(), mob.telemetry_sample()))
    assert _same(out[0], out[1])
    assert sum(out[0][1]) >= 2          # handovers did happen


def test_heartbeat_and_straggler_monitors_are_exact():
    out = []
    for ns in (PORT, REF):
        F = ns.FAIL
        hb = F.HeartbeatMonitor(4, timeout_s=1.0, strict_clock=True)
        sg = F.StragglerMonitor(4, factor=2.0)
        rng = np.random.default_rng(12)
        seen = []
        for step in range(40):
            t = 0.25 * step
            for w in range(4):
                if not (w == 2 and 3.0 < t < 6.0) and rng.random() < 0.9:
                    hb.beat(w, now=t)
                sg.record(w, float(rng.gamma(2.0, 0.1)) * (3.0 if w == 1 else 1.0))
            dec = F.decide_recovery(hb, sg, 8, 2, 100 + step, now=t)
            seen.append((hb.dead(now=t), hb.alive(now=t), sg.stragglers(),
                         sg.medians(), dataclasses.asdict(dec)))
        with pytest.raises(ValueError, match="strict_clock"):
            hb.dead()
        out.append(seen)
    assert _same(out[0], out[1])
    assert any(s[0] for s in out[0]) and any(s[2] for s in out[0])


def test_vectorized_engine_raises_naming_a7(systems):
    """A7, the vectorized MAC, is ported, so ``engine="vectorized"`` no
    longer raises: the lock-step engine drives a ``VecRanCell`` on the
    simulator's device, ``run_stream`` one ``VecRanStream`` per cell, with
    the python engine's results.  What still raises is a scheduler the
    vectorized MAC cannot replicate (tests/test_torch_engine_vec.py holds
    the engines against the JAX package's).  The name dates from when the
    engine raised naming ROADMAP item A7; it is kept so that the test's
    history stays one line across runs."""
    sysm = systems[0]
    plan = PORT.plan(CONFIG)
    sim = CELL.CellSimulator(plan=plan, system=sysm, n_ues=2, ran=_edf(PORT),
                             engine="vectorized", device="cpu")
    assert isinstance(sim._mac, VecRanCell) and sim._mac.device.type == "cpu"

    def run(engine):
        sim = CELL.CellSimulator(
            plan=plan, system=sysm, n_ues=2,
            ran=RAN.MultiCell([_edf(PORT), _edf(PORT)]),
            mobility=MOB.MobilityModel(MOB.two_cell_sites(),
                                       [MOB.StaticTrajectory(50.0, 0.0)]),
            engine=engine, device="cpu")
        return sim.run_stream(_trace()[:, :2], option="split2")
    _assert_results_equal(run("vectorized"), run("python"))

    class Mine(RAN.DeadlineEDFScheduler):
        pass
    with pytest.raises(ValueError, match="stock rr/pf/edf"):
        CELL.CellSimulator(plan=plan, system=sysm, n_ues=2,
                           ran=RAN.RanCell(policy=Mine()),
                           engine="vectorized", device="cpu")


def test_cell_defaults_to_the_card(systems, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CELL.CellSimulator(plan=PORT.plan(CONFIG), system=systems[0], n_ues=2)


# -- the single-UE pipeline's event-engine and telemetry entries --------------

def _pipelines(systems, **kw):
    (p, sysm), (r, jsys) = _sides(systems)
    pipe = SplitInferencePipeline(
        plan=p.plan(CONFIG), system=sysm, codec=ActivationCodec(device="cpu"),
        controller=_controller(p, sysm), execute_model=False, **kw)
    jpipe = JPipeline(plan=r.plan(JCONFIG), system=jsys, codec=JCodec(),
                      controller=_controller(r, jsys), execute_model=False,
                      **kw)
    return pipe, jpipe


@pytest.mark.parametrize("inflight,jitter", [(None, 0.0), (2, 0.08)])
def test_pipeline_run_stream_is_field_exact(systems, inflight, jitter):
    pipe, jpipe = _pipelines(systems, seed=5)
    trace = np.tile(_trace()[:, 0], 3)
    kw = dict(fps=3.0, jitter_s=jitter, inflight=inflight, budget_s=0.8)
    _assert_results_equal(pipe.run_stream(trace, **kw),
                          jpipe.run_stream(trace, **kw))


def test_pipeline_run_trace_with_telemetry_is_field_exact(systems, tmp_path):
    tele, jtele = TEL.Telemetry(), JTEL.Telemetry()
    pipe, jpipe = _pipelines(systems, telemetry=None)
    pipe.telemetry, jpipe.telemetry = tele, jtele
    trace = np.tile(_trace()[:, 1], 2)
    logs, jlogs = pipe.run_trace(None, trace), jpipe.run_trace(None, trace)
    _assert_logs_equal(logs, jlogs)
    assert (_exports(PORT, tele, tmp_path, "port")
            == _exports(REF, jtele, tmp_path, "ref"))


# -- executed runs at the reduced size --------------------------------------------

N_UES = 3


@pytest.fixture(scope="module")
def executed(systems):
    cfg, jcfg = reduced(), jreduced()
    init = jax.jit(lambda key: JSW.init(jcfg, key))
    jparams = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(4)
    for stage in jparams["stages"]:
        for bp in stage["blocks"]:
            bp["rel_bias"] = rng.normal(size=bp["rel_bias"].shape).astype(np.float32)
    video = JVideo(JVideoConfig(h=cfg.img_h, w=cfg.img_w, seed=0))
    imgs = [video.frame(t)[0][None] for t in range(4)]
    plan = SwinSplitPlan(cfg, params_from_numpy(jparams, "cpu"), device="cpu")
    jplan = JPlan(jcfg, jax.tree.map(jnp.asarray, jparams))
    return (plan, [torch.from_numpy(i) for i in imgs],
            jplan, [jnp.asarray(i) for i in imgs])


def _cells(systems, executed, **kw):
    (p, sysm), (r, jsys) = _sides(systems)
    plan, imgs, jplan, jimgs = executed
    ctrl = kw.pop("adaptive", False)
    sim = CELL.CellSimulator(
        plan=plan, system=sysm, n_ues=N_UES, seed=3, execute_model=True,
        controller=_controller(p, sysm) if ctrl else None, device="cpu", **kw)
    jsim = JCELL.CellSimulator(
        plan=jplan, system=jsys, n_ues=N_UES, seed=3, execute_model=True,
        controller=_controller(r, jsys) if ctrl else None, **kw)
    return (sim, imgs), (jsim, jimgs)


def _assert_executed_match(res, jres):
    logs = sorted(res.logs, key=lambda l: (l.frame_idx, l.ue_id))
    jlogs = sorted(jres.logs, key=lambda l: (l.frame_idx, l.ue_id))
    assert [(l.frame_idx, l.ue_id, l.option) for l in logs] \
        == [(l.frame_idx, l.ue_id, l.option) for l in jlogs]
    for log, jlog in zip(logs, jlogs):
        assert (log.raw_bytes, log.compressed_bytes) \
            == (jlog.raw_bytes, jlog.compressed_bytes)
        for name in ("head_s", "tail_s", "batch_size", "interference_db"):
            assert getattr(log, name) == getattr(jlog, name), name
        assert np.isfinite(log.delay_s) and log.quant_s >= 0.0
    n = 0
    for slot, jslot in zip(res.outputs, jres.outputs):
        assert sorted(slot) == sorted(jslot)
        for u in slot:
            leaves, jleaves = tree_flatten(slot[u])[0], jax.tree.leaves(jslot[u])
            assert len(leaves) == len(jleaves) > 0
            for a, b in zip(leaves, jleaves):
                b = np.asarray(b)
                assert tuple(a.shape) == b.shape and torch.isfinite(a).all()
                scale = max(1.0, float(np.abs(b).max()))
                assert float(np.abs(a.numpy() - b).max()) <= CODEC_TOL * scale
                n += 1
    assert n


def test_executed_lockstep_fixed_split_matches(systems, executed):
    (sim, imgs), (jsim, jimgs) = _cells(systems, executed)
    trace = _trace()[:2]
    res = sim.run(trace, imgs=imgs, option="split2", keep_outputs=True)
    jres = jsim.run(trace, imgs=jimgs, option="split2", keep_outputs=True)
    _assert_executed_match(res, jres)
    assert res.stats.n_batches == jres.stats.n_batches == 2


def test_executed_lockstep_adaptive_isolated_links_matches(systems, executed):
    (sim, imgs), (jsim, jimgs) = _cells(systems, executed, adaptive=True)
    trace = _trace()[:3]
    res = sim.run(trace, imgs=imgs, keep_outputs=True)
    jres = jsim.run(trace, imgs=jimgs, keep_outputs=True)
    _assert_executed_match(res, jres)
    assert len({l.option for l in res.logs}) > 1      # the cell adapts


def test_executed_run_stream_fixed_option_matches(systems, executed):
    kw = dict(option="split1", fps=0.5, jitter_s=0.05, inflight=2,
              keep_outputs=True)
    trace = _trace()[:2]
    # a first run on throwaway cells compiles the JAX package's jitted
    # encode: its compile time would enter the first UE's host-measured
    # quant_s, move that UE's arrival out of the tail batch and change its
    # batch size (and so tail_s), when no earlier test in the process
    # happened to compile it
    for s, im in _cells(systems, executed, ran=None, frame_budget_s=2.0):
        s.run_stream(trace, imgs=im, **kw)
    (sim, imgs), (jsim, jimgs) = _cells(
        systems, executed, ran=None, frame_budget_s=2.0)
    res = sim.run_stream(trace, imgs=imgs, **kw)
    jres = jsim.run_stream(trace, imgs=jimgs, **kw)
    _assert_executed_match(res, jres)


def test_fused_head_gives_the_group_paths_bytes(systems, executed):
    (sim, imgs), _ = _cells(systems, executed)
    (fsim, _), _ = _cells(systems, executed, fused_head=True)
    trace = _trace()[:2]
    for opt in ("split1", "split3"):
        logs = sim.run(trace, imgs=imgs, option=opt).logs
        flogs = fsim.run(trace, imgs=imgs, option=opt).logs
        assert [(l.raw_bytes, l.compressed_bytes) for l in logs] \
            == [(l.raw_bytes, l.compressed_bytes) for l in flogs]
        assert all(l.compressed_bytes > 0 for l in logs)


@pytest.mark.parametrize("fused_head", [True, False])
def test_pipeline_fused_head_switch_matches(systems, executed, fused_head):
    """``SplitInferencePipeline.fused_head``: head + encode in one pass or
    in two stages, every option, the same bytes as the JAX package's
    pipeline with the same switch; and the one-UE event engine on top."""
    (p, sysm), (r, jsys) = _sides(systems)
    plan, imgs, jplan, jimgs = executed
    pipe = SplitInferencePipeline(plan=plan, system=sysm,
                                  codec=ActivationCodec(device="cpu"),
                                  fused_head=fused_head)
    jpipe = JPipeline(plan=jplan, system=jsys, codec=JCodec(),
                      fused_head=fused_head)
    for i, opt in enumerate(plan.options):
        log = pipe.run_frame(imgs[i % 4], -20.0, opt)
        jlog = jpipe.run_frame(jimgs[i % 4], -20.0, opt)
        assert (log.option, log.raw_bytes, log.compressed_bytes) \
            == (jlog.option, jlog.raw_bytes, jlog.compressed_bytes)
    trace = _trace()[:2, 0]
    res = pipe.run_stream(trace, imgs=imgs, option="split3", fps=1.0)
    jres = jpipe.run_stream(trace, imgs=jimgs, option="split3", fps=1.0)
    assert [(l.raw_bytes, l.compressed_bytes) for l in res.logs] \
        == [(l.raw_bytes, l.compressed_bytes) for l in jres.logs]
    assert all(l.compressed_bytes > 0 for l in res.logs)
