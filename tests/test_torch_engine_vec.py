"""``engine="vectorized"`` of the port (``repro_torch.core.engine_vec`` and
the cell / event engine that drive ``core/ran_vec.py``) on the CPU, against
its own python engine and the JAX package's vectorized engine, live.

- ``MultiCellVecMac`` per policy against each oracle cell and the JAX
  package's ``MultiCellVecMac``: reports bit for bit, tapes and
  Generators paired; ``synthetic_city``'s partition and arrays.
- The port's ``CellSimulator(engine="vectorized")``: lock-step (rr / pf /
  edf, adaptive on and off), ``run_stream`` per policy, the two-cell
  mobility handover of ``tests/test_engine_vec.py`` and the golden
  scenarios of ``tests/test_torch_cell.py`` (chaos blackouts through the
  batched park/adopt) against the port's python engine and the JAX
  package's vectorized engine, every ``FrameLog`` and ``CellStats`` field.

The JAX package's vectorized MAC needs the ``enable_x64`` shim of
``tests/test_torch_ran_vec.py``; its fixture ``jax_x64`` applies it per
test.
"""
import types

import numpy as np
import pytest

from repro.core import engine_vec as JE
from repro.core import ran as JR
from repro_torch.core import engine_vec as E
from repro_torch.core import ran as RAN

from test_torch_cell import (PORT, SCENARIOS, _assert_results_equal,
                             _controller, _exports, _same, _sides, _trace,
                             systems)
from test_torch_ran_vec import _bits, jax_x64

POLICIES = ("rr", "pf", "edf")


def _vectorized(ns):
    """``ns`` with ``engine="vectorized"`` passed to every CellSimulator."""
    return types.SimpleNamespace(**dict(vars(ns), kw=dict(
        ns.kw, engine="vectorized")))


# -- many cells at once ---------------------------------------------------------------

@pytest.mark.parametrize("pol", POLICIES)
def test_multicell_vec_mac_equality(jax_x64, pol):
    """One batched step per TTI over every cell: per-cell reports equal
    each oracle cell served with its own paired generator, and the JAX
    package's ``MultiCellVecMac``; tapes and Generators stay paired."""
    for trial in range(3):
        rng = np.random.default_rng(100 * trial + 7)
        C = int(rng.integers(1, 4))
        cfg_kw = dict(n_prbs=int(rng.integers(8, 40)),
                      tti_s=float(rng.choice([1e-3, 2e-3])))
        cells = [JR.RanCell(policy=JR.make_policy(pol),
                            cfg=JR.RanConfig(**cfg_kw)) for _ in range(C)]
        mac = E.MultiCellVecMac(RAN.MultiCell(
            [RAN.RanCell(policy=RAN.make_policy(pol),
                         cfg=RAN.RanConfig(**cfg_kw)) for _ in range(C)]),
            device="cpu")
        jmac = JE.MultiCellVecMac(JR.MultiCell(
            [JR.RanCell(policy=JR.make_policy(pol),
                        cfg=JR.RanConfig(**cfg_kw)) for _ in range(C)]))
        kids = np.random.SeedSequence(trial).spawn(C)
        r_py, r_port, r_jax = ([np.random.default_rng(k) for k in kids]
                               for _ in range(3))
        for slot in range(3):
            rows = []
            for _ in range(C):
                m = int(rng.integers(0, 9))
                rows.append([(int(u), int(rng.integers(0, 40_000)),
                              float(rng.random() * 0.01),
                              float(0.02 + rng.random() * 0.2),
                              float(10 ** rng.uniform(6.5, 8.0)))
                             for u in rng.choice(60, size=m, replace=False)])
            got = mac.serve_slot([[RAN.UplinkRequest(*r) for r in rs]
                                  for rs in rows], r_port)
            jgot = jmac.serve_slot([[JR.UplinkRequest(*r) for r in rs]
                                    for rs in rows], r_jax)
            assert _bits(got) == _bits(jgot)
            for c in range(C):
                want = cells[c].serve_slot(
                    [JR.UplinkRequest(*r) for r in rows[c]], r_py[c])
                assert _bits(got[c]) == _bits(want), (pol, trial, slot, c)
            assert mac._rr_ptr.tolist() == np.asarray(jmac._rr_ptr).tolist()
            for a, b in zip(mac._pf_avg, jmac._pf_avg):
                assert a.tobytes() == np.asarray(b).tobytes()
        for c in range(C):          # generators stayed paired modulo the tape
            assert mac._tapes[c].buf.tobytes() \
                == jmac._tapes[c].buf.tobytes()
            a = r_py[c].random(mac._tapes[c].buf.size + 1)
            assert a[:-1].tobytes() == mac._tapes[c].buf.tobytes()
            assert a[-1] == r_port[c].random() == r_jax[c].random()


@pytest.mark.parametrize("pol", POLICIES)
def test_multicell_city_arrays(jax_x64, pol):
    """``serve_slot_arrays`` on a ``synthetic_city`` (uneven cells, one of
    them empty) against the JAX package's, every array bit for bit."""
    batches = E.synthetic_city(50, 4, seed=2, mean_bytes=4_000)
    batches[2] = {k: v[:0] for k, v in batches[2].items()}
    cfg_kw = dict(n_prbs=30, tti_s=1e-3)
    mac = E.MultiCellVecMac([RAN.RanCell(policy=RAN.make_policy(pol),
                                         cfg=RAN.RanConfig(**cfg_kw))
                             for _ in range(4)], device="cpu")
    jmac = JE.MultiCellVecMac([JR.RanCell(policy=JR.make_policy(pol),
                                          cfg=JR.RanConfig(**cfg_kw))
                               for _ in range(4)])
    rngs = [np.random.default_rng(c) for c in range(4)]
    jrngs = [np.random.default_rng(c) for c in range(4)]
    for _ in range(2):
        got = mac.serve_slot_arrays(batches, rngs)
        want = jmac.serve_slot_arrays(batches, jrngs)
        assert got[2] == want[2] == {}
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                assert g[k].tobytes() == np.asarray(w[k]).tobytes(), k


def test_synthetic_city_partition():
    batches = E.synthetic_city(1000, 3, seed=1)
    assert len(batches) == 3
    assert sum(len(x["ue"]) for x in batches) == 1000
    for a, b in zip(batches, JE.synthetic_city(1000, 3, seed=1)):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].tobytes() == b[k].tobytes()


# -- the cell and the event engine ------------------------------------------------------

def _cell_runs(systems, build, run):
    """``run(build(ns, system, engine))`` for the port's python engine, its
    vectorized engine and the JAX package's vectorized engine."""
    (p, sysm), (r, jsys) = _sides(systems)
    return (run(build(p, sysm, "python")), run(build(p, sysm, "vectorized")),
            run(build(r, jsys, "vectorized")))


def _assert_engines_match(py, vec, jvec):
    _assert_results_equal(vec, py)
    _assert_results_equal(vec, jvec)


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("adaptive", (False, True))
def test_lockstep_engines_match(jax_x64, systems, pol, adaptive):
    def build(ns, system, engine):
        kw = dict(ns.kw, engine=engine)
        if adaptive:
            kw["controller"] = _controller(ns, system)
        return ns.CELL.CellSimulator(
            plan=ns.plan(ns.cfg), system=system, n_ues=3, seed=7,
            execute_model=False, frame_budget_s=2.0,
            ran=ns.RAN.RanCell(policy=ns.RAN.make_policy(pol),
                               cfg=ns.RAN.RanConfig(tti_s=0.002)), **kw)
    option = None if adaptive else "split3"
    _assert_engines_match(*_cell_runs(
        systems, build, lambda sim: sim.run(_trace(), option=option)))


@pytest.mark.parametrize("pol", POLICIES)
def test_streaming_engines_match(jax_x64, systems, pol):
    def build(ns, system, engine):
        return ns.CELL.CellSimulator(
            plan=ns.plan(ns.cfg), system=system, n_ues=3, seed=3,
            execute_model=False, frame_budget_s=2.5,
            ran=ns.RAN.RanCell(policy=ns.RAN.make_policy(pol),
                               cfg=ns.RAN.RanConfig(tti_s=0.004)),
            **dict(ns.kw, engine=engine))
    _assert_engines_match(*_cell_runs(
        systems, build, lambda sim: sim.run_stream(
            _trace(), option="split2", fps=0.5, jitter_s=0.03, inflight=2)))


def test_mobility_handover_engines_match(jax_x64, systems):
    """Two-cell ping-pong trajectory: handovers (and the dUPF path
    relocations they trigger) land on the same frames in every engine."""
    def build(ns, system, engine):
        M = ns.MOB
        sites = [M.CellSite(0.0, 0.0), M.CellSite(400.0, 0.0)]
        traj = [M.WaypointTrajectory(((30.0, 0.0), (370.0, 0.0)),
                                     speed_mps=10.0, loop=True)
                for _ in range(3)]
        mob = M.MobilityModel(sites, traj, M.MobilityConfig(
            a3_ttt_s=2.0, relocation_gap_s=0.2))
        cells = ns.RAN.MultiCell([ns.RAN.RanCell(
            policy=ns.RAN.make_policy("edf"),
            cfg=ns.RAN.RanConfig(tti_s=0.005)) for _ in sites])
        return ns.CELL.CellSimulator(
            plan=ns.plan(ns.cfg), system=system, n_ues=3, seed=3,
            execute_model=False, ran=cells, mobility=mob,
            frame_budget_s=6.0, **dict(ns.kw, engine=engine))
    rssi = np.full((24, 3), -40.0)
    runs = _cell_runs(systems, build,
                      lambda sim: sim.run_stream(rssi, option="split3",
                                                 fps=0.5))
    assert runs[1].stats.n_handovers > 0
    _assert_engines_match(*runs)


@pytest.mark.parametrize("scenario", ["ran_streaming", "chaos_outage",
                                      "chaos_correlated"])
def test_golden_scenario_vectorized(jax_x64, systems, scenario, tmp_path):
    """The golden scenarios with a RAN (EDF streaming; chaos blackouts
    parked and adopted in batches; correlated failures over two cells) on
    the vectorized engine: the port's logs, stats and recovery metrics
    equal its python engine's and the JAX package's vectorized engine's,
    and its telemetry export equals the latter's (the MAC backlog sample
    is numpy's sum in both vectorized engines)."""
    (p, sysm), (r, jsys) = _sides(systems)
    pv, rv = _vectorized(p), _vectorized(r)
    tele, jtele = p.TEL.Telemetry(), r.TEL.Telemetry()
    vec = SCENARIOS[scenario](pv, sysm, telemetry=tele)
    _assert_engines_match(SCENARIOS[scenario](p, sysm), vec,
                          SCENARIOS[scenario](rv, jsys, telemetry=jtele))
    assert vec.stats.n_completed > 0
    assert (_exports(pv, tele, tmp_path, "port")
            == _exports(rv, jtele, tmp_path, "ref"))


def test_vectorized_cell_keeps_the_grant_trace(systems):
    """With ``record_trace`` the lock-step engine hands the vectorized
    MAC's per-slot grant trace back to the ``RanCell``, as the python
    engine records it."""
    sysm = systems[0]
    traces = []
    for engine in ("python", "vectorized"):
        ran = RAN.RanCell(policy=RAN.make_policy("pf"),
                          cfg=RAN.RanConfig(tti_s=0.002), record_trace=True)
        sim = PORT.CELL.CellSimulator(
            plan=PORT.plan(PORT.cfg), system=sysm, n_ues=3, seed=5,
            execute_model=False, ran=ran, engine=engine, device="cpu")
        sim.run(_trace(), option="split2")
        traces.append(ran.grant_trace)
    assert traces[0] and _same(traces[0], traces[1])


# -- the cell axis over a mesh ---------------------------------------------------

@pytest.mark.parametrize("pol,n_cells", [("pf", 8), ("rr", 8), ("edf", 3)])
def test_multicell_vec_mac_over_two_ranks(tmp_path, pol, n_cells):
    """``MultiCellVecMac(mesh=...)`` on two gloo ranks (a 2 x 1 mesh) gives
    every rank the one-process MAC's reports bit for bit (grants, HARQ
    counts, finish times), its RR pointers and PF EWMA, and leaves each
    cell's generator where the one-process run leaves it on the rank that
    steps the cell: 8 cells split four a rank (a one-rank mesh, as on one
    card, runs the same path with every cell its own); 3 cells do not
    divide, so each rank steps all three."""
    from _torch_ranks import mac_rank, mac_run, spawn_ranks
    want = mac_run(pol, n_cells, 5)
    ranks = spawn_ranks(mac_rank, 2, tmp_path, pol, n_cells, 5)
    mine = ([range(0, 4), range(4, 8)] if n_cells == 8
            else [range(n_cells)] * 2)
    for r, got in enumerate(ranks):
        for s_got, s_want in zip(got["slots"], want["slots"]):
            assert len(s_got) == len(s_want)
            for a, b in zip(s_got, s_want):
                assert sorted(a) == sorted(b)
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(got["rr"], want["rr"])
        assert len(got["pf"]) == len(want["pf"])
        for a, b in zip(got["pf"], want["pf"]):
            np.testing.assert_array_equal(a, b)
        for c in mine[r]:
            assert got["gens"][c] == want["gens"][c]


def test_multicell_vec_mac_over_a_one_rank_mesh(tmp_path):
    """On a 1 x 1 mesh (one card) the cells split into one part: the same
    path as over many ranks, and the one-process MAC's results."""
    from _torch_ranks import mac_run, one_rank_group
    from repro_torch.launch.mesh import make_host_mesh
    with one_rank_group(tmp_path):
        mesh = make_host_mesh(device="cpu")
        got, want = mac_run("pf", 8, 9, mesh), mac_run("pf", 8, 9)
    for s_got, s_want in zip(got["slots"], want["slots"]):
        for a, b in zip(s_got, s_want):
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    for a, b in zip(got["pf"], want["pf"]):
        np.testing.assert_array_equal(a, b)
    assert got["gens"] == want["gens"]
