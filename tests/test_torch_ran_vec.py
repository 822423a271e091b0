"""The port's vectorized MAC (``repro_torch.core.ran_vec``) on the CPU against
the JAX package's, live, and its numpy oracle ``repro.core.ran``.

Three engines run side by side on paired HARQ generators: the port's
``VecRanCell`` / ``VecRanStream`` on ``device="cpu"``, the JAX package's
``VecRanCell`` / ``VecRanStream`` (``lax.scan``) and the oracle's
``RanCell`` / ``RanStream``.  Every report and flow field is held bit for
bit (floats by their hex form, so NaN equals NaN and -0.0 is not 0.0), as
are the grant traces, the PF EWMA arrays, the RR pointers, the pre-drawn
HARQ tapes and the Generators' states after every call.  The fuzz sets are
those of ``tests/test_ran_vec.py``.

The JAX package's vectorized MAC imports ``jax.experimental.enable_x64``,
which this jax no longer has; ``jax_x64`` puts ``jax.enable_x64`` in its
place for one test at a time (a function-scoped monkeypatch), so no other
test file sees it.
"""
import dataclasses

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from repro.core import engine_vec as JE
from repro.core import ran as JR
from repro.core import ran_vec as JV
from repro_torch.core import engine_vec as E
from repro_torch.core import ran as RAN
from repro_torch.core import ran_vec as V

POLICIES = ("rr", "pf", "edf")
FLOW_FIELDS = ("cohort", "meta", "rem_bits", "bpp", "granted", "act_slots",
               "n_tx", "n_retx", "finish_s", "granted_at_admit")


@pytest.fixture
def jax_x64(monkeypatch):
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


def _bits(v):
    """A value with every float replaced by its hex form (bitwise, NaN ==
    NaN), numpy scalars by Python ones, dataclasses by their fields."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return _bits(dataclasses.asdict(v))
    if isinstance(v, dict):
        return {k: _bits(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_bits(x) for x in v]
    if isinstance(v, (float, np.floating)):
        return float(v).hex()
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    return v


def _flow(f):
    return _bits([dataclasses.asdict(f.req)]
                 + [getattr(f, name) for name in FLOW_FIELDS])


def _same_flows(*lists):
    keys = [[_flow(f) for f in fl] for fl in lists]
    for k in keys[1:]:
        assert k == keys[0]


def _same_reports(*reps):
    keys = [_bits({u: r for u, r in rep.items()}) for rep in reps]
    for k in keys[1:]:
        assert k == keys[0]


def _check_rngs(port_tape, port_rng, jax_tape, jax_rng, oracle_rng):
    """Both vectorized engines hold the same pre-drawn tape and their
    Generators the same state; the oracle's next draws are that tape, then
    the Generators' next draw.  Leaves all three paired, tapes empty."""
    assert port_tape.buf.tobytes() == jax_tape.buf.tobytes()
    a, b = port_rng.random(), jax_rng.random()
    assert a == b
    t = port_tape.buf.size
    o = oracle_rng.random(t + 1)
    assert o[:t].tobytes() == port_tape.buf.tobytes() and o[t] == a
    port_tape.consume(t)
    jax_tape.consume(t)


def _rngs(seed):
    return [np.random.default_rng(seed) for _ in range(3)]


# -- the lexsort helper -----------------------------------------------------------

def _t(a, device=None):
    return torch.as_tensor(np.array(a), device=device)


def _lexsort_keys(seed, n):
    rng = np.random.default_rng(seed)
    ints = rng.integers(0, 4, n)                     # heavy ties
    floats = rng.choice([0.0, -0.0, 1.5, -2.0, np.inf, -np.inf, 3.25], n)
    fine = rng.random(n)
    fine[rng.random(n) < 0.3] = np.inf
    return [(ints,), (floats,), (fine, floats), (ints, floats, ints[::-1]),
            (np.arange(n)[::-1], ints, floats)]


@pytest.mark.parametrize("n", [1, 7, 64, 1000])
def test_lexsort_matches_numpy(n):
    for keys in _lexsort_keys(n, n):
        want = np.lexsort(keys)
        got = V._lexsort([_t(k) for k in keys])
        assert np.array_equal(got.numpy(), want), keys
    # rows of a batch sort on their own
    keys = [np.stack(k) for k in zip(*[_lexsort_keys(n + s, n)[3]
                                       for s in range(3)])]
    got = V._lexsort([_t(k) for k in keys]).numpy()
    for r in range(3):
        assert np.array_equal(got[r], np.lexsort([k[r] for k in keys]))


def test_zero_signs_tie_as_in_numpy():
    key = np.array([0.0, -0.0, 0.0, -0.0, -1.0, np.inf, -0.0])
    ue = np.array([3, 2, 1, 0, 5, 4, 6])
    for keys in ((key,), (ue, key)):
        want = np.lexsort(keys)
        got = V._lexsort([_t(k) for k in keys]).numpy()
        assert np.array_equal(got, want)
    assert list(np.lexsort((key,))) == [4, 0, 1, 2, 3, 6, 5]


# -- the lock-step slot ------------------------------------------------------------

def _req_rows(rng, n, n_ues=16):
    ues = rng.choice(n_ues, size=n, replace=False)
    return [(int(ues[i]), int(rng.integers(0, 40000)),
             float(rng.random() * 0.01), float(rng.random() * 0.05),
             float(10e6 + rng.random() * 90e6)) for i in range(n)]


def _reqs(mod, rows):
    return [mod.UplinkRequest(*r) for r in rows]


def _slot_cells(pol, cfg_kw, n_ues, record=True):
    oc = JR.RanCell(policy=JR.make_policy(pol), cfg=JR.RanConfig(**cfg_kw),
                    record_trace=record)
    jc = JV.VecRanCell.from_cell(oc)
    pc = V.VecRanCell.from_cell(
        RAN.RanCell(policy=RAN.make_policy(pol),
                    cfg=RAN.RanConfig(**cfg_kw), record_trace=record),
        device="cpu")
    for c in (oc, jc, pc):
        c.reset(n_ues)
    return pc, jc, oc


def _serve_three(cells, rngs, rows):
    pc, jc, oc = cells
    rp, rj, ro = rngs
    got = pc.serve_slot(_reqs(RAN, rows), rp)
    _same_reports(got, jc.serve_slot(_reqs(JR, rows), rj),
                  oc.serve_slot(_reqs(JR, rows), ro))
    assert _bits(pc.grant_trace) == _bits(jc.grant_trace) \
        == _bits(oc.grant_trace)
    assert pc._rr_ptr == jc._rr_ptr
    assert pc._pf_avg.tobytes() == np.asarray(jc._pf_avg).tobytes()
    if pc.policy == V._PF and oc.policy._avg.size:
        m = oc.policy._avg.size
        assert pc._pf_avg[:m].tobytes() == oc.policy._avg.tobytes()
        assert not pc._pf_avg[m:].any()
    _check_rngs(pc._tape, rp, jc._tape, rj, ro)
    return got


@pytest.mark.parametrize("pol", POLICIES)
def test_slot_equality_fuzz(jax_x64, pol):
    for trial in range(8):
        seed = 1000 + trial
        rng = np.random.default_rng(seed)
        n = int(rng.integers(1, 12))
        cells = _slot_cells(pol, dict(tti_s=0.001,
                                      n_prbs=int(rng.integers(5, 120))), 16)
        rngs = _rngs(seed + 77)
        # several slots back to back: policy state (RR pointer, PF EWMA)
        # must persist identically across slot boundaries
        for _ in range(3):
            _serve_three(cells, rngs, _req_rows(rng, n))


@pytest.mark.parametrize("pol", POLICIES)
def test_slot_zero_backlog(jax_x64, pol):
    """Empty slots and all-zero payloads are served identically and keep
    the generators paired."""
    cells = _slot_cells(pol, dict(tti_s=0.001, n_prbs=20), 4)
    rngs = _rngs(9)
    zero = [(u, 0, 0.0, 0.05, 20e6) for u in range(3)]
    live = [(1, 4000, 0.0, 0.05, 20e6)]
    for rows in ([], zero, live, []):
        _serve_three(cells, rngs, rows)


def test_slot_pf_silent_ue_ewma(jax_x64):
    """PF's EWMA decays for UEs absent from later slots; the port's array
    must equal the JAX package's and the oracle's bit for bit, so grants
    stay identical once the UE returns."""
    cells = _slot_cells("pf", dict(tti_s=0.001, n_prbs=12), 6)
    rngs = _rngs(21)
    for ues in ((0, 1), (0, 1), (2, 3), (2, 3), (0, 1, 2, 3)):
        _serve_three(cells, rngs, [(u, 9000, 0.0, 0.1, 15e6 + 3e6 * u)
                                   for u in ues])
    assert (cells[0]._pf_avg[:4] > 0).all()


def test_slot_guard_raises_like_the_oracle():
    cfg = dict(tti_s=0.001, n_prbs=5, max_slots=3)
    pc = V.VecRanCell.from_cell(RAN.RanCell(
        policy=RAN.make_policy("edf"), cfg=RAN.RanConfig(**cfg)), device="cpu")
    oc = RAN.RanCell(policy=RAN.make_policy("edf"), cfg=RAN.RanConfig(**cfg))
    rows = [(0, 40000, 0.0, 0.05, 20e6)]
    for cell in (oc, pc):
        with pytest.raises(RuntimeError, match="not drained after 3 TTIs"):
            cell.serve_slot(_reqs(RAN, rows), np.random.default_rng(0))


# -- the stream --------------------------------------------------------------------

def _streams(pol, cfg_kw, n_ues):
    oc = JR.RanCell(policy=JR.make_policy(pol), cfg=JR.RanConfig(**cfg_kw))
    oc.reset(n_ues)
    js = JV.VecRanStream(JR.RanCell(policy=JR.make_policy(pol),
                                    cfg=JR.RanConfig(**cfg_kw)), n_ues=n_ues)
    js.cell.reset(n_ues)
    ps = V.VecRanStream(RAN.RanCell(policy=RAN.make_policy(pol),
                                    cfg=RAN.RanConfig(**cfg_kw)),
                        n_ues=n_ues, device="cpu")
    ps.cell.reset(n_ues)
    return ps, js, JR.RanStream(oc)


def _advance_three(streams, rngs, until):
    outs = [s.advance(until, r) for s, r in zip(streams, rngs)]
    _same_flows(*outs)
    ps, js, os_ = streams
    for f, g in zip(outs[0], outs[2]):
        assert _bits(ps.report(f)) == _bits(os_.report(g))
    assert ps.backlog_bytes == js.backlog_bytes
    # the vectorized engines sum the live flows' bits with numpy (pairwise),
    # the oracle in a Python loop: the same bits, in the same order
    assert ps.backlog_bytes == float(np.array(
        [f.rem_bits for f in os_._flows if not f.done]).sum() / 8.0)
    assert _bits(ps.telemetry_sample()) == _bits(js.telemetry_sample())
    assert ps.telemetry_sample()["live_flows"] \
        == os_.telemetry_sample()["live_flows"]
    assert ps._k == js._k == os_._k
    assert ps.cell._rr_ptr == js.cell._rr_ptr
    assert ps.cell._pf_avg.tobytes() == np.asarray(js.cell._pf_avg).tobytes()
    _check_rngs(ps.cell._tape, rngs[0], js.cell._tape, rngs[1], rngs[2])
    return outs[0]


def _enqueue_three(streams, row, cohort, meta=None):
    ps, js, os_ = streams
    for s, mod in ((ps, RAN), (js, JR), (os_, JR)):
        s.enqueue(mod.UplinkRequest(*row), cohort, meta=meta)


@pytest.mark.parametrize("pol", POLICIES)
def test_stream_equality_fuzz(jax_x64, pol):
    for seed in (3000, 3001, 3002):
        rng = np.random.default_rng(seed)
        streams = _streams(pol, dict(tti_s=0.002,
                                     n_prbs=int(rng.integers(10, 80))), 8)
        rngs = _rngs(seed + 5)
        t, cohort = 0.0, 0
        for round_ in range(12):
            for _ in range(int(rng.integers(1, 5))):
                _enqueue_three(streams, (
                    int(rng.integers(0, 8)), int(rng.integers(1, 25000)),
                    t + float(rng.random() * 0.01),
                    t + float(rng.random() * 0.08),
                    float(5e6 + rng.random() * 60e6)), cohort,
                    meta=("m", round_))
            cohort += 1
            t += float(rng.random() * 0.05)
            _advance_three(streams, rngs, t)
            if round_ == 5:  # handover: migrate a UE out, mutate, adopt back
                mu = int(rng.integers(0, 8))
                moved = [s.migrate_ue(mu) for s in streams]
                _same_flows(*moved)
                for s, fl in zip(streams, moved):
                    for f in fl:
                        f.n_retx += 1
                        s.adopt(f, t + 0.003, 999)
        _advance_three(streams, rngs, float("inf"))
        assert streams[0]._n == 0 or not (streams[0]._rem[
            :streams[0]._n] > 0).any()


def test_stream_edf_same_deadline(jax_x64):
    """300 flows sharing one deadline: where the JAX package's candidate
    window cannot separate the ties and falls back to its full sort, the
    port's exact grant must give the same flows, field for field."""
    streams = _streams("edf", dict(tti_s=0.002, n_prbs=24), 64)
    rng = np.random.default_rng(44)
    for i in range(300):
        _enqueue_three(streams, (
            int(rng.integers(0, 64)), int(rng.integers(400, 4000)), 0.0, 1.0,
            float(8e6 + rng.random() * 30e6)), 0, meta=("m", i))
    done = _advance_three(streams, _rngs(45), float("inf"))
    assert len(done) == 300


# -- batched park/adopt, backlog ------------------------------------------------------

def _enqueue_flows(streams, flows, n):
    for i in range(n):
        _enqueue_three(streams, (
            int(flows["ue"][i]), int(flows["n_bytes"][i]),
            float(flows["enq"][i]), float(flows["dead"][i]),
            float(flows["link_rate_bps"][i])), int(flows["cohort"][i]))


def test_synthetic_flows_match_the_jax_package():
    for args, kw in (((200, 3), dict(n_ues=40)), ((64, 5), {}),
                     ((10, 1), dict(n_ues=3, mean_bytes=64))):
        a, b = E.synthetic_flows(*args, **kw), JE.synthetic_flows(*args, **kw)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes()


def test_backlog_bytes_value_identity(jax_x64):
    streams = _streams("edf", dict(tti_s=0.002), 12)
    _enqueue_flows(streams, JE.synthetic_flows(60, seed=3, n_ues=12), 60)
    rngs = _rngs(9)
    for t in (0.05, 0.09, 0.13, float("inf")):
        _advance_three(streams, rngs, t)
        ps = streams[0]
        manual = sum(float(ps._rem[i]) for i in
                     np.flatnonzero(ps._rem[:ps._n] > 0.0)) / 8.0
        assert ps.backlog_bytes == manual == streams[2].backlog_bytes


@pytest.mark.parametrize("pol", POLICIES)
def test_migrate_ues_matches_per_ue_oracle(jax_x64, pol):
    """One batched ``migrate_ues`` == K sequential ``migrate_ue`` calls of
    the oracle: identical parked flows (admission order, TB-flush rule), an
    identical ``ParkedFlows`` to the JAX package's, and identical
    survivors after ``adopt_batch``."""
    streams = _streams(pol, dict(tti_s=0.002), 24)
    _enqueue_flows(streams, JE.synthetic_flows(120, seed=3, n_ues=24), 120)
    rngs = _rngs(17)
    done = _advance_three(streams, rngs, 0.06)
    ues = list(range(0, 24, 2))
    ps, js, os_ = streams
    parts = [s.migrate_ues(ues, flush_tb=True) for s in streams]
    assert len(parts[0]) == len(parts[1]) == len(parts[2]) == len(ues)
    for pp, jp, op in zip(*parts):
        _same_flows(pp.flows(), jp.flows(), op)
        for col in V._PARK_COLS:
            assert getattr(pp, col).tobytes() == getattr(jp, col).tobytes()
            assert getattr(pp, col).dtype == getattr(jp, col).dtype
    ps.adopt_batch(V.ParkedFlows.concat(parts[0]), 0.1, 999)
    js.adopt_batch(JV.ParkedFlows.concat(parts[1]), 0.1, 999)
    os_.adopt_batch([f for p in parts[2] for f in p], 0.1, 999)
    rest = _advance_three(streams, rngs, float("inf"))
    assert len(rest) == 120 - len(done)


@pytest.mark.parametrize("pol", POLICIES)
def test_mass_blackout_chaos_drain_parity(jax_x64, pol):
    """The batched park/adopt cycle under overlapping mass blackouts:
    ``chaos_drain`` of the port (on its own stream) and of the JAX package
    (on its vectorized and its oracle stream) agree field for field."""
    flows = JE.synthetic_flows(200, seed=3, n_ues=40)
    streams = _streams(pol, dict(tti_s=0.002), 40)
    blk = [(0.05, 0.25, list(range(0, 40, 2))), (0.12, 0.30, [1, 3, 5])]
    rngs = [np.random.default_rng(np.random.SeedSequence(7))
            for _ in range(3)]
    outs = [E.chaos_drain(streams[0], flows, rngs[0], blackouts=blk)]
    outs += [JE.chaos_drain(s, flows, r, blackouts=blk)
             for s, r in zip(streams[1:], rngs[1:])]
    assert len(outs[0]) == 200
    _same_flows(*outs)
    ps, js, _ = streams
    _check_rngs(ps.cell._tape, rngs[0], js.cell._tape, rngs[1], rngs[2])


def test_chaos_drain_batch_enqueue(jax_x64):
    flows = JE.synthetic_flows(150, seed=4, n_ues=30)
    streams = _streams("pf", dict(tti_s=0.001), 30)
    blk = [(0.04, 0.11, list(range(0, 30, 3)))]
    rngs = _rngs(11)
    outs = [E.chaos_drain(streams[0], flows, rngs[0], blackouts=blk,
                          batch_enqueue=True)]
    outs += [JE.chaos_drain(s, flows, r, blackouts=blk, batch_enqueue=True)
             for s, r in zip(streams[1:], rngs[1:])]
    assert len(outs[0]) == 150
    _same_flows(*outs)


# -- the carry, the device ----------------------------------------------------------

SLOT_DTYPES = dict(code=torch.int64, k=torch.int64, ptr=torch.int64,
                   rr_ptr=torch.int64, z=torch.int64, rem=torch.float64,
                   fin=torch.float64, grt=torch.int64, act=torch.int64,
                   ntx=torch.int64, nrx=torch.int64, pfa=torch.float64)
STREAM_DTYPES = dict(SLOT_DTYPES, nstep=torch.int64, is_hol=torch.bool,
                     open_cnt=torch.int64, n_live=torch.int64,
                     n_drained=torch.int64)


@pytest.mark.parametrize("pol", POLICIES)
def test_carry_dtypes(monkeypatch, pol):
    """Every field of both carries is int64 / float64 (the mask bool), in
    the first step and after the last."""
    seen = []
    for name in ("_slot_step", "_stream_step"):
        step = getattr(V, name)

        def spy(c, *a, step=step, **kw):
            out = step(c, *a, **kw)
            seen.append((c, out[0] if isinstance(out, tuple)
                         and not hasattr(out, "_fields") else out))
            return out
        monkeypatch.setattr(V, name, spy)
    cell = V.VecRanCell.from_cell(RAN.RanCell(policy=RAN.make_policy(pol)),
                                  device="cpu")
    cell.reset(8)
    cell.serve_slot(_reqs(RAN, _req_rows(np.random.default_rng(0), 5)),
                    np.random.default_rng(1))
    strm = V.VecRanStream(RAN.RanCell(policy=RAN.make_policy(pol)), 8,
                          device="cpu")
    for row in _req_rows(np.random.default_rng(2), 6, 8):
        strm.enqueue(RAN.UplinkRequest(*row), 0)
    strm.advance(float("inf"), np.random.default_rng(3))
    kinds = {type(c).__name__ for c, _ in seen}
    assert kinds == {"_SlotCarry", "_StreamCarry"}
    for pair in (seen[0], seen[-1]):
        for c in pair:
            want = (SLOT_DTYPES if type(c).__name__ == "_SlotCarry"
                    else STREAM_DTYPES)
            assert {f: getattr(c, f).dtype for f in c._fields} == want


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cell = RAN.RanCell(policy=RAN.make_policy("edf"))
    for build in (lambda: V.VecRanCell.from_cell(cell),
                  lambda: V.VecRanCell(policy=V._EDF),
                  lambda: V.VecRanStream(cell),
                  lambda: E.MultiCellVecMac([cell])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_custom_policy_is_refused():
    class Mine(RAN.DeadlineEDFScheduler):
        pass
    with pytest.raises(ValueError, match="stock rr/pf/edf"):
        V.VecRanCell.from_cell(RAN.RanCell(policy=Mine()), device="cpu")
