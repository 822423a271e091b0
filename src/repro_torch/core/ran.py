"""A copy of ``repro/core/ran.py`` (numpy only).  Every draw from the
HARQ ``np.random.Generator`` is made in the same order, so a seed gives the
same grants, HARQ outcomes and reports as in the JAX package.

TTI-slotted shared-uplink NR MAC: PRB grants, HARQ, pluggable schedulers.

The paper's measurements run on an Aerial AI-RAN testbed where every UE's
uplink shares ONE NR cell -- throughput collapses under load and jamming
precisely because PRBs are a contended resource.  ``core/cell.py`` used to
give each UE an independent ``ChannelModel`` draw, so N UEs uploading full
Swin boundary activations never interfered.  This module is the missing
MAC layer between the calibrated channel and the system simulator:

  * ``RanCell`` holds the cell's PRB grid (``RanConfig.n_prbs`` per TTI of
    ``tti_s`` seconds) and drains per-UE uplink byte queues slot by slot.
  * Per-UE spectral efficiency (bits per PRB per slot) is derived from the
    calibrated ``ChannelModel.rate_table`` -- NOT from an independent link
    abstraction -- via the **calibration tie-back**

        bits_per_prb = link_rate * tti_s / (n_prbs * (1 - bler_target))

    so a lone UE granted the whole grid every slot realizes exactly
    ``link_rate`` *after* expected HARQ losses: single-UE idle-cell runs
    reproduce the legacy ``ChannelModel`` pipeline numbers (Fig. 4 / the
    dUPF traces) within fading + TTI-quantization tolerance.  The airlink
    uses this continuous calibrated efficiency; the nearest NR MCS index
    is *reported* in grants/KPMs (quantizing the airlink itself would put
    a systematic ~10% error on the Fig. 4 calibration).
  * A BLER-target HARQ model fails each granted transport block i.i.d.
    with probability ``bler_target`` and re-enqueues the failed bytes for
    the next grant (NR runs enough parallel HARQ processes that a single
    UE does not stall on a retransmission RTT, so failed TBs simply
    return to the head of the queue).
  * ``SchedulerPolicy`` implementations decide per-TTI PRB grants:
    round-robin (equal water-filled shares), proportional-fair (greedy by
    instantaneous-rate / EWMA-throughput metric), and deadline-aware EDF
    (earliest absolute deadline first, i.e. largest "frame budget minus
    elapsed pipeline time" urgency; ties broken smallest-residual-first).

Determinism discipline (cf. ``PathModel.sample_latency``): policies are
pure functions of the slot state, fading is drawn by the *caller* (one
vectorized draw per frame over the UE axis, exactly like
``ChannelModel.sample_rate``), and HARQ consumes a dedicated rng stream
with a fixed draw count per TTI (``len(requests)`` uniforms, granted or
not).  Same seed + same policy therefore yields an identical grant trace,
and RR-vs-EDF comparisons see identical fading realizations.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

# NR Table 5.1.3.1-1-flavoured spectral efficiencies (bits per resource
# element) for MCS 0..27 -- used to *report* the MCS a grant's calibrated
# efficiency corresponds to (KPM realism; the airlink stays continuous).
MCS_SE = (0.2344, 0.3770, 0.6016, 0.8770, 1.1758, 1.4766, 1.6953, 1.9141,
          2.1602, 2.4063, 2.5703, 2.7305, 3.0293, 3.3223, 3.6094, 3.9023,
          4.2129, 4.5234, 4.8164, 5.1152, 5.3320, 5.5547, 5.8906, 6.2266,
          6.5703, 6.9141, 7.1602, 7.4063)
RE_PER_PRB = 12 * 14            # subcarriers x OFDM symbols per slot


def mcs_index(bits_per_prb: float) -> int:
    """Nearest-not-exceeding NR MCS index for a per-PRB-per-slot payload."""
    se = bits_per_prb / RE_PER_PRB
    idx = 0
    for i, s in enumerate(MCS_SE):
        if s <= se:
            idx = i
    return idx


def jain_fairness(values) -> float:
    """Jain's index over per-UE throughputs: 1 = perfectly fair, 1/n =
    one UE gets everything."""
    x = np.asarray(values, float)
    if x.size == 0 or not np.any(x > 0):
        return 1.0
    return float(x.sum() ** 2 / (x.size * (x ** 2).sum()))


@dataclass(frozen=True)
class RanConfig:
    n_prbs: int = 100           # PRB grid width per TTI (100 MHz @ 30 kHz SCS)
    tti_s: float = 1e-3         # slot duration
    bler_target: float = 0.1    # link adaptation operating point
    max_slots: int = 200_000    # drain guard (see serve_slot)


@dataclass(frozen=True)
class UplinkRequest:
    """One UE's uplink demand for a frame-slot."""
    ue_id: int
    n_bytes: int
    enqueue_s: float            # payload ready (head + quant elapsed)
    deadline_s: float           # absolute within-slot deadline (EDF urgency)
    link_rate_bps: float        # calibrated faded link rate (idle-cell bps)


@dataclass
class GrantReport:
    """Per-UE grant history for one frame-slot."""
    ue_id: int
    n_bytes: int
    enqueue_s: float
    finish_s: float             # last transport block delivered
    tx_s: float                 # enqueue -> delivered (airtime + MAC queuing)
    granted_prbs: int           # total PRBs granted over the slot
    active_slots: int           # TTIs spent with data pending
    n_tx: int                   # transport blocks transmitted
    n_harq_retx: int            # of which HARQ retransmissions were needed
    realized_rate_bps: float    # n_bytes * 8 / tx_s (the scheduled rate)
    prb_share: float            # granted / (n_prbs * active_slots)
    mcs: int                    # reported MCS index for the link efficiency


@dataclass
class SlotView:
    """What a scheduler sees at the top of one TTI (request-indexed)."""
    now_s: float
    tti_s: float
    active: np.ndarray          # bool: enqueued and bytes pending
    remaining_bits: np.ndarray
    bits_per_prb: np.ndarray
    deadline_s: np.ndarray
    ue_ids: np.ndarray
    n_prbs: int
    _need: np.ndarray = None    # lazy need_prbs cache (state is per-TTI)

    def need_prbs(self) -> np.ndarray:
        """PRBs each active request needs to drain its queue this TTI."""
        if self._need is None:
            need = np.ceil(self.remaining_bits / self.bits_per_prb)
            self._need = np.where(self.active, need, 0).astype(int)
        return self._need


# ---------------------------------------------------------------------------
# scheduler policies
# ---------------------------------------------------------------------------

def _greedy_fill(order: Sequence[int], need: np.ndarray,
                 n_prbs: int) -> np.ndarray:
    """Grant each request (in priority order) up to its need.

    Closed form of the sequential fill: request ``order[j]`` sees
    ``n_prbs`` minus everything granted before it, clipped to [0, need].
    """
    alloc = np.zeros_like(need)
    order = np.asarray(order, dtype=int)
    if order.size == 0:
        return alloc
    no = need[order]
    cum = np.cumsum(no)
    alloc[order] = np.clip(n_prbs - (cum - no), 0, no)
    return alloc


def _equal_fill(order: Sequence[int], need: np.ndarray,
                n_prbs: int) -> np.ndarray:
    """Water-filled equal shares: split the grid evenly, recycle PRBs a
    draining UE cannot use, hand the remainder out in ``order``.

    Closed form of the round-based refill loop: every request still
    unsatisfied after the loop holds the same water level L -- the
    largest integer with sum(min(need, L)) <= n_prbs -- and the leftover
    PRBs go one each to the first ``left`` unsatisfied requests in
    ``order``.  L is found by bisection on the sorted needs' prefix sums.
    """
    alloc = np.zeros_like(need)
    order = np.asarray(order, dtype=int)
    nz = order[need[order] > 0]
    if nz.size == 0 or n_prbs <= 0:
        return alloc
    nd = need[nz]
    s = np.sort(nd)
    prefix = np.cumsum(s)
    m = nd.size
    if int(prefix[-1]) <= n_prbs:
        level = int(s[-1])              # everyone drains; no remainder pass
    else:
        lo, hi = 0, int(s[-1])
        while lo < hi:
            mid = (lo + hi + 1) // 2
            j = int(np.searchsorted(s, mid, side="right"))
            filled = (int(prefix[j - 1]) if j else 0) + (m - j) * mid
            if filled <= n_prbs:
                lo = mid
            else:
                hi = mid - 1
        level = lo
    got = np.minimum(nd, level)
    left = n_prbs - int(got.sum())
    if left > 0:
        unsat = np.flatnonzero(nd > level)
        got[unsat[:left]] += 1
    alloc[nz] = got
    return alloc


class SchedulerPolicy:
    """Per-TTI PRB allocator.  Stateful across TTIs and frame-slots
    (``CellSimulator.reset`` calls ``reset`` so runs stay reproducible);
    policies draw no randomness of their own -- same seed + same policy
    gives an identical grant trace."""
    name = "base"

    def reset(self, n_ues: int):
        pass

    def grant(self, view: SlotView) -> np.ndarray:
        raise NotImplementedError

    def observe(self, delivered_bits: np.ndarray, view: SlotView):
        """Post-HARQ feedback (PF updates its throughput EWMA here)."""


class RoundRobinScheduler(SchedulerPolicy):
    """Equal water-filled shares; the remainder pointer rotates each TTI."""
    name = "rr"
    _ptr = 0

    def reset(self, n_ues: int):
        self._ptr = 0

    def grant(self, view: SlotView) -> np.ndarray:
        idx = np.flatnonzero(view.active)
        start = self._ptr % len(idx)
        order = np.concatenate([idx[start:], idx[:start]])
        self._ptr += 1
        return _equal_fill(order, view.need_prbs(), view.n_prbs)


class ProportionalFairScheduler(SchedulerPolicy):
    """Classic PF metric: instantaneous rate over EWMA served throughput.
    Grants greedily in metric order (a freshly served UE's EWMA rises, so
    priority rotates while persistently good channels keep an edge)."""
    name = "pf"
    alpha = 0.1                 # EWMA smoothing
    eps_bps = 1e3               # floor so unserved UEs have finite metric
    _avg = np.zeros(0)          # grown by _ensure / replaced by reset

    def reset(self, n_ues: int):
        self._avg = np.zeros(n_ues)

    def _ensure(self, n_ues: int):
        if self._avg.size < n_ues:
            old = self._avg
            self._avg = np.zeros(n_ues)
            self._avg[:old.size] = old

    def grant(self, view: SlotView) -> np.ndarray:
        self._ensure(int(view.ue_ids.max()) + 1)
        idx = np.flatnonzero(view.active)
        inst = view.bits_per_prb[idx] * view.n_prbs / view.tti_s
        metric = inst / np.maximum(self._avg[view.ue_ids[idx]], self.eps_bps)
        # metric desc, ue_id asc tie-break -- deterministic
        order = idx[np.lexsort((view.ue_ids[idx], -metric))]
        return _greedy_fill(order, view.need_prbs(), view.n_prbs)

    def observe(self, delivered_bits: np.ndarray, view: SlotView):
        self._ensure(int(view.ue_ids.max()) + 1)
        served = np.zeros_like(self._avg)
        served[view.ue_ids[view.active]] = \
            delivered_bits[view.active] / view.tti_s
        a = self.alpha
        self._avg = (1 - a) * self._avg + a * served


class DeadlineEDFScheduler(SchedulerPolicy):
    """Earliest-deadline-first: urgency = absolute deadline (frame budget
    minus elapsed pipeline time fixed it at enqueue).  Equal deadlines tie
    break smallest-residual-first (SRPT), which maximizes the number of
    flows finished before their deadline under overload -- exactly where
    processor-sharing (RR) misses every deadline at once."""
    name = "edf"

    def grant(self, view: SlotView) -> np.ndarray:
        idx = np.flatnonzero(view.active)
        need = view.need_prbs()
        # stable lexicographic (deadline, residual, ue_id) -- same order
        # the old sorted(key=tuple) produced, without the Python-level
        # comparison loop (the 1k-UE oracle's worst per-TTI cost)
        order = idx[np.lexsort((view.ue_ids[idx], need[idx],
                                view.deadline_s[idx]))]
        return _greedy_fill(order, need, view.n_prbs)


POLICIES = {p.name: p for p in (RoundRobinScheduler, ProportionalFairScheduler,
                                DeadlineEDFScheduler)}


def make_policy(name: str) -> SchedulerPolicy:
    if name not in POLICIES:
        raise ValueError(f"unknown scheduler policy {name!r}; "
                         f"choose from {sorted(POLICIES)}")
    return POLICIES[name]()


# ---------------------------------------------------------------------------
# the cell MAC
# ---------------------------------------------------------------------------

@dataclass
class RanCell:
    """Shared-uplink MAC for one NR cell.

    ``serve_slot`` drains one frame-slot's uplink requests TTI by TTI:
    the policy grants PRBs over active queues, each granted transport
    block fails i.i.d. at the BLER target (failed bytes re-enqueue), and
    per-UE ``GrantReport``s come back with grant history, HARQ counts and
    the realized (scheduled) rate -- the quantity split selection must
    see instead of the isolated link rate."""
    policy: SchedulerPolicy
    cfg: RanConfig = field(default_factory=RanConfig)
    record_trace: bool = False
    # per-TTI (slot, ((ue, prbs, delivered_bits, harq_fail), ...)) when
    # record_trace is set; cleared at each serve_slot
    grant_trace: List[Tuple[int, Tuple]] = field(default_factory=list)

    def reset(self, n_ues: int):
        self.policy.reset(n_ues)
        self.grant_trace = []

    # -- calibration tie-back -------------------------------------------------
    def bits_per_prb(self, link_rate_bps):
        """Spectral efficiency such that a lone UE granted the whole grid
        realizes ``link_rate_bps`` after expected HARQ losses."""
        return (np.asarray(link_rate_bps, float) * self.cfg.tti_s
                / (self.cfg.n_prbs * (1.0 - self.cfg.bler_target)))

    # -- one frame-slot -------------------------------------------------------
    def serve_slot(self, requests: Sequence[UplinkRequest],
                   harq_rng: np.random.Generator) -> Dict[int, GrantReport]:
        """Run TTIs until every queue drains; returns per-UE reports keyed
        by ue_id.  ``harq_rng`` draws exactly ``len(requests)`` uniforms
        per TTI (granted or not), so the stream stays policy-comparable."""
        self.grant_trace = []
        if not requests:
            return {}
        cfg = self.cfg
        n = len(requests)
        ue = np.array([r.ue_id for r in requests])
        enq = np.array([r.enqueue_s for r in requests])
        dead = np.array([r.deadline_s for r in requests])
        rem = np.array([r.n_bytes * 8.0 for r in requests])
        bpp = self.bits_per_prb([r.link_rate_bps for r in requests])
        granted = np.zeros(n, int)
        act_slots = np.zeros(n, int)
        n_tx = np.zeros(n, int)
        n_retx = np.zeros(n, int)
        finish = np.where(rem > 0, np.nan, enq)

        k = int(math.ceil(enq.min() / cfg.tti_s))
        while np.any(rem > 0):
            if k >= cfg.max_slots:
                raise RuntimeError(
                    f"RanCell: uplink queues not drained after "
                    f"{cfg.max_slots} TTIs "
                    f"({cfg.max_slots * cfg.tti_s:.1f} s simulated); raise "
                    f"RanConfig.max_slots or reduce the offered load")
            now = k * cfg.tti_s
            active = (enq <= now) & (rem > 0)
            if not active.any():
                # idle gap: jump to the next payload's first eligible TTI
                k = int(math.ceil(enq[rem > 0].min() / cfg.tti_s))
                continue
            view = SlotView(now_s=now, tti_s=cfg.tti_s, active=active,
                            remaining_bits=rem, bits_per_prb=bpp,
                            deadline_s=dead, ue_ids=ue, n_prbs=cfg.n_prbs)
            alloc = self.policy.grant(view)
            assert alloc.sum() <= cfg.n_prbs, \
                f"{self.policy.name} over-granted the PRB grid"
            sent = np.minimum(rem, alloc * bpp)
            fail = (harq_rng.random(n) < cfg.bler_target) & (alloc > 0)
            delivered = np.where(fail, 0.0, sent)
            rem = rem - delivered
            done = (rem <= 1e-9) & np.isnan(finish)
            finish[done] = now + cfg.tti_s
            rem[rem <= 1e-9] = 0.0
            granted += alloc
            act_slots += active
            n_tx += alloc > 0
            n_retx += fail
            self.policy.observe(delivered, view)
            if self.record_trace:
                g = np.flatnonzero(alloc)
                self.grant_trace.append((k, tuple(
                    (int(ue[i]), int(alloc[i]), int(delivered[i]),
                     bool(fail[i])) for i in g)))
            k += 1

        reports = {}
        for i in range(n):
            tx_s = float(finish[i] - enq[i])
            reports[int(ue[i])] = GrantReport(
                ue_id=int(ue[i]), n_bytes=int(requests[i].n_bytes),
                enqueue_s=float(enq[i]), finish_s=float(finish[i]),
                tx_s=tx_s, granted_prbs=int(granted[i]),
                active_slots=int(act_slots[i]), n_tx=int(n_tx[i]),
                n_harq_retx=int(n_retx[i]),
                realized_rate_bps=(requests[i].n_bytes * 8.0 / tx_s
                                   if tx_s > 0 else 0.0),
                prb_share=(granted[i] / (cfg.n_prbs * act_slots[i])
                           if act_slots[i] else 0.0),
                mcs=mcs_index(float(bpp[i])))
        return reports


@dataclass
class MultiCell:
    """2-3 ``RanCell``s with independent PRB grids -- the multi-cell
    deployment the mobility layer (core/mobility.py) hands UEs across.
    Each cell schedules its own attached UEs; a handover migrates the
    UE's byte queue between the cells' continuous streams
    (``RanStream.migrate_ue`` / ``adopt``).  Cell 0 is the anchor: a
    single-cell ``MultiCell`` is exactly one ``RanCell`` and the
    degenerate mobility configuration replays the single-cell engine
    rng-paired (each cell's HARQ draws come from its own dedicated
    stream, cell 0 keeping the simulator's original one).

    All cells must share one ``RanConfig``: a migrated flow's grant and
    active-slot counters span both cells, and the airtime / PRB-share
    accounting (``timeline.deliver``, ``RanStream.report``) converts
    them through ONE grid geometry -- heterogeneous grids would need
    per-cell grant decomposition to bill TX energy correctly."""
    cells: List[RanCell]

    def __post_init__(self):
        if not self.cells:
            raise ValueError("MultiCell needs at least one RanCell")
        for c in self.cells[1:]:
            if c.cfg != self.cells[0].cfg:
                raise ValueError(
                    "MultiCell cells must share one RanConfig (grant "
                    f"accounting spans handovers): {c.cfg} != "
                    f"{self.cells[0].cfg}")

    @property
    def n_cells(self) -> int:
        return len(self.cells)

    def reset(self, n_ues: int):
        for c in self.cells:
            c.reset(n_ues)


# ---------------------------------------------------------------------------
# continuous-TTI streaming MAC (core/timeline.py drives this)
# ---------------------------------------------------------------------------

@dataclass
class StreamFlow:
    """One frame's uplink living in the continuous MAC.  ``meta`` is the
    caller's per-frame record (opaque here); ``cohort`` tags the capture
    round the flow was admitted in (rng-pairing discipline, see
    ``RanStream.advance``)."""
    req: UplinkRequest
    cohort: int
    meta: object = None
    rem_bits: float = 0.0
    bpp: float = 0.0
    granted: int = 0
    act_slots: int = 0
    n_tx: int = 0
    n_retx: int = 0
    finish_s: float = float("nan")
    # ``granted`` snapshot when the flow entered its CURRENT cell: a
    # handover flushes an in-flight transport block only if this cell
    # actually granted one (granted > granted_at_admit), so ping-pong
    # handovers through an idle cell do not double-bill the same TB
    granted_at_admit: int = 0

    @property
    def done(self) -> bool:
        return self.rem_bits <= 0.0


class RanStream:
    """Continuous TTI clock over a ``RanCell``: per-UE byte queues persist
    across frames, so a congested capture's overflow delays the next
    frame's uplink instead of silently completing inside its own slot.

    Differences from the lock-step ``serve_slot``:

      * The TTI index ``k`` never resets; ``advance(until_s)`` executes
        TTIs with start time strictly before ``until_s`` and returns the
        flows that finished, with *absolute* enqueue/finish timestamps.
      * A UE with several frames in flight is served head-of-line: only
        its earliest un-drained flow is active per TTI (one byte queue
        per UE, frames are segments of it).
      * Rng discipline: per executed TTI one uniform is drawn per flow of
        every *unretired* cohort, in admission order; a cohort retires
        when ALL its flows have drained.  With one cohort in flight at a
        time (the degenerate lock-step case) this is draw-for-draw the
        ``serve_slot`` stream -- ``len(requests)`` uniforms per TTI until
        the slot drains -- so the timeline engine configured degenerate
        replays the lock-step grant trace exactly.
      * TTIs where no flow is active are skipped without drawing (the
        clock jumps to the next enqueue, like serve_slot's idle-gap jump).
    """

    def __init__(self, cell: RanCell):
        self.cell = cell
        self.cfg = cell.cfg
        self._k = 0                      # continuous TTI index
        self._flows: List[StreamFlow] = []   # admission order
        self._cohort_open: Dict[int, int] = {}   # cohort -> undrained count

    def enqueue(self, req: UplinkRequest, cohort: int,
                meta: object = None) -> StreamFlow:
        flow = StreamFlow(req=req, cohort=cohort, meta=meta,
                          rem_bits=req.n_bytes * 8.0,
                          bpp=float(self.cell.bits_per_prb(req.link_rate_bps)))
        self._flows.append(flow)
        self._cohort_open[cohort] = self._cohort_open.get(cohort, 0) + 1
        return flow

    def advance(self, until_s: float,
                harq_rng: np.random.Generator) -> List[StreamFlow]:
        """Run TTIs whose start is before ``until_s`` (pass ``inf`` to
        drain).  Returns flows completed during this advance."""
        cfg = self.cfg
        finished: List[StreamFlow] = []
        steps = 0
        while True:
            live = [f for f in self._flows if not f.done]
            if not live:
                break
            now = self._k * cfg.tti_s
            if now >= until_s - 1e-12:
                break
            enq = np.array([f.req.enqueue_s for f in live])
            if not np.any(enq <= now):
                nxt = int(math.ceil(float(enq.min()) / cfg.tti_s))
                if nxt * cfg.tti_s >= until_s - 1e-12:
                    break
                self._k = max(self._k, nxt)
                continue
            if steps >= cfg.max_slots:
                raise RuntimeError(
                    f"RanStream: uplink queues not drained after "
                    f"{cfg.max_slots} TTIs in one advance; raise "
                    f"RanConfig.max_slots or reduce the offered load")
            # draw list: every flow of an unretired cohort, admission order
            drawn = [f for f in self._flows
                     if self._cohort_open.get(f.cohort, 0) > 0]
            n = len(drawn)
            # head-of-line: only a UE's earliest un-drained flow is active
            # (frames are segments of ONE per-UE byte queue; a drained
            # flow does not block its UE's later frames)
            hol_seen = set()
            active = np.zeros(n, bool)
            for i, f in enumerate(drawn):
                if f.done or f.req.ue_id in hol_seen:
                    continue
                hol_seen.add(f.req.ue_id)
                if f.req.enqueue_s <= now:
                    active[i] = True
            view = SlotView(
                now_s=now, tti_s=cfg.tti_s, active=active,
                remaining_bits=np.array([f.rem_bits for f in drawn]),
                bits_per_prb=np.array([f.bpp for f in drawn]),
                deadline_s=np.array([f.req.deadline_s for f in drawn]),
                ue_ids=np.array([f.req.ue_id for f in drawn]),
                n_prbs=cfg.n_prbs)
            if active.any():
                alloc = self.cell.policy.grant(view)
                assert alloc.sum() <= cfg.n_prbs, \
                    f"{self.cell.policy.name} over-granted the PRB grid"
            else:
                alloc = np.zeros(n, int)
            sent = np.minimum(view.remaining_bits, alloc * view.bits_per_prb)
            fail = (harq_rng.random(n) < cfg.bler_target) & (alloc > 0)
            delivered = np.where(fail, 0.0, sent)
            for i, f in enumerate(drawn):
                if f.done:
                    continue
                f.rem_bits -= delivered[i]
                f.granted += int(alloc[i])
                f.act_slots += int(active[i])
                f.n_tx += int(alloc[i] > 0)
                f.n_retx += int(fail[i])
                if f.rem_bits <= 1e-9:
                    f.rem_bits = 0.0
                    f.finish_s = now + cfg.tti_s
                    finished.append(f)
                    self._cohort_open[f.cohort] -= 1
                    if self._cohort_open[f.cohort] == 0:
                        self._retire(f.cohort)
            self.cell.policy.observe(delivered, view)
            self._k += 1
            steps += 1
        return finished

    def _retire(self, cohort: int):
        """Drop a fully-drained cohort's flows: they no longer count in
        the draw list, so keeping them would only make every later TTI
        rescan an ever-growing history (long streaming runs would go
        quadratic in elapsed frames)."""
        del self._cohort_open[cohort]
        self._flows = [f for f in self._flows
                       if not f.done or self._cohort_open.get(f.cohort, 0) > 0]

    def migrate_ue(self, ue_id: int) -> List[StreamFlow]:
        """Pop every unfinished flow of one UE (handover: its byte queue
        leaves this cell).  The popped flows stop counting toward their
        cohorts here -- a cohort whose remaining flows are all drained
        retires exactly as if the migrated flows had finished -- so the
        surviving UEs' HARQ draw discipline is unchanged from the TTI
        after the migration on.  Flows come back in admission order with
        their accumulated grant/HARQ statistics intact; the in-flight
        transport block is the *caller's* loss to account (the target
        cell cannot soft-combine another cell's HARQ process)."""
        mine = [f for f in self._flows if not f.done and f.req.ue_id == ue_id]
        mine_ids = {id(f) for f in mine}
        for f in mine:
            self._cohort_open[f.cohort] -= 1
        self._flows = [f for f in self._flows if id(f) not in mine_ids]
        for cohort in {f.cohort for f in mine}:
            if self._cohort_open.get(cohort, 0) == 0:
                self._retire(cohort)
        return mine

    def migrate_ues(self, ue_ids: Sequence[int],
                    flush_tb: bool = False) -> List[List[StreamFlow]]:
        """Batched park (blackout / evacuation plumbing): pop every
        listed UE's unfinished flows, one list per requested UE.  The
        oracle semantics ARE the per-UE ``migrate_ue`` loop; the
        vectorized twin (core/ran_vec.py) does the same pop with ONE
        array compaction.  ``flush_tb=True`` charges each popped flow's
        in-flight HARQ transport block as a loss -- the caller-side rule
        every park site applies."""
        out = [self.migrate_ue(u) for u in ue_ids]
        if flush_tb:
            for fls in out:
                for f in fls:
                    if f.granted > f.granted_at_admit:
                        f.n_retx += 1
        return out

    def adopt_batch(self, flows: Sequence[StreamFlow], enqueue_s: float,
                    cohort: int) -> List[StreamFlow]:
        """Batched twin of ``adopt``: re-admit parked flows in order,
        each re-enqueued at ``max(its own enqueue, enqueue_s)`` (a flow
        parked before it would have entered keeps its own instant)."""
        return [self.adopt(f, max(f.req.enqueue_s, enqueue_s), cohort)
                for f in flows]

    def adopt(self, flow: StreamFlow, enqueue_s: float,
              cohort: int) -> StreamFlow:
        """Admit a migrated flow: remaining bytes re-enqueue here at
        ``enqueue_s`` (handover instant + path-relocation gap), spectral
        efficiency re-derives from THIS cell's grid, and the flow joins a
        fresh local cohort.  Grant/HARQ counters carry over so the
        frame's eventual ``GrantReport`` spans both cells."""
        req = dataclasses.replace(flow.req, enqueue_s=enqueue_s)
        nf = StreamFlow(req=req, cohort=cohort, meta=flow.meta,
                        rem_bits=flow.rem_bits,
                        bpp=float(self.cell.bits_per_prb(req.link_rate_bps)),
                        granted=flow.granted, act_slots=flow.act_slots,
                        n_tx=flow.n_tx, n_retx=flow.n_retx,
                        granted_at_admit=flow.granted)
        self._flows.append(nf)
        self._cohort_open[cohort] = self._cohort_open.get(cohort, 0) + 1
        return nf

    def report(self, flow: StreamFlow) -> GrantReport:
        """GrantReport for a drained flow (absolute timestamps)."""
        cfg = self.cfg
        tx_s = float(flow.finish_s - flow.req.enqueue_s)
        return GrantReport(
            ue_id=flow.req.ue_id, n_bytes=flow.req.n_bytes,
            enqueue_s=flow.req.enqueue_s, finish_s=float(flow.finish_s),
            tx_s=tx_s, granted_prbs=flow.granted,
            active_slots=flow.act_slots, n_tx=flow.n_tx,
            n_harq_retx=flow.n_retx,
            realized_rate_bps=(flow.req.n_bytes * 8.0 / tx_s
                               if tx_s > 0 else 0.0),
            prb_share=(flow.granted / (cfg.n_prbs * flow.act_slots)
                       if flow.act_slots else 0.0),
            mcs=mcs_index(flow.bpp))

    @property
    def backlog_bytes(self) -> float:
        return sum(f.rem_bits for f in self._flows if not f.done) / 8.0

    def telemetry_sample(self) -> Dict[str, float]:
        """MAC-state observation for the telemetry plane
        (core/telemetry.py counter tracks).  Pure read of scheduler
        state -- no draws, no mutation -- and shared field-for-field
        with the vectorized twin (core/ran_vec.py), so traces are
        engine-agnostic."""
        live = sum(1 for f in self._flows if not f.done)
        return {"tti": float(self._k),
                "backlog_bytes": float(self.backlog_bytes),
                "live_flows": float(live),
                "open_cohorts": float(len(self._cohort_open))}
