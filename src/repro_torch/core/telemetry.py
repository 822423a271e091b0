"""A copy of ``repro/core/telemetry.py`` (numpy only).

Unified telemetry plane: per-frame spans, metrics registry, cause
attribution -- the observability substrate under every engine.

The paper's headline contribution is *measurement*: per-stage timelines
(Fig.-level latency/energy decompositions) on a real AI-RAN testbed.
Our engines already compute every timestamp those figures need --
``FrameLog`` carries the full additive stage decomposition, the MAC's
``GrantReport`` carries the grant/HARQ story, ``BatchRecord`` the edge's
busy intervals, ``ChaosModel.transitions`` the failure timeline.  This
module only *collects* them:

  * ``Telemetry`` is a run-scoped recorder threaded through the engines
    (``CellSimulator(telemetry=...)``).  Hooks are pure observers of
    values the engines compute anyway -- **no rng draws, no float
    arithmetic that feeds back into the simulation** -- so a run with
    telemetry attached replays a telemetry-free run bitwise
    (tests/test_telemetry.py asserts this against the golden fixtures).
  * Per-frame **spans** decompose each frame's capture->done interval:
    pre_wait (UE compute busy), head, encode, mac_queue (MAC wait =
    ``tx_s - air_s``), uplink_air, upf_path, edge_queue, tail_batch.
    ``account_stage`` makes the decomposition additive by construction
    (``delay_s`` is exactly the sum), so the spans tile the interval
    with zero gaps.  Frames that never produced a detection get a
    terminal **cause span** (``drop:<cause>`` / ``lost:<cause>``)
    covering the remainder of capture->deadline, so every missed
    frame's budget interval is fully attributed.
  * A **metrics registry** of counters / gauges / histograms with FIXED
    bucket edges and no wall-clock reads, snapshotable mid-run.
  * Cell-resource tracks: MAC cohort spans + backlog/PRB counter
    samples, edge busy spans, and a chaos track (outage windows with
    detect -> failover -> recover instants) derived post-run from the
    ground-truth schedule -- zero overhead while the run executes.

Export lives in ``core/trace_export.py`` (Chrome-trace/Perfetto JSON +
flat JSONL).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# cause taxonomy
# ---------------------------------------------------------------------------

#: Why a frame missed its deadline (dominant-stage attribution) or was
#: destroyed outright.  ``miss_cause`` maps a FrameLog onto this set.
CAUSE_HEAD = "head_compute"        # UE-side compute (head + encode + wait)
CAUSE_MAC = "mac_starved"          # MAC queueing: enqueued, not granted
CAUSE_HARQ = "harq_retx"           # airtime inflated by retransmissions
CAUSE_AIR = "uplink_air"           # plain airtime (narrow grant / big payload)
CAUSE_PATH = "upf_path"            # user-plane traversal (cUPF detour)
CAUSE_EDGE_QUEUE = "edge_queue"    # waiting for the edge batcher
CAUSE_TAIL = "tail_batch"          # edge compute itself
CAUSE_WINDOW = "inflight_window"   # capture skipped: window full
CAUSE_EDGE_OUT = "edge_outage"     # destroyed: edge down, drop policy
CAUSE_UPF_OUT = "upf_outage"       # destroyed: lost on a down user plane

CAUSES = (CAUSE_HEAD, CAUSE_MAC, CAUSE_HARQ, CAUSE_AIR, CAUSE_PATH,
          CAUSE_EDGE_QUEUE, CAUSE_TAIL, CAUSE_WINDOW, CAUSE_EDGE_OUT,
          CAUSE_UPF_OUT)


def miss_cause(log) -> str:
    """Attribute one FrameLog's deadline miss to its dominant stage.

    Destroyed frames carry their injected fault (``drop_reason``);
    window-skipped captures are ``inflight_window``; completed-but-late
    frames get the stage that consumed the largest share of the delay
    (ties resolve in the fixed order above -- fully deterministic)."""
    if getattr(log, "drop_reason", ""):
        return log.drop_reason
    if log.dropped:
        return CAUSE_WINDOW
    stage_sum = (log.head_s + log.quant_s + log.tx_s + log.path_s
                 + log.queue_s + log.tail_s)
    extra_wait = max(log.delay_s - stage_sum, 0.0)
    comps = {
        CAUSE_HEAD: log.head_s + log.quant_s + extra_wait,
        CAUSE_MAC: max(log.tx_s - log.air_s, 0.0),
        CAUSE_AIR: log.air_s,
        CAUSE_PATH: log.path_s,
        CAUSE_EDGE_QUEUE: log.queue_s,
        CAUSE_TAIL: log.tail_s,
    }
    worst = max(comps, key=lambda k: (comps[k], -CAUSES.index(k)))
    if worst == CAUSE_AIR and log.harq_retx > 0:
        return CAUSE_HARQ
    return worst


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

#: Fixed bucket edges (seconds).  Shared by every latency histogram so
#: snapshots are comparable across engines and runs; values are pure
#: constants -- bucketing can never drift with the data.
LATENCY_EDGES_S = (0.001, 0.002, 0.005, 0.01, 0.02, 0.05, 0.1, 0.2,
                   0.5, 1.0, 2.0, 5.0, 10.0, 30.0)
SHARE_EDGES = (0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)
SIZE_EDGES = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0):
        self.value += v


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float):
        self.value = float(v)


class Histogram:
    """Fixed-edge histogram: ``counts[i]`` holds observations
    ``<= edges[i]``, the last slot is the overflow bucket.  Edges are
    immutable after construction; no wall-clock anywhere."""
    __slots__ = ("edges", "counts", "sum", "count")

    def __init__(self, edges: Sequence[float] = LATENCY_EDGES_S):
        self.edges = tuple(float(e) for e in edges)
        if list(self.edges) != sorted(set(self.edges)):
            raise ValueError("histogram edges must be strictly increasing")
        self.counts = [0] * (len(self.edges) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float):
        v = float(v)
        i = int(np.searchsorted(self.edges, v, side="left"))
        self.counts[i] += 1
        self.sum += v
        self.count += 1

    def observe_many(self, vs):
        """Vectorized feed for the post-drain bulk paths (one searchsorted
        over the array instead of one python call per observation)."""
        vs = np.asarray(vs, float).ravel()
        if not vs.size:
            return
        idx = np.searchsorted(self.edges, vs, side="left")
        binned = np.bincount(idx, minlength=len(self.counts))
        for i, c in enumerate(binned):
            self.counts[i] += int(c)
        self.sum += float(vs.sum())
        self.count += int(vs.size)


class MetricsRegistry:
    """Named counters / gauges / histograms, snapshotable mid-run.

    Instruments are created on first touch and keep insertion identity;
    ``snapshot()`` is a plain sorted-key dict (JSON-ready) and reads no
    clocks, so two runs feeding identical values snapshot identically."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str,
                  edges: Sequence[float] = LATENCY_EDGES_S) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(edges)
        elif tuple(float(e) for e in edges) != h.edges:
            raise ValueError(f"histogram {name!r} re-registered with "
                             f"different edges")
        return h

    def snapshot(self) -> Dict[str, Any]:
        return {
            "counters": {k: c.value
                         for k, c in sorted(self._counters.items())},
            "gauges": {k: g.value for k, g in sorted(self._gauges.items())},
            "histograms": {
                k: {"edges": list(h.edges), "counts": list(h.counts),
                    "sum": h.sum, "count": h.count}
                for k, h in sorted(self._histograms.items())},
        }


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

@dataclass
class Span:
    """One closed interval on some track.  ``cat`` picks the track
    family: "frame" (per-UE stage spans), "cause" (terminal attribution
    on missed frames), "mac" (per-cell cohort grants), "edge" (per-cell
    batch executions), "chaos" (injected fault windows)."""
    __slots__ = ("name", "cat", "t0", "t1", "ue", "cell", "frame_idx",
                 "attrs")
    name: str
    cat: str
    t0: float
    t1: float
    ue: int
    cell: int
    frame_idx: int
    attrs: Optional[Dict[str, Any]]


#: (stage span name, FrameLog duration reader) in timeline order.  The
#: readers mirror account_stage's delay sum term-for-term, so the spans
#: tile capture -> capture+delay exactly.
_FRAME_STAGES = (
    ("head", lambda l: l.head_s),
    ("encode", lambda l: l.quant_s),
    ("mac_queue", lambda l: max(l.tx_s - l.air_s, 0.0)),
    ("uplink_air", lambda l: min(l.air_s, l.tx_s) if l.tx_s else l.air_s),
    ("upf_path", lambda l: l.path_s),
    ("edge_queue", lambda l: l.queue_s),
    ("tail_batch", lambda l: l.tail_s),
)


class Telemetry:
    """Run-scoped telemetry recorder.

    Create one, pass it as ``CellSimulator(telemetry=...)`` (or
    ``SplitInferencePipeline(telemetry=...)``), run, then export with
    ``core.trace_export``.  All engine hooks are gated on the attribute
    being non-None and only *read* already-computed timestamps, so the
    simulation itself is bit-identical with or without one attached."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry or MetricsRegistry()
        self.spans: List[Span] = []
        self.instants: List[Dict[str, Any]] = []
        # counter-track samples: (t, name, cell, value) -- sim-time KPM
        # series for the exporter's "C" events
        self.samples: List[Tuple[float, str, int, float]] = []
        self.meta: Dict[str, Any] = {"engine": "", "clock": "absolute",
                                     "n_ues": 0, "n_cells": 1}

    # -- run lifecycle -------------------------------------------------------
    def begin_run(self, engine: str, clock: str, n_ues: int,
                  n_cells: int = 1):
        """Record the engine/clock this run's timestamps live on.
        ``clock="absolute"``: one shared timeline (event engine).
        ``clock="slot"``: each frame's times are slot-relative and the
        exporter lays frames out at a fixed pitch."""
        self.meta.update(engine=engine, clock=clock, n_ues=int(n_ues),
                         n_cells=int(n_cells))

    # -- per-frame spans (engine-agnostic: everything is in the FrameLog) ----
    def record_frame_log(self, log):
        """Decompose one finished FrameLog into stage spans + registry
        feeds.  Works identically for the lock-step and event engines:
        ``capture_s`` anchors the frame (0 on lock-step slots, absolute
        on the event timeline) and ``delay_s`` is the exact stage sum."""
        reg = self.registry
        reg.counter("frames_total").inc()
        t = log.capture_s
        stage_sum = (log.head_s + log.quant_s + log.tx_s + log.path_s
                     + log.queue_s + log.tail_s)
        pre_wait = max(log.delay_s - stage_sum, 0.0)
        if pre_wait > 0.0:
            self.spans.append(Span("pre_wait", "frame", t, t + pre_wait,
                                   log.ue_id, log.serving_cell,
                                   log.frame_idx, None))
            t += pre_wait
        for name, dur_of in _FRAME_STAGES:
            d = dur_of(log)
            if d <= 0.0:
                continue
            attrs = None
            if name == "uplink_air" and log.harq_retx:
                attrs = {"harq_retx": log.harq_retx}
            elif name == "tail_batch" and log.batch_size > 1:
                attrs = {"batch_size": log.batch_size}
            self.spans.append(Span(name, "frame", t, t + d, log.ue_id,
                                   log.serving_cell, log.frame_idx, attrs))
            t += d
        if log.dropped:
            # destroyed (chaos) or skipped (window): the partial stage
            # spans above cover what the frame got to execute; the cause
            # span attributes the remainder of its budget interval.
            # (Window skips have all-zero stages, so the cause span IS
            # the whole capture->deadline interval.)
            cause = log.drop_reason or CAUSE_WINDOW
            reg.counter("frames_lost_total").inc()
            reg.counter(f"frames_lost_total:{cause}").inc()
            t_loss = log.capture_s + log.age_s
            self.instant(f"lost:{cause}", t_loss, ue=log.ue_id,
                         cell=log.serving_cell, frame_idx=log.frame_idx)
            if log.deadline_s != float("inf") \
                    and log.deadline_s > min(t_loss, log.deadline_s):
                self.spans.append(Span(
                    f"drop:{cause}", "cause", min(t_loss, log.deadline_s),
                    log.deadline_s, log.ue_id, log.serving_cell,
                    log.frame_idx, None))
            return
        reg.counter("frames_completed_total").inc()
        reg.counter("bytes_uplinked_total").inc(log.compressed_bytes)
        reg.counter("harq_retx_total").inc(log.harq_retx)
        reg.histogram("frame_delay_s", LATENCY_EDGES_S).observe(log.delay_s)
        reg.histogram("frame_age_s", LATENCY_EDGES_S).observe(log.age_s)
        reg.histogram("edge_queue_s", LATENCY_EDGES_S).observe(log.queue_s)
        if log.deadline_miss:
            cause = miss_cause(log)
            reg.counter("deadline_miss_total").inc()
            reg.counter(f"deadline_miss_total:{cause}").inc()
            if log.deadline_s != float("inf"):
                # the frame DID complete -- the cause span marks the
                # overrun tail past the deadline for the trace viewer
                self.spans.append(Span(
                    f"miss:{cause}", "cause", log.deadline_s,
                    log.capture_s + log.delay_s, log.ue_id,
                    log.serving_cell, log.frame_idx, None))

    # -- cell resource tracks ------------------------------------------------
    def mac_cohort(self, cell: int, cohort: int, reports: Sequence[Any]):
        """One delivered TTI cohort (the event engine's per-capture-round
        admission group): a span from the cohort's first enqueue to its
        last finish, with per-UE PRB shares riding as attrs."""
        if not reports:
            return
        t0 = min(r.enqueue_s for r in reports)
        t1 = max(r.finish_s for r in reports)
        shares = {int(r.ue_id): round(float(r.prb_share), 4)
                  for r in reports}
        self.spans.append(Span(
            f"cohort {cohort}", "mac", t0, max(t1, t0), -1, cell, -1,
            {"n_flows": len(reports), "prb_share": shares,
             "harq_retx": int(sum(r.n_harq_retx for r in reports))}))
        reg = self.registry
        h = reg.histogram("mac_prb_share", SHARE_EDGES)
        for r in reports:
            h.observe(r.prb_share)
            reg.histogram("mac_tx_s", LATENCY_EDGES_S).observe(r.tx_s)

    def mac_flows_bulk(self, cell: int, flows: Sequence[Any],
                       tti_s: float, n_prbs: int):
        """Vectorized post-drain materialization for the city-scale MAC
        (core/ran_vec.py): one numpy pass over the drained ``StreamFlow``
        batch instead of per-flow ``report()`` objects, so tracing a
        10k-flow drain stays a small fraction of the drain itself."""
        if not flows:
            return
        enq = np.array([f.req.enqueue_s for f in flows])
        fin = np.array([f.finish_s for f in flows])
        act = np.array([f.act_slots for f in flows], float)
        grt = np.array([f.granted for f in flows], float)
        tx = fin - enq
        share = np.where(act > 0, grt / (n_prbs * np.maximum(act, 1)), 0.0)
        reg = self.registry
        reg.histogram("mac_tx_s", LATENCY_EDGES_S).observe_many(tx)
        reg.histogram("mac_prb_share", SHARE_EDGES).observe_many(share)
        reg.counter("harq_retx_total").inc(
            float(sum(f.n_retx for f in flows)))
        reg.counter("mac_flows_total").inc(len(flows))
        self.spans.extend(
            Span("grant", "mac", float(e), float(f_), int(fl.req.ue_id),
                 cell, -1, None)
            for e, f_, fl in zip(enq, fin, flows))

    def sample(self, t: float, name: str, value: float, cell: int = 0):
        """One sim-time counter-track sample (exporter "C" events)."""
        self.samples.append((float(t), name, int(cell), float(value)))

    def mac_sample(self, cell: int, t: float, sample: Dict[str, float]):
        """Counter-track sample from a MAC stream's telemetry_sample()."""
        for k, v in sample.items():
            self.sample(t, f"mac_{k}", v, cell)
        if "backlog_bytes" in sample:
            self.registry.gauge(f"mac_backlog_bytes:cell{cell}").set(
                sample["backlog_bytes"])

    def edge_batch(self, rec, cell: int = 0):
        """One executed edge batch (BatchRecord) -> edge busy span."""
        self.spans.append(Span(
            f"tail[{rec.option} x{rec.size}]", "edge", rec.start_s,
            rec.start_s + rec.compute_s, -1, cell, -1,
            {"option": rec.option, "size": rec.size, "padded": rec.padded}))
        reg = self.registry
        reg.counter("edge_batches_total").inc()
        reg.counter("edge_busy_s_total").inc(rec.compute_s)
        reg.histogram("edge_batch_size", SIZE_EDGES).observe(rec.size)

    # -- instants ------------------------------------------------------------
    def instant(self, name: str, t: float, ue: int = -1, cell: int = 0,
                **attrs):
        ev = {"name": name, "t": float(t), "ue": int(ue), "cell": int(cell)}
        if attrs:
            ev.update(attrs)
        self.instants.append(ev)
        self.registry.counter(f"events_total:{name}").inc()

    # -- chaos track (derived post-run; zero overhead while running) ---------
    def record_chaos(self, chaos):
        """Materialize the chaos track from the ground-truth schedule and
        the heartbeat detector's transition log (core/chaos.py): outage
        windows as spans, detect / failover / failback / recover edges as
        instants -- detect -> failover -> reconverge reads straight off
        the track."""
        if chaos is None:
            return
        for name, t, attrs in chaos.telemetry_events():
            if "t1" in attrs:
                cell = int(attrs.get("cell", 0))
                self.spans.append(Span(name, "chaos", t, attrs["t1"], -1,
                                       cell, -1,
                                       {k: v for k, v in attrs.items()
                                        if k not in ("t1", "cell")} or None))
            else:
                self.instant(name, t, **attrs)

    # -- derived summaries ---------------------------------------------------
    def miss_summary(self, logs) -> Dict[str, int]:
        """Cause -> count over the run's deadline misses (drops included).
        Pure function of the logs; used by the demo's summary line."""
        out: Dict[str, int] = {}
        for log in logs:
            if log.deadline_miss:
                c = miss_cause(log)
                out[c] = out.get(c, 0) + 1
        return dict(sorted(out.items(), key=lambda kv: (-kv[1], kv[0])))

    def coverage(self, logs) -> Dict[Tuple[int, int], float]:
        """Per missed frame: fraction of the capture->deadline interval
        covered by this run's spans (union of frame+cause spans clipped
        to the interval).  The tentpole's acceptance bar is >= 0.99."""
        spans_by_frame: Dict[Tuple[int, int], List[Tuple[float, float]]] = {}
        for s in self.spans:
            if s.frame_idx >= 0 and s.ue >= 0:
                spans_by_frame.setdefault((s.ue, s.frame_idx), []).append(
                    (s.t0, s.t1))
        out: Dict[Tuple[int, int], float] = {}
        for log in logs:
            if not log.deadline_miss or log.deadline_s == float("inf"):
                continue
            lo, hi = log.capture_s, log.deadline_s
            if hi <= lo:
                continue
            ivs = sorted((max(a, lo), min(b, hi))
                         for a, b in spans_by_frame.get(
                             (log.ue_id, log.frame_idx), [])
                         if b > lo and a < hi)
            covered = 0.0
            end = lo
            for a, b in ivs:
                a = max(a, end)
                if b > a:
                    covered += b - a
                    end = b
            out[(log.ue_id, log.frame_idx)] = float(covered / (hi - lo))
        return out
