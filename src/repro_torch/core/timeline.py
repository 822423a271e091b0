"""Continuous-time event engine: asynchronous capture, streaming overlap.

The counterpart of ``repro/core/timeline.py``, on the port's cell,
stages and MAC, with every rng draw and float expression in the same
order.  ``engine="vectorized"`` drives the port's vectorized MAC
(core/ran_vec.py) on the simulator's device.

The lock-step engines (``SplitInferencePipeline.run_trace``,
``CellSimulator.run``) restart the clock at zero every frame-slot: all
UEs capture simultaneously, the MAC and the edge batcher drain to
completion inside the slot, and congestion can never spill into the next
frame.  Real streaming detection over a loaded cell is the opposite
regime -- frame N+1's head overlaps frame N's uplink, a congested slot's
overflow delays (or drops) the next frame, and deadlines are anchored at
capture on one absolute clock.  This module runs the SAME stages
(core/pipeline.py), the same calibrated models, and the same per-UE rng
streams on that absolute clock:

  * every UE has its own frame clock -- configurable per-UE fps and
    capture jitter, heterogeneous across the cell;
  * the UE pipelines: head/encode of frame N+1 overlaps uplink of frame
    N, bounded by an ``inflight`` window; when the window is full the
    frame is *skipped* and logged as dropped;
  * uplinks run through ``ran.RanStream`` -- a continuous TTI clock with
    per-UE byte queues persisting across frames -- or, with ``ran=None``,
    through a per-UE serial radio (frame N+1's transmission queues
    behind frame N's);
  * the edge is an event queue (``EdgeQueue``): batch busy time carries
    over between frames and utilization is measured against wall-clock,
    not per-slot makespans;
  * ``FrameLog`` gains ``capture_s``/``age_s``/``dropped`` and the
    deadline is the absolute instant ``capture + budget``, so cross-slot
    lateness is countable.

**Lock-step equivalence.**  Configured degenerate -- uniform fps, zero
jitter, unbounded in-flight window, load light enough that nothing
carries over -- every capture round is exactly one lock-step slot: the
same vectorized fading draw, the same path-jitter draw, the same HARQ
stream (``RanStream`` retires cohorts the way ``serve_slot`` drains
slots), the same batch formation.  The engine then reproduces the
lock-step per-frame delay/energy logs (bitwise for the legacy radio,
within float/TTI-alignment tolerance for the RAN).  The rng-pairing discipline from the
RAN layer is preserved: same seed + same config => identical trace, and
streaming-vs-lock-step comparisons see identical fading realizations.

Determinism note: batch *start* times keep the lock-step oracle
``max(last arrival, edge free)``, but batch *membership* is only acted
on once it is determined at the current watermark (no future arrival
can join) -- the skip policy therefore sees exactly the completions a
causal batcher would have produced.

**Mobility (core/mobility.py).**  With ``CellSimulator.mobility`` set,
every capture event first advances the UE's trajectory and correlated
shadowing/Doppler state (a dedicated rng stream; the shared fading/path
draws never move), scales the round's shared fading draw by the serving
cell's excess loss, and routes the path draw through the serving site's
``PathModel``.  A3 handovers fire on this absolute clock: the UE's byte
queue migrates between the ``MultiCell`` streams, the in-flight HARQ
transport block is flushed as a loss, the uplink stalls for the
relocation gap, and the controller's granted-rate estimate resets.  The
degenerate ``static_mobility`` configuration (one cell, UEs parked at
the reference distance, zero-sigma stochastic layers) reproduces the
mobility-free engine bitwise.
"""
from __future__ import annotations

import math
from bisect import insort
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.cell import (BatchRecord, CellResult, CellSimulator,
                                   ServedTail, TailBatcher, TailRequest)
from repro_torch.core.chaos import EDGE_WORKER, UPF_WORKER
from repro_torch.core.channel import sample_path_latencies
from repro_torch.core.energy import interval_energy_j
from repro_torch.core.pipeline import (EncodeResult, FrameLog, FrameSource,
                                       HeadResult, UplinkResult, account_stage,
                                       decide_stage, encode_group_stage,
                                       head_encode_stage, sense_stage)
from repro_torch.core.ran import MultiCell, RanStream, UplinkRequest
from repro_torch.core.ran_vec import VecRanStream, _merge_parked
from repro_torch.core.splitting import UE_ONLY


# ---------------------------------------------------------------------------
# the edge event queue
# ---------------------------------------------------------------------------

class EdgeQueue:
    """``TailBatcher`` semantics on an absolute clock.

    Requests arrive with absolute timestamps; batches form by the same
    rules the lock-step batcher uses (same-option, close when the next
    same-option arrival exceeds ``max_wait_s`` past the first, or the
    largest bucket fills) but the edge's busy time persists across
    frames: a batch starts at ``max(last member arrival, edge_free)``
    and ``edge_free`` never resets.

    ``flush(watermark)`` executes every batch whose membership is
    *determined* at the watermark -- either the bucket filled with all
    members arrived, or the batching window has fully elapsed, so no
    not-yet-seen arrival can still join.  Batches still inside their
    window stay pending (the causal batcher is still waiting for them).

    Failure injection (core/chaos.py): ``outages`` are absolute
    (start, end) windows during which the edge server is down.  Policy
    ``drop=True`` rejects requests *arriving* inside a window (``add``
    returns False; the engine logs the frame lost); ``drop=False``
    re-queues -- batches whose execution would overlap an outage are
    deferred to the window's end plus ``warmup_s`` (cold caches / model
    re-load on recovery).  Empty ``outages`` leaves every code path
    bitwise identical to the pre-chaos queue.
    """

    def __init__(self, batcher: TailBatcher, *,
                 outages: Sequence[Tuple[float, float]] = (),
                 warmup_s: float = 0.0, drop: bool = False):
        self.b = batcher
        self.edge_free = 0.0
        self.outages = sorted(outages)
        self.warmup_s = warmup_s
        self.drop = drop
        self._pending: Dict[str, List[TailRequest]] = {}

    def add(self, req: TailRequest) -> bool:
        if self.drop and any(a <= req.arrival_s < b
                             for a, b in self.outages):
            return False
        group = self._pending.setdefault(req.option, [])
        insort(group, req, key=lambda r: (r.arrival_s, r.ue_id))
        return True

    def _next_batch(self, group: List[TailRequest], watermark: float
                    ) -> Optional[List[TailRequest]]:
        """Leading determined batch of a sorted group, or None."""
        if not self.b.batching:
            return [group[0]] if group[0].arrival_s <= watermark else None
        cap = self.b.buckets[-1]
        first = group[0]
        batch = [first]
        for r in group[1:]:
            if (r.arrival_s > first.arrival_s + self.b.max_wait_s
                    or len(batch) >= cap):
                break
            batch.append(r)
        if len(batch) >= cap and batch[-1].arrival_s <= watermark:
            return batch                       # bucket full, members fixed
        if first.arrival_s + self.b.max_wait_s <= watermark:
            return batch                       # window elapsed
        return None

    def flush(self, watermark: float
              ) -> List[Tuple[BatchRecord, List[Tuple[TailRequest,
                                                      ServedTail]]]]:
        """Execute all determined batches; returns (record, served) pairs
        in execution order."""
        ready: List[Tuple[float, float, str, List[TailRequest]]] = []
        for opt, group in self._pending.items():
            while group:
                batch = self._next_batch(group, watermark)
                if batch is None:
                    break
                del group[:len(batch)]
                ready.append((batch[-1].arrival_s, batch[0].arrival_s,
                              opt, batch))
        # the edge executes ready batches serially in close order (the
        # lock-step batcher's last-arrival sort)
        ready.sort(key=lambda x: (x[0], x[1], x[2]))
        out = []
        for _, _, opt, batch in ready:
            padded = self.b._bucket(len(batch)) if self.b.batching \
                else len(batch)
            compute_s = self.b.edge.batch_compute_time_s(
                self.b.plan.tail_flops(opt), padded)
            start = max(batch[-1].arrival_s, self.edge_free)
            for o0, o1 in self.outages:
                # requeue policy: execution may not overlap an outage --
                # defer to recovery + warm-up.  Windows are sorted and
                # each push only increases start, so one forward pass
                # lands on the first feasible gap.
                if start + compute_s > o0 and start < o1 + self.warmup_s:
                    start = o1 + self.warmup_s
            outs: List[Any] = [None] * len(batch)
            if self.b.execute_model:
                outs = self.b.plan.tail_batched(
                    [r.payload for r in batch], opt, pad_to=padded)
            served = [(r, ServedTail(tail_s=compute_s,
                                     queue_s=start - r.arrival_s,
                                     batch_size=len(batch), out=o))
                      for r, o in zip(batch, outs)]
            rec = BatchRecord(option=opt, size=len(batch), padded=padded,
                              start_s=start, compute_s=compute_s)
            self.edge_free = start + compute_s
            out.append((rec, served))
        return out

    @property
    def n_pending(self) -> int:
        return sum(len(g) for g in self._pending.values())


# ---------------------------------------------------------------------------
# per-frame record on the absolute clock
# ---------------------------------------------------------------------------

@dataclass
class _Frame:
    ue: int
    idx: int                      # per-UE capture index
    capture_s: float
    level: float
    option: str = ""
    pred: Any = None
    head: Optional[HeadResult] = None
    enc: Optional[EncodeResult] = None
    pre_wait_s: float = 0.0       # capture -> head start (UE compute busy)
    enq_s: float = 0.0            # encode done (absolute)
    offload: bool = False
    rate_bps: float = 0.0
    tx_s: float = 0.0             # enqueue -> delivered (wait + airtime)
    air_s: float = 0.0            # radio-active time only
    path_s: float = 0.0
    prb_share: float = 1.0
    harq_retx: int = 0
    deadline_s: float = float("inf")   # absolute (capture + budget)
    arrival_s: float = float("nan")    # at the edge queue
    done_s: float = float("nan")
    queue_s: float = 0.0
    tail_s: float = 0.0
    batch_size: int = 1
    out: Any = None
    final: bool = False
    # mobility (core/mobility.py; defaults = one eternal cell)
    serving_cell: int = 0         # serving cell at capture
    ho_count: int = 0             # UE's cumulative handovers at capture
    rate_scale: float = 1.0       # mobility rate multiplier this frame
    # chaos (core/chaos.py; defaults = nothing ever fails)
    drop_reason: str = ""         # set when an injected fault ate the frame
    routed_primary: bool = True   # False: rode the failover (cUPF) path


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _capture_times(n: int, n_frames: int, fps: np.ndarray,
                   jitter_s: np.ndarray,
                   rng: np.random.Generator) -> np.ndarray:
    """(n, n_frames) absolute capture instants: k / fps_u plus uniform
    capture jitter in [0, jitter_s), made monotone per UE."""
    t = np.empty((n, n_frames))
    for u in range(n):
        t[u] = np.arange(n_frames) / fps[u] + rng.random(n_frames) * jitter_s[u]
        t[u] = np.maximum.accumulate(t[u])
    return t


def _by_cell(ues: Sequence[int], mob) -> List[Tuple[int, List[int]]]:
    """Group UEs by serving cell, preserving the given UE order inside
    each group (= per-stream append order, so batched park/adopt stays
    field-exact vs the per-UE oracle loop).  No mobility = one cell."""
    groups: Dict[int, List[int]] = {}
    for u in ues:
        groups.setdefault(int(mob.serving[u]) if mob is not None else 0,
                          []).append(int(u))
    return sorted(groups.items())


@torch.no_grad()
def run_stream(sim: CellSimulator, interference, imgs=None,
               option: Optional[str] = None, *, fps=2.0, jitter_s=0.0,
               inflight: Optional[int] = None,
               budget_s: Optional[float] = None,
               keep_outputs: bool = False) -> CellResult:
    """Run ``sim``'s cell on the continuous-time event engine.

    ``interference``: (n_frames,) shared trace or (n_frames, n_ues)
    per-UE traces, indexed by each UE's own capture index.  ``fps`` /
    ``jitter_s`` are scalars or per-UE arrays; ``inflight`` bounds the
    per-UE frames concurrently in the pipeline (None = unbounded: never
    skip); ``budget_s`` overrides the deadline budget (None mirrors the
    lock-step engine: ``sim.frame_budget_s`` on a RAN cell, infinite on
    isolated links).  Resets seeded state first, exactly like
    ``CellSimulator.run``, so streaming-vs-lock-step comparisons are
    rng-paired."""
    if option is not None and option not in sim._head_s:
        raise ValueError(f"unknown option {option!r}; "
                         f"plan offers {sim.plan.options}")
    if sim.execute_model and imgs is None:
        raise ValueError("execute_model=True requires imgs "
                         "(use execute_model=False for accounting sweeps)")
    n = sim.n_ues
    trace = np.asarray(interference, float)
    if trace.ndim == 1:
        trace = trace[:, None]
    levels = np.broadcast_to(trace, (trace.shape[0], n))
    n_frames = levels.shape[0]
    fps = np.broadcast_to(np.asarray(fps, float), (n,)).astype(float)
    jitter_s = np.broadcast_to(np.asarray(jitter_s, float), (n,)).astype(float)
    if np.any(fps <= 0):
        raise ValueError("fps must be positive")
    if np.any(jitter_s < 0):
        raise ValueError("jitter_s must be non-negative")
    window = math.inf if inflight is None else int(inflight)
    if window != math.inf and window < 1:
        raise ValueError("inflight window must be >= 1 (or None)")
    budget = budget_s if budget_s is not None else (
        sim.frame_budget_s if sim.ran is not None else math.inf)

    sim.reset()
    # dedicated capture-jitter stream: children 0..n-1 are the per-UE
    # sensing rngs and child n the HARQ stream exactly as the lock-step
    # engine spawns them (SeedSequence children are index-stable), child
    # n+1 is ours alone -- no shared-stream draws move.  (Children n+2..
    # belong to the mobility model and the non-anchor cells' HARQ
    # streams; CellSimulator.reset spawns those.)
    jit_rng = np.random.default_rng(
        np.random.SeedSequence(sim.seed).spawn(n + 2)[-1])
    captures = _capture_times(n, n_frames, fps, jitter_s, jit_rng)
    src = FrameSource(imgs if sim.execute_model else None)
    mob = sim.mobility
    # chaos schedule: drawn NOW from its dedicated end-of-layout rng
    # child (cell.py reset), so the shared fading/path/jitter streams
    # above never move whether or not a ChaosModel rides along
    chaos = sim.chaos
    chaos_events: List[Tuple[float, str, Any]] = []
    if chaos is not None:
        chaos_events = chaos.begin(
            float(captures.max()) if captures.size else 0.0,
            n_cells=(mob.n_sites if mob is not None else 1))
    if sim.ran is None:
        streams, harq_rngs = None, []
    else:
        ran_cells = sim.ran.cells if isinstance(sim.ran, MultiCell) \
            else [sim.ran]
        if sim.engine == "vectorized":
            # the vectorized MAC (core/ran_vec.py): same API, same
            # draw-for-draw HARQ stream, field-exact flow reports -- the
            # event loop above this line cannot tell the engines apart
            streams = [VecRanStream(c, n, device=sim.device)
                       for c in ran_cells]
        else:
            streams = [RanStream(c) for c in ran_cells]
        # cell 0 keeps the simulator's original HARQ stream; extra cells
        # draw from their own dedicated children (cell.py reset)
        harq_rngs = sim._harq_rngs
        assert len(harq_rngs) == len(streams)
    edge = EdgeQueue(
        sim.batcher,
        outages=chaos.edge_windows if chaos is not None else (),
        warmup_s=chaos.cfg.edge_warmup_s if chaos is not None else 0.0,
        drop=chaos is not None and chaos.cfg.edge_policy == "drop")
    # telemetry plane (core/telemetry.py): every hook below is gated on
    # the attribute and only READS timestamps this engine computes
    # anyway -- no draws, no float feedback -- so telemetry on/off runs
    # are bitwise identical.
    tele = getattr(sim, "telemetry", None)
    if tele is not None:
        tele.begin_run(
            "stream/" + (sim.engine if sim.ran is not None else "legacy"),
            "absolute", n, n_cells=len(streams) if streams else 1)
    controllers = sim._controllers
    if controllers is not None:
        for u, c in enumerate(controllers):
            c.frame_period_s = 1.0 / fps[u]

    # rounds: captures grouped by identical absolute instant.  Degenerate
    # (uniform fps, zero jitter) every round is all n UEs at k/fps --
    # exactly one lock-step slot, in the same UE order.  Chaos events
    # (heartbeat ticks, blackout edges) merge onto the same timeline at
    # rank 0, so at an equal instant they act before the captures they
    # gate; capture rounds themselves are untouched (the group is
    # re-sorted below exactly as before).
    events: List[Tuple[float, int, str, Any, Any]] = [
        (captures[u][k], 1, "cap", u, k)
        for u in range(n) for k in range(n_frames)]
    events.extend((tc, 0, kind, payload, None)
                  for tc, kind, payload in chaos_events)
    events.sort(key=lambda e: (e[0], e[1]))
    frames: List[_Frame] = []
    dropped_logs: List[FrameLog] = []
    launched = np.zeros(n, int)
    done_times: List[List[float]] = [[] for _ in range(n)]
    compute_free = np.zeros(n)     # UE compute resource (head + encode)
    radio_free = np.zeros(n)       # UE radio resource (legacy regime)
    active_s = np.zeros(n)         # per-UE compute-active wall time
    outcome: List[Any] = [None] * n    # last delivered grant report
    gap_until = np.zeros(n)        # uplink stalled until (path relocation)
    mob_obs: List[Any] = [None] * n    # latest MobilityObs per UE
    parked: List[List[Any]] = [[] for _ in range(n)]   # blackout-parked flows
    cell_parked: Dict[int, List[int]] = {}   # cell-blackout window -> UEs
    cohort = 0

    by_req: Dict[int, _Frame] = {}

    def lose(fr: _Frame, t_loss: float, reason: str):
        """An injected fault destroyed this frame: final, counted against
        availability, its in-flight window slot freed at the loss
        instant.  The UE sees it exactly like a window drop (no
        detection arrived)."""
        fr.final = True
        fr.done_s = t_loss
        fr.drop_reason = reason
        done_times[fr.ue].append(t_loss)
        if reason == "edge_outage":
            sim.stats.n_lost_edge += 1
        else:
            sim.stats.n_lost_path += 1
        if controllers is not None:
            controllers[fr.ue].observe_stream(0.0, True)

    def submit(fr: _Frame):
        """Hand an arrived payload to the edge event queue."""
        req = TailRequest(ue_id=fr.ue, option=fr.option,
                          arrival_s=fr.arrival_s, payload=fr.enc.payload)
        if not edge.add(req):
            lose(fr, fr.arrival_s, "edge_outage")   # arrived mid-outage
            return
        by_req[id(req)] = fr

    def deliver(flows, strm, ci: int = 0):
        """MAC completions -> grant feedback + edge arrivals.  ``tx_s``
        spans from the frame's ORIGINAL encode-done instant, so a
        migrated flow's report covers the relocation gap and both cells'
        scheduling (the report's own enqueue re-anchors at adoption)."""
        by_cohort: Dict[int, List[Any]] = {}
        for f in flows:
            fr: _Frame = f.meta
            rep = strm.report(f)
            if tele is not None:
                by_cohort.setdefault(f.cohort, []).append(rep)
            fr.tx_s = float(rep.finish_s - fr.enq_s)
            fr.rate_bps = (rep.n_bytes * 8.0 / fr.tx_s) if fr.tx_s > 0 \
                else 0.0
            fr.air_s = (rep.granted_prbs * strm.cfg.tti_s
                        / strm.cfg.n_prbs)
            fr.prb_share = rep.prb_share
            fr.harq_retx = rep.n_harq_retx
            fr.arrival_s = rep.finish_s + fr.path_s
            assert fr.arrival_s >= fr.enq_s - 1e-9, "uplink went backwards"
            outcome[fr.ue] = rep
            if controllers is not None:
                controllers[fr.ue].observe_grant(fr.rate_bps)
            if chaos is not None:
                chaos.straggler.record(UPF_WORKER, fr.path_s)
                # the radio delivered, but the frame still has to cross
                # the user plane: a primary-routed packet entering a down
                # dUPF is lost in flight (failover-routed ones are not)
                if fr.routed_primary and chaos.upf_down(float(rep.finish_s)):
                    lose(fr, float(rep.finish_s), "upf_outage")
                    continue
            submit(fr)
        if tele is not None:
            for coh in sorted(by_cohort):
                tele.mac_cohort(ci, coh, by_cohort[coh])

    def serve(batches):
        """Edge executions -> frame completions."""
        for rec, served in batches:
            if chaos is not None:
                chaos.straggler.record(EDGE_WORKER, rec.compute_s)
            if tele is not None:
                tele.edge_batch(rec)
            sim.stats.absorb_batch(rec, [s for _, s in served])
            for req, sv in served:
                fr = by_req.pop(id(req))
                fr.queue_s, fr.tail_s = sv.queue_s, sv.tail_s
                fr.batch_size, fr.out = sv.batch_size, sv.out
                fr.done_s = rec.start_s + rec.compute_s
                assert fr.done_s >= fr.arrival_s - 1e-9, \
                    "tail finished before its payload arrived"
                finish(fr)

    def finish(fr: _Frame):
        fr.final = True
        done_times[fr.ue].append(fr.done_s)
        if controllers is not None:
            controllers[fr.ue].observe_stream(fr.done_s - fr.capture_s,
                                              False)

    prev_t = -math.inf
    i = 0
    while i < len(events):
        t = events[i][0]
        assert t >= prev_t, "event timeline went backwards"
        prev_t = t
        group = []
        chaos_here: List[Tuple[str, Any]] = []
        while i < len(events) and events[i][0] == t:
            _t, _rank, kind, a, b = events[i]
            if kind == "cap":
                group.append((a, b))                     # (ue, frame idx)
            else:
                chaos_here.append((kind, a))
            i += 1
        group.sort()
        # 1. advance the MACs and the edge to the event instant, so the
        #    in-flight window sees every completion up to now.  (For a
        #    chaos tick between captures this split advance executes the
        #    identical absolute-TTI sequence and draws the full advance
        #    would -- flush membership is monotone in the watermark -- so
        #    an inert chaos schedule stays bitwise.)
        if streams is not None:
            for ci, (s, hr) in enumerate(zip(streams, harq_rngs)):
                deliver(s.advance(t, hr), s, ci)
        serve(edge.flush(t))
        if tele is not None:
            # KPM counter tracks on the sim clock: MAC backlog / live
            # flows per cell (ran.py & ran_vec.py expose the identical
            # observation), edge congestion, cell assignment
            if streams is not None:
                for ci, s in enumerate(streams):
                    tele.mac_sample(ci, t, s.telemetry_sample())
            tele.sample(t, "edge_pending", edge.n_pending)
            if mob is not None:
                for k, v in mob.telemetry_sample().items():
                    tele.sample(t, k, v)

        # 1a. chaos events at this instant fire BEFORE the captures they
        #     gate.  Heartbeats run the detector (runtime/failures.py) on
        #     the absolute clock: detection transitions drive the
        #     failover state machine and the controllers' re-probe.
        #     Blackout edges ride the handover plumbing: park the UE's
        #     flows out of the MAC at rate->0, adopt them back at
        #     recovery so the backlog drains.
        for kind, payload in chaos_here:
            if kind == "heartbeat":
                for sig in chaos.heartbeat(t):
                    if sig in ("failover", "failback", "edge_up") \
                            and controllers is not None:
                        # the serving topology just changed under every
                        # UE: grant/stream estimates describe the FAULTED
                        # system -- reset and re-probe (notify_handover's
                        # discipline, plus the streaming EWMAs)
                        for c in controllers:
                            c.notify_outage()
            elif kind == "blackout_start":
                b_ues, b1 = payload
                for u in b_ues:
                    gap_until[u] = max(gap_until[u], b1)
                if streams is not None:
                    # ONE batched park per (event, cell): a K-UE blackout
                    # costs one array compaction, not K migrate_ue
                    # rebuilds; in-flight TB losses are flushed
                    # vectorized inside migrate_ues
                    for c, ues in _by_cell(b_ues, mob):
                        for u, part in zip(ues,
                                           streams[c].migrate_ues(
                                               ues, flush_tb=True)):
                            parked[u].append(part)
                else:
                    for u in b_ues:
                        radio_free[u] = max(radio_free[u], b1)
            elif kind == "blackout_end":
                if streams is not None:
                    # one batched adopt per current serving cell (the
                    # serving cell may have changed while parked)
                    for c, ues in _by_cell(payload, mob):
                        batch = _merge_parked(
                            [p for u in ues for p in parked[u]])
                        if len(batch):
                            streams[c].adopt_batch(batch, t, cohort)
                        for u in ues:
                            parked[u] = []
                if controllers is not None:
                    for u in payload:
                        controllers[u].notify_outage()
            elif kind == "cell_blackout_start":
                w, bc, b1 = payload
                # a weather front reached cell `bc`: its served UEs park
                # and the site takes an RSRP fault penalty, so A3 lets
                # them flee to a healthy neighbor (no gap pin -- frames
                # captured after evacuation ride the new cell)
                c_ues = [u for u in range(n)
                         if (int(mob.serving[u]) if mob is not None else 0)
                         == bc]
                cell_parked[w] = c_ues
                if mob is not None:
                    mob.set_site_fault(
                        bc, chaos.cfg.correlation.fault_penalty_db)
                else:
                    for u in c_ues:
                        gap_until[u] = max(gap_until[u], b1)
                if streams is not None:
                    for u, part in zip(c_ues,
                                       streams[bc].migrate_ues(
                                           c_ues, flush_tb=True)):
                        parked[u].append(part)
                elif mob is None:
                    for u in c_ues:
                        radio_free[u] = max(radio_free[u], b1)
                if tele is not None:
                    tele.instant("cell_blackout", t, cell=bc,
                                 n_parked=len(c_ues))
            elif kind == "cell_blackout_end":
                w, bc = payload
                if mob is not None:
                    mob.clear_site_fault(bc)
                c_ues = cell_parked.pop(w, [])
                if streams is not None:
                    for c, ues in _by_cell(c_ues, mob):
                        batch = _merge_parked(
                            [p for u in ues for p in parked[u]])
                        if len(batch):
                            streams[c].adopt_batch(batch, t, cohort)
                        for u in ues:
                            parked[u] = []
                if controllers is not None:
                    for u in c_ues:
                        controllers[u].notify_outage()
        if not group:
            continue

        # 1b. mobility: advance trajectories/shadowing to the capture
        #     instant and evaluate A3 (handover events live on THIS
        #     absolute clock).  On handover the UE's byte queue migrates
        #     to the target cell's MAC, the in-flight HARQ transport
        #     block is flushed as a loss, the uplink stalls for the
        #     path-relocation gap, and the controller's granted-rate
        #     estimate resets (it described the OLD cell's load).
        if mob is not None:
            for u, _k in group:
                if chaos is not None and not chaos.active(u, t):
                    continue     # churned out: no trajectory draws either
                obs = mob.observe(u, t)
                mob_obs[u] = obs
                ev = obs.handover
                if ev is None:
                    continue
                gap_until[u] = ev.t_s + ev.gap_s
                if streams is not None:
                    for fl in streams[ev.from_cell].migrate_ue(u):
                        if fl.granted > fl.granted_at_admit:
                            fl.n_retx += 1   # in-flight TB lost at HO
                        streams[ev.to_cell].adopt(
                            fl, max(fl.req.enqueue_s, gap_until[u]),
                            cohort)
                else:
                    radio_free[u] = max(radio_free[u], gap_until[u])
                outcome[u] = None            # old cell's grants are stale
                if controllers is not None:
                    controllers[u].notify_handover()
                if tele is not None:
                    tele.instant("handover", ev.t_s, ue=u, cell=ev.to_cell,
                                 from_cell=ev.from_cell, gap_s=ev.gap_s)

        # 2. admission: absent (churned-out) UEs produce no frame at all
        #    -- the camera is not in the cell -- then skip when the
        #    in-flight window is full
        admitted: List[_Frame] = []
        for u, k in group:
            if chaos is not None and not chaos.active(u, t):
                sim.stats.n_absent += 1
                continue
            serv = int(mob.serving[u]) if mob is not None else 0
            hoc = int(mob.handover_count[u]) if mob is not None else 0
            n_done = sum(1 for d in done_times[u] if d <= t + 1e-12)
            if launched[u] - n_done >= window:
                log = FrameLog(
                    option="dropped", interference_db=float(levels[k, u]),
                    delay_s=0.0, head_s=0.0, quant_s=0.0, tx_s=0.0,
                    path_s=0.0, tail_s=0.0, energy_inf_j=0.0,
                    energy_tx_j=0.0, raw_bytes=0, compressed_bytes=0,
                    rate_bps=0.0, ue_id=u, deadline_s=t + budget,
                    frame_idx=k, capture_s=t, age_s=0.0, dropped=True,
                    serving_cell=serv, handover_count=hoc)
                dropped_logs.append(log)
                sim.stats.n_dropped += 1
                if controllers is not None:
                    controllers[u].observe_stream(0.0, True)
                continue
            launched[u] += 1
            admitted.append(_Frame(
                ue=u, idx=k, capture_s=t, level=float(levels[k, u]),
                deadline_s=t + budget, serving_cell=serv, ho_count=hoc,
                rate_scale=(mob_obs[u].rate_scale if mob is not None
                            else 1.0)))
        if not admitted:
            continue

        # 3. decide (per-UE controllers, per-UE rngs -- the lock-step
        #    draw order, grant KPMs from the last delivered report)
        for fr in admitted:
            if option is None:
                assert controllers is not None, \
                    "no fixed option and no controller template"
                rep = outcome[fr.ue]
                kpm, spec = sense_stage(
                    fr.level, bool(sim.narrowband[fr.ue]),
                    sim._ue_rngs[fr.ue],
                    grant_share=None if rep is None else rep.prb_share,
                    buffer_bytes=None if rep is None else float(rep.n_bytes))
                # during failover the controller predicts with the path
                # frames will actually ride (the cUPF's base latency),
                # so selection can trade the split against the detour
                if chaos is not None and chaos.routed_failover:
                    dpath = chaos.cfg.failover_path
                elif mob is not None:
                    dpath = mob.serving_path(fr.ue)
                else:
                    dpath = sim.path
                fr.pred = decide_stage(
                    controllers[fr.ue], kpm, spec, sim.plan.options,
                    fr.level, dpath)
                fr.option = fr.pred.option
            else:
                fr.option = option
            fr.offload = fr.option != UE_ONLY

        # 4. head + encode on the UE's serial compute resource: frame
        #    N+1's head starts at capture even while frame N is still in
        #    the air (streaming overlap), but queues behind N's *compute*
        fused = sim.execute_model and getattr(sim, "fused_head", False)
        for fr in admitted:
            if fused:
                # one device call covers head + quant epilogue
                # (pipeline.head_encode_stage); payload bytes match the
                # group-encode path bit-for-bit
                fr.head, fr.enc = head_encode_stage(
                    sim.plan, sim.system, sim.codec,
                    src.frame(fr.idx, fr.ue), fr.option, True,
                    controllers[fr.ue] if controllers else None)
                continue
            payload = local = None
            if sim.execute_model:
                payload, local = sim.plan.head(src.frame(fr.idx, fr.ue),
                                               fr.option)
            fr.head = HeadResult(head_s=sim._head_s[fr.option],
                                 payload=payload, local_out=local)
        if fused:
            pass                       # fr.enc already filled above
        elif sim.execute_model:
            by_option: Dict[str, List[_Frame]] = {}
            for fr in admitted:
                by_option.setdefault(fr.option, []).append(fr)
            for opt, frs in by_option.items():
                group_enc = encode_group_stage(
                    sim.plan, sim.system, sim.codec,
                    [fr.head.payload for fr in frs], opt, True,
                    [controllers[fr.ue] if controllers else None
                     for fr in frs])
                for fr, e in zip(frs, group_enc):
                    fr.enc = e
        else:
            for fr in admitted:
                fr.enc = sim._enc[fr.option]
        for fr in admitted:
            u = fr.ue
            head_start = max(fr.capture_s, compute_free[u])
            fr.pre_wait_s = max(head_start - fr.capture_s, 0.0)
            fr.enq_s = head_start + fr.head.head_s + fr.enc.quant_s
            compute_free[u] = fr.enq_s
            active_s[u] += fr.head.head_s + fr.enc.quant_s
            assert fr.enq_s >= fr.capture_s, "encode finished before capture"

        # 5. uplink -- one vectorized fading draw + one vectorized path
        #    draw over the round, the lock-step slot's exact shared-rng
        #    discipline.  Mobility scales the SAME shared fading draw by
        #    the serving cell's excess loss (scale 1 at the reference
        #    geometry keeps the draw bitwise) and routes the path draw
        #    through each UE's serving site, composed from the identical
        #    shared-stream blocks (sample_path_latencies).
        lv = np.array([fr.level for fr in admitted])
        nb = np.array([sim.narrowband[fr.ue] for fr in admitted])
        link = sim.system.channel.sample_rate(lv, sim._rng, narrowband=nb)
        link = np.atleast_1d(np.asarray(link, float))
        offload = np.array([fr.offload for fr in admitted])
        m = len(admitted)
        # failover routing (core/chaos.py): while the heartbeat detector
        # believes the primary dUPF is down, every new uplink rides the
        # failover (cUPF) path instead.  Path draws keep the identical
        # fixed per-index draw structure whatever the PathModel, so the
        # shared stream stays rng-paired across failover on/off runs.
        failover_now = chaos is not None and chaos.routed_failover
        if mob is not None:
            scale = np.array([fr.rate_scale for fr in admitted])
            link = np.maximum(link * scale, sim.system.channel.min_rate)
            ppaths = [chaos.cfg.failover_path if failover_now
                      else mob.sites[fr.serving_cell].path
                      for fr in admitted]
            path = np.where(offload,
                            sample_path_latencies(ppaths, sim._rng, m), 0.0)
        else:
            p = chaos.cfg.failover_path if failover_now else sim.path
            path = np.where(offload,
                            p.sample_latency(sim._rng, size=m), 0.0)
        for j, fr in enumerate(admitted):
            fr.rate_bps = float(link[j])
            fr.path_s = float(path[j])
            fr.routed_primary = not failover_now
        if streams is None:
            # per-UE serial radio: frame N+1's transmission queues behind
            # frame N's -- the isolated link's cross-frame carry-over
            for fr in admitted:
                if not fr.offload:
                    continue
                air = sim.system.channel.tx_time_s(
                    fr.enc.compressed_bytes, fr.rate_bps) \
                    if fr.enc.compressed_bytes else 0.0
                wait = max(radio_free[fr.ue] - fr.enq_s, 0.0)
                fr.air_s, fr.tx_s = air, wait + air
                radio_free[fr.ue] = fr.enq_s + fr.tx_s
                fr.arrival_s = fr.enq_s + fr.tx_s + fr.path_s
                if chaos is not None:
                    chaos.straggler.record(UPF_WORKER, fr.path_s)
                    if fr.routed_primary \
                            and chaos.upf_down(fr.enq_s + fr.tx_s):
                        lose(fr, fr.enq_s + fr.tx_s, "upf_outage")
                        continue
                submit(fr)
        else:
            for j, fr in enumerate(admitted):
                if fr.offload and fr.enc.compressed_bytes > 0:
                    streams[fr.serving_cell].enqueue(
                        UplinkRequest(
                            ue_id=fr.ue,
                            n_bytes=int(fr.enc.compressed_bytes),
                            enqueue_s=max(fr.enq_s,
                                          float(gap_until[fr.ue])),
                            deadline_s=fr.deadline_s,
                            link_rate_bps=fr.rate_bps),
                        cohort, meta=fr)
                    continue
                if fr.offload:
                    # offloading nothing over the air (degenerate payload)
                    fr.arrival_s = fr.enq_s + fr.path_s
                    if chaos is not None and fr.routed_primary \
                            and chaos.upf_down(fr.enq_s):
                        lose(fr, fr.enq_s, "upf_outage")
                    else:
                        submit(fr)
                # frames that put nothing on the air cannot see the cell
                # load; the stale granted-rate estimate relaxes toward the
                # idle link rate (the lock-step slot's discipline)
                if controllers is not None:
                    controllers[fr.ue].relax_grant(float(link[j]))
                outcome[fr.ue] = None
        cohort += 1

        # 6. local-only frames complete as soon as their head does
        for fr in admitted:
            if not fr.offload:
                fr.done_s = fr.capture_s + fr.pre_wait_s + fr.head.head_s
                fr.out = fr.head.local_out
                finish(fr)
        frames.extend(admitted)

    # drain: whatever is still in the air or queued at the edge
    if streams is not None:
        for ci, (s, hr) in enumerate(zip(streams, harq_rngs)):
            deliver(s.advance(math.inf, hr), s, ci)
    serve(edge.flush(math.inf))
    assert edge.n_pending == 0 and all(fr.final for fr in frames), \
        "event engine ended with unfinished frames"

    # -- account -------------------------------------------------------------
    logs: List[FrameLog] = []
    for fr in frames:
        up = UplinkResult(rate_bps=fr.rate_bps, tx_s=fr.tx_s,
                          path_s=fr.path_s)
        logs.append(account_stage(
            sim.system, fr.option, fr.level, fr.head, fr.enc
            or EncodeResult(0.0, 0, 0, None), up, fr.tail_s,
            queue_s=fr.queue_s, batch_size=fr.batch_size, ue_id=fr.ue,
            predicted=fr.pred, prb_share=fr.prb_share,
            harq_retx=fr.harq_retx, deadline_s=fr.deadline_s,
            air_s=fr.air_s, extra_wait_s=fr.pre_wait_s,
            capture_s=fr.capture_s, frame_idx=fr.idx,
            age_s=fr.done_s - fr.capture_s,
            serving_cell=fr.serving_cell, handover_count=fr.ho_count,
            dropped=bool(fr.drop_reason), drop_reason=fr.drop_reason))
    logs.extend(dropped_logs)
    logs.sort(key=lambda l: (l.frame_idx, l.ue_id))
    if tele is not None:
        for log in logs:
            tele.record_frame_log(log)

    st = sim.stats
    st.n_frames = n_frames
    st.n_ues = n
    # chaos-lost frames were admitted but never produced a detection:
    # they count against availability, not as completions
    done = [fr for fr in frames if not fr.drop_reason]
    st.n_completed = len(done)
    st.age_sum_s = float(sum(fr.done_s - fr.capture_s for fr in done))
    first_capture = float(captures.min()) if captures.size else 0.0
    last_capture = float(captures.max()) if captures.size else 0.0
    # the observed horizon spans through the last capture even when the
    # tail of the run is all drops (else effective fps overestimates)
    last_done = max((fr.done_s for fr in frames), default=first_capture)
    st.wall_s = max(last_done, last_capture) - first_capture
    st.span_s = st.wall_s          # utilization measured against wall-clock
    st.ue_active_s = float(active_s.sum())
    st.n_handovers = int(mob.handover_count.sum()) if mob is not None else 0

    # per-cell SLO breakdown: every admitted frame's outcome attributed
    # to the cell serving it at capture (window drops via their logs)
    cell_acc: Dict[int, Dict[str, int]] = {}

    def _cacc(c: int, key: str):
        d = cell_acc.setdefault(int(c), {"n_completed": 0, "n_dropped": 0,
                                         "n_lost_edge": 0, "n_lost_path": 0})
        d[key] += 1

    for fr in frames:
        if fr.drop_reason == "edge_outage":
            _cacc(fr.serving_cell, "n_lost_edge")
        elif fr.drop_reason:
            _cacc(fr.serving_cell, "n_lost_path")
        else:
            _cacc(fr.serving_cell, "n_completed")
    for log in dropped_logs:
        _cacc(log.serving_cell, "n_dropped")
    st.cell_stats = cell_acc

    # per-UE wall-clock energy: active intervals at P_active, the rest of
    # the UE's span idle, radio charged per granted airtime (no
    # double-counting across pipelined frames)
    ue_energy = []
    for u in range(n):
        mine = [fr for fr in frames if fr.ue == u]
        wall = (max(fr.done_s for fr in mine) - captures[u][0]) if mine \
            else 0.0
        e = interval_energy_j(sim.system.ue, float(active_s[u]), wall)
        e += sum(sim.system.radio.tx_energy_j(fr.air_s, fr.level)
                 for fr in mine)
        ue_energy.append(float(e))

    recovery = None
    if chaos is not None:
        skips = [(l.ue_id, l.frame_idx, l.capture_s) for l in dropped_logs]
        recovery = chaos.finalize(frames, skips)
        st.n_outages = (len(chaos.edge_windows) + len(chaos.upf_windows)
                        + len(chaos.blackout_windows)
                        + len(chaos.cell_blackout_windows))
        if tele is not None:
            tele.record_chaos(chaos)

    outputs = None
    if keep_outputs:
        outputs = [dict() for _ in range(n_frames)]
        for fr in frames:
            outputs[fr.idx][fr.ue] = fr.out
    return CellResult(logs=logs, stats=st, outputs=outputs,
                      ue_wall_energy_j=ue_energy, recovery=recovery)
