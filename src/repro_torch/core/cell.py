"""Multi-UE cell simulation: one edge server serving a whole cell of UEs.

The counterpart of ``repro/core/cell.py``, on the port's stages, plan and
codec: every rng draw and every float expression in the same order, so an
accounting run (``execute_model=False``) gives the JAX package's logs
field for field.  An executed run runs the heads, the group encode (B2)
and decode (B3) and the batched tails (B1 in every Swin block) on
``device``; ``engine="vectorized"`` runs the MAC's TTI loop as tensors on
``device`` too (core/ran_vec.py).

The paper validates one UE against one edge server; this module scales the
same mechanism to a cell.  Per frame-slot every UE runs the familiar
sense -> decide -> head -> encode -> uplink stages (core/pipeline.py), but
the tail is NOT executed per UE: uplinked payloads land in the edge
server's ``TailBatcher``, which groups pending requests by split option,
pads each group to a bucketed batch size, and runs ONE
``tail_batched`` forward per group (deadline-aware micro-batching, cf.
*Enhanced AI as a Service at the Edge via Transformer Network*).

Two execution regimes, mirroring the single-UE pipeline:

  * ``execute_model=False`` -- accounting-only.  Channel rate and path
    latency sampling are vectorized over the UE axis (core/channel.py),
    so fixed-option sweeps scale to hundreds of UEs without Python-loop
    overhead.  (Adaptive mode senses per UE from per-UE rngs so each UE's
    trace is independently reproducible.)
  * ``execute_model=True``  -- real Swin heads per UE, real batched tail
    forwards on the edge; same-option boundary payloads share ONE fused
    codec launch per slot (``encode_group_stage`` -> ``compress_group``:
    per-UE blobs stay byte-identical to the per-UE path, only the
    simulator's wall clock changes); time/energy still accounted with
    the calibrated models.

What batching buys is the edge's per-invocation dispatch cost
(``DeviceProfile.launch_overhead_s``): serving B same-option payloads in
one launch costs ``overhead + B * tail_flops / rate`` instead of
``B * (overhead + tail_flops / rate)``.  Cell-level aggregates (edge
utilization, batch occupancy, queueing delay) come back in ``CellStats``.

Two radio regimes, orthogonal to the execution regimes:

  * ``ran=None`` (default) -- every UE samples the calibrated channel
    independently (the pre-RAN model: N uplinks never contend).
  * ``ran=RanCell(...)`` -- all uplinks share ONE PRB grid: per TTI the
    cell's ``SchedulerPolicy`` grants PRBs over the UEs' byte queues,
    HARQ re-enqueues failed transport blocks, and each UE's uplink time
    is the *scheduled* completion (core/ran.py).  Grant history and
    buffer status feed back into next-frame KPMs and each cloned
    controller's granted-rate estimate, so split selection becomes
    contention-aware.

And two clock regimes: ``run`` is the lock-step engine (one slot per
frame, the clock re-anchors every slot, queues drain within the slot),
``run_stream`` is the continuous-time event engine (core/timeline.py:
per-UE frame clocks, streaming head/uplink/tail overlap, cross-frame
backlog carry-over, frame skipping) -- configured degenerate it
reproduces ``run`` rng-paired.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.adaptive import AdaptiveController, Prediction
from repro_torch.core.calibration import Calibrated
from repro_torch.core.channel import INTERFERENCE_LEVELS, PathModel, dupf_path
from repro_torch.core.compression import ActivationCodec
from repro_torch.core.mobility import MobilityModel
from repro_torch.core.ran import GrantReport, MultiCell, RanCell, UplinkRequest
from repro_torch.core.ran_vec import VecRanCell
from repro_torch.core.pipeline import (EncodeResult, FrameLog, FrameSource,
                                       HeadResult, UplinkResult, account_stage,
                                       decide_stage, encode_group_stage,
                                       encode_stage, head_encode_stage,
                                       sense_stage)
from repro_torch.core.splitting import UE_ONLY, SwinSplitPlan

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


# ---------------------------------------------------------------------------
# edge-side micro-batching
# ---------------------------------------------------------------------------

@dataclass
class TailRequest:
    ue_id: int
    option: str
    arrival_s: float              # within-slot time the payload finished uplink
    payload: Any = None           # real boundary pytree (execute mode)


@dataclass
class ServedTail:
    tail_s: float                 # service time of the batch that ran us
    queue_s: float                # arrival -> batch execution start
    batch_size: int               # real occupancy of that batch
    out: Any = None               # detections (execute mode)


@dataclass
class BatchRecord:
    option: str
    size: int                     # real requests in the batch
    padded: int                   # bucket size actually executed
    start_s: float
    compute_s: float


@dataclass
class TailBatcher:
    """Deadline-aware micro-batching of tail requests on the edge server.

    A batch for one split option closes when (a) the next same-option
    arrival would exceed ``max_wait_s`` past the first queued request, or
    (b) the largest bucket is full.  Closed batches are padded up to the
    smallest bucket that fits and executed serially on the edge device in
    close order.  ``batching=False`` degenerates to one launch per request
    (the sequential per-UE baseline)."""
    plan: Any                     # SwinSplitPlan or LMSplitPlan
    edge: Any                     # DeviceProfile with launch_overhead_s set
    execute_model: bool = False
    batching: bool = True
    buckets: Tuple[int, ...] = DEFAULT_BUCKETS
    max_wait_s: float = 0.050

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _form_batches(self, group: List[TailRequest]) -> List[List[TailRequest]]:
        if not self.batching:
            return [[r] for r in group]
        batches: List[List[TailRequest]] = []
        cur: List[TailRequest] = []
        for r in group:
            if cur and (r.arrival_s > cur[0].arrival_s + self.max_wait_s
                        or len(cur) >= self.buckets[-1]):
                batches.append(cur)
                cur = []
            cur.append(r)
        if cur:
            batches.append(cur)
        return batches

    def run_slot(self, requests: Sequence[TailRequest]
                 ) -> Tuple[Dict[int, ServedTail], List[BatchRecord]]:
        """Serve one frame-slot's uplinked requests.  Returns per-UE results
        and the executed batch records (for cell-level aggregates)."""
        by_option: Dict[str, List[TailRequest]] = {}
        for r in sorted(requests, key=lambda r: (r.arrival_s, r.ue_id)):
            by_option.setdefault(r.option, []).append(r)

        pending: List[List[TailRequest]] = []
        for group in by_option.values():
            pending.extend(self._form_batches(group))
        # a batch is ready once its last member arrived; the edge device
        # executes ready batches serially in that order
        pending.sort(key=lambda b: b[-1].arrival_s)

        served: Dict[int, ServedTail] = {}
        records: List[BatchRecord] = []
        edge_free = 0.0
        for batch in pending:
            option = batch[0].option
            padded = self._bucket(len(batch)) if self.batching else len(batch)
            start = max(batch[-1].arrival_s, edge_free)
            compute_s = self.edge.batch_compute_time_s(
                self.plan.tail_flops(option), padded)
            outs: List[Any] = [None] * len(batch)
            if self.execute_model:
                outs = self.plan.tail_batched([r.payload for r in batch],
                                              option, pad_to=padded)
            for r, out in zip(batch, outs):
                served[r.ue_id] = ServedTail(
                    tail_s=compute_s, queue_s=start - r.arrival_s,
                    batch_size=len(batch), out=out)
            records.append(BatchRecord(option=option, size=len(batch),
                                       padded=padded, start_s=start,
                                       compute_s=compute_s))
            edge_free = start + compute_s
        return served, records


# ---------------------------------------------------------------------------
# cell-level aggregates
# ---------------------------------------------------------------------------

@dataclass
class CellStats:
    n_frames: int = 0
    n_requests: int = 0
    n_batches: int = 0
    edge_busy_s: float = 0.0      # total edge compute time
    span_s: float = 0.0           # lock-step: sum of per-slot edge
                                  # makespans; event engine: wall-clock span
    occupancy_sum: float = 0.0    # sum of size/padded over batches
    queue_sum_s: float = 0.0
    # continuous-time extensions (core/timeline.py; zero on lock-step runs)
    n_completed: int = 0          # frames that reached a detection
    n_dropped: int = 0            # captures skipped by the in-flight window
    age_sum_s: float = 0.0        # sum of frame ages at detection
    wall_s: float = 0.0           # first capture -> last completion
    n_ues: int = 0
    ue_active_s: float = 0.0      # total UE compute-active wall time
    # mobility extensions (core/mobility.py; zero without a MobilityModel)
    n_handovers: int = 0          # serving-cell changes over the run
    # chaos extensions (core/chaos.py; zero without a ChaosModel)
    n_absent: int = 0             # captures skipped: UE churned out of the cell
    n_lost_edge: int = 0          # frames lost to an edge outage (drop policy)
    n_lost_path: int = 0          # frames lost in flight on a down user plane
    n_outages: int = 0            # injected outage/blackout windows this run
    # per-cell chaos/SLO breakdown keyed by serving cell at frame
    # completion/loss (multi-cell timeline runs; empty otherwise).  Keys
    # per cell: n_completed / n_dropped / n_lost_edge / n_lost_path.
    cell_stats: Dict[int, Dict[str, int]] = field(default_factory=dict)

    def absorb_slot(self, records: List[BatchRecord],
                    served: Dict[int, ServedTail]):
        self.n_frames += 1
        self.n_requests += sum(r.size for r in records)
        self.n_batches += len(records)
        busy = sum(r.compute_s for r in records)
        self.edge_busy_s += busy
        if records:
            self.span_s += max(r.start_s + r.compute_s for r in records)
        self.occupancy_sum += sum(r.size / r.padded for r in records)
        self.queue_sum_s += sum(s.queue_s for s in served.values())

    def absorb_batch(self, record: BatchRecord,
                     served: Sequence[ServedTail]):
        """One executed batch on the continuous timeline (the event
        engine has no per-slot makespans; span is set to wall-clock)."""
        self.n_requests += record.size
        self.n_batches += 1
        self.edge_busy_s += record.compute_s
        self.occupancy_sum += record.size / record.padded
        self.queue_sum_s += sum(s.queue_s for s in served)

    @property
    def edge_utilization(self) -> float:
        return self.edge_busy_s / self.span_s if self.span_s else 0.0

    @property
    def mean_batch_occupancy(self) -> float:
        return self.occupancy_sum / self.n_batches if self.n_batches else 0.0

    @property
    def mean_batch_size(self) -> float:
        return self.n_requests / self.n_batches if self.n_batches else 0.0

    @property
    def mean_queue_s(self) -> float:
        return self.queue_sum_s / self.n_requests if self.n_requests else 0.0

    # -- streaming aggregates (meaningful after core/timeline.py runs) -------
    @property
    def drop_rate(self) -> float:
        total = self.n_completed + self.n_dropped
        return self.n_dropped / total if total else 0.0

    @property
    def mean_age_s(self) -> float:
        return self.age_sum_s / self.n_completed if self.n_completed else 0.0

    @property
    def effective_fps(self) -> float:
        """Completed detections per second per UE over the wall span --
        the rate the stream actually sustains, vs. the capture fps."""
        if not (self.wall_s and self.n_ues):
            return 0.0
        return self.n_completed / self.wall_s / self.n_ues

    @property
    def availability(self) -> float:
        """Fraction of admitted captures that reached a detection --
        window-policy drops AND chaos losses count against it; absent
        (churned-out) UEs' unproduced captures do not.  1.0 on a run
        with nothing to serve."""
        total = (self.n_completed + self.n_dropped
                 + self.n_lost_edge + self.n_lost_path)
        return self.n_completed / total if total else 1.0

    def cell_availability(self, cell: int) -> float:
        """Per-cell availability from the ``cell_stats`` breakdown --
        the same served/admitted ratio scoped to one ``CellSite`` (1.0
        for a cell with nothing attributed to it)."""
        cs = self.cell_stats.get(cell, {})
        total = (cs.get("n_completed", 0) + cs.get("n_dropped", 0)
                 + cs.get("n_lost_edge", 0) + cs.get("n_lost_path", 0))
        return cs.get("n_completed", 0) / total if total else 1.0


@dataclass
class CellResult:
    logs: List[FrameLog]          # all frames, all UEs (log.ue_id says whose)
    stats: CellStats
    outputs: Optional[List[Dict[int, Any]]] = None   # per-slot detections
    # per-UE wall-clock energy (event engine only: active/idle intervals
    # without the per-frame overlap double count; energy.interval_energy_j)
    ue_wall_energy_j: Optional[List[float]] = None
    # per-outage-window recovery metrics (core/chaos.py RecoveryMetrics;
    # None unless the run carried a ChaosModel)
    recovery: Optional[List[Any]] = None

    def ue_logs(self, ue_id: int) -> List[FrameLog]:
        return [l for l in self.logs if l.ue_id == ue_id]

    @property
    def completed_logs(self) -> List[FrameLog]:
        return [l for l in self.logs if not l.dropped]

    @property
    def mean_delay_s(self) -> float:
        done = self.completed_logs
        return float(np.mean([l.delay_s for l in done])) if done else 0.0

    @property
    def deadline_miss_rate(self) -> float:
        """Fraction of frames whose E2E delay exceeded the frame budget
        (only meaningful when a budget is logged: RAN-scheduled cells and
        event-engine runs with ``budget_s``; legacy lock-step logs carry
        an infinite deadline and never miss).  Dropped frames count as
        missed -- they never produced a detection at all."""
        return float(np.mean([l.deadline_miss for l in self.logs]))

    @property
    def drop_rate(self) -> float:
        return float(np.mean([l.dropped for l in self.logs])) \
            if self.logs else 0.0

    @property
    def mean_age_s(self) -> float:
        done = self.completed_logs
        return float(np.mean([l.age_s for l in done])) if done else 0.0


# ---------------------------------------------------------------------------
# the cell simulator
# ---------------------------------------------------------------------------

@dataclass
class CellSimulator:
    """A cell of ``n_ues`` UEs sharing one channel and one edge server.

    Per-UE state: an interference trace row, a narrowband flag, an rng for
    sensing, and (optionally) a cloned adaptive controller.  Shared state:
    the calibrated channel (vectorized sampling), the user-plane path, and
    the edge ``TailBatcher``.  ``device`` is where the default codec runs
    (the plan carries its own); it defaults to the card."""
    plan: Any                     # SwinSplitPlan or LMSplitPlan
    system: Calibrated
    n_ues: int
    codec: Optional[ActivationCodec] = None   # None: ActivationCodec on device
    controller: Optional[AdaptiveController] = None   # template, cloned per UE
    path: PathModel = field(default_factory=dupf_path)
    narrowband: Any = False       # scalar or per-UE array of bool
    seed: int = 0
    execute_model: bool = False
    # run each UE's head + int8 quant epilogue as ONE device pass
    # (pipeline.head_encode_stage).  Off by default here: the lock-step
    # engine's group-encode path (one fused codec launch per option) is
    # the calibrated baseline; the fused head trades that grouping for one
    # codec launch per UE.  Payload bytes are identical either way.
    fused_head: bool = False
    batching: bool = True
    buckets: Tuple[int, ...] = DEFAULT_BUCKETS
    max_wait_s: float = 0.050
    edge_overhead_s: float = 0.008    # per-launch dispatch cost on the edge
    edge_batch_sat: float = 3.0       # batch-throughput saturation k (energy.py)
    # shared-air-interface MAC (core/ran.py).  None = the legacy regime:
    # every UE samples the calibrated channel independently (no
    # contention), bit-compatible with the pre-RAN pipeline numbers.
    # A MultiCell (2-3 RanCells) needs ``mobility`` to assign serving
    # cells and is served by the event engine only.
    ran: Optional[Any] = None         # RanCell | MultiCell | None
    frame_budget_s: float = 2.5       # per-frame E2E deadline (EDF urgency)
    # trajectory-driven time-varying channel + A3 handover
    # (core/mobility.py).  Event-engine only: handover events live on the
    # absolute clock, so ``run``/``step`` refuse it.
    mobility: Optional[MobilityModel] = None
    # failure injection & churn (core/chaos.py ChaosModel).  Event-engine
    # only: outage windows, heartbeat ticks and churn intervals live on
    # the absolute clock, so ``run``/``step`` refuse it.  A zero-chaos
    # model (ChaosConfig with empty specs) replays a chaos-free run
    # bitwise -- the schedule draws from a dedicated SeedSequence child
    # appended at the END of the layout below.
    chaos: Optional[Any] = None
    # MAC engine: "python" runs core/ran.py as-is; "vectorized" swaps the
    # TTI loops for the step functions of core/ran_vec.py on ``device``,
    # which replay the Python engine's grant traces, HARQ outcomes and
    # reports field-exactly (the Python engine stays the bitwise oracle).
    # Ignored when ran is None (the legacy radio has no TTI loop).
    engine: str = "python"
    # telemetry plane (core/telemetry.py Telemetry).  None = no tracing.
    # Every hook is a pure observer of timestamps the engines compute
    # anyway -- no rng draws, no float feedback -- so attaching one
    # replays a telemetry-free run bitwise.
    telemetry: Optional[Any] = None
    device: Any = "cuda"
    stats: CellStats = field(default_factory=CellStats)

    def __post_init__(self):
        if self.engine not in ("python", "vectorized"):
            raise ValueError(f"unknown MAC engine {self.engine!r}; "
                             f"choose 'python' or 'vectorized'")
        self.device = resolve_device(self.device)
        if self.codec is None:
            self.codec = ActivationCodec(device=self.device)
        self.narrowband = np.broadcast_to(
            np.asarray(self.narrowband, bool), (self.n_ues,)).copy()
        if isinstance(self.ran, MultiCell):
            if self.mobility is None:
                raise ValueError(
                    "a MultiCell RAN needs a MobilityModel to assign "
                    "serving cells (pass mobility=..., or use one RanCell)")
            if self.mobility.n_sites != self.ran.n_cells:
                raise ValueError(
                    f"MobilityModel has {self.mobility.n_sites} sites but "
                    f"MultiCell has {self.ran.n_cells} cells; they must "
                    f"correspond 1:1")
        elif self.ran is not None and self.mobility is not None \
                and self.mobility.n_sites != 1:
            # a lone RanCell cannot host a handover target: the first A3
            # trigger would index a stream that does not exist
            raise ValueError(
                f"MobilityModel has {self.mobility.n_sites} sites but the "
                f"RAN is a single RanCell; wrap one RanCell per site in a "
                f"MultiCell (or drop ran for isolated per-UE links)")
        self.edge = dataclasses.replace(
            self.system.edge, launch_overhead_s=self.edge_overhead_s,
            batch_sat=self.edge_batch_sat)
        self.batcher = TailBatcher(
            plan=self.plan, edge=self.edge, execute_model=self.execute_model,
            batching=self.batching, buckets=self.buckets,
            max_wait_s=self.max_wait_s)
        # per-option accounting caches (head time / payload+quant bytes --
        # in accounting mode encode_stage depends only on the option)
        self._head_s = {o: self.system.ue.compute_time_s(self.plan.head_flops(o))
                        for o in self.plan.options}
        self._enc = {o: encode_stage(self.plan, self.system, self.codec,
                                     None, o, execute_model=False)
                     for o in self.plan.options}
        self.reset()

    def reset(self):
        """Restore seeded state (rngs, cloned controllers, stats) so every
        ``run`` starts identically -- repeated runs on one simulator are
        reproducible and comparisons stay rng-paired."""
        self._rng = np.random.default_rng(self.seed)          # shared channel
        # children 0..n_ues-1 are the per-UE sensing rngs exactly as before
        # (spawn keys are index-stable, so spawning MORE children never
        # moves an earlier stream).  Child n_ues feeds HARQ draws so fading
        # stays aligned across policies (core/ran.py discipline); child
        # n_ues+1 is RESERVED for the event engine's capture jitter
        # (core/timeline.py spawns it itself); child n_ues+2 drives the
        # mobility model's shadowing/Doppler draws; children n_ues+3..-2
        # are per-cell HARQ streams for the non-anchor cells of a
        # MultiCell (cell 0 keeps the original HARQ stream, so a
        # single-cell run is draw-for-draw the pre-mobility engine); the
        # LAST child is the chaos schedule's dedicated stream
        # (core/chaos.py) -- always spawned (index-stable, unused draws
        # are free) so attaching a ChaosModel never moves any other
        # stream and a zero-chaos config replays chaos-free runs bitwise.
        n_extra_cells = self.ran.n_cells - 1 \
            if isinstance(self.ran, MultiCell) else 0
        seqs = np.random.SeedSequence(self.seed).spawn(
            self.n_ues + 4 + n_extra_cells)
        self._ue_rngs = [np.random.default_rng(s) for s in seqs[:self.n_ues]]
        self._harq_rng = np.random.default_rng(seqs[self.n_ues])
        self._harq_rngs = [self._harq_rng] + [
            np.random.default_rng(s) for s in seqs[self.n_ues + 3:-1]]
        if self.mobility is not None:
            self.mobility.reset(self.n_ues,
                                np.random.default_rng(seqs[self.n_ues + 2]),
                                self.system.channel)
        if self.chaos is not None:
            self.chaos.reset(self.n_ues, seqs[-1])
        self._last_reports: Dict[int, GrantReport] = {}
        if self.ran is not None:
            self.ran.reset(self.n_ues)
        # the MAC the lock-step engine actually drives: the RanCell
        # itself, or its vectorized twin (policy state freshly adopted
        # post-reset, so both engines start from the same zeros)
        self._mac = self.ran
        if self.engine == "vectorized" and self.ran is not None \
                and not isinstance(self.ran, MultiCell):
            self._mac = VecRanCell.from_cell(self.ran, device=self.device)
        self._controllers = (self.controller.spawn(self.n_ues)
                             if self.controller is not None else None)
        if self._controllers and not isinstance(self.plan, SwinSplitPlan):
            # non-Swin plans must not read the Swin calibration tables;
            # point the cloned controllers at the plan's own accounting
            for c in self._controllers:
                if c.plan is None:
                    c.plan = self.plan
        self.stats = CellStats()

    # -- one frame-slot -------------------------------------------------------
    @torch.no_grad()
    def step(self, levels, imgs=None, option: Optional[str] = None
             ) -> Tuple[List[FrameLog], Dict[int, Any]]:
        """Advance every UE by one frame.  ``levels``: scalar or (n_ues,)
        interference; ``option``: fixed split for all UEs, or None to let
        each UE's cloned controller decide."""
        if self.mobility is not None or isinstance(self.ran, MultiCell) \
                or self.chaos is not None:
            raise ValueError(
                "mobility / multi-cell handover / chaos injection lives "
                "on the absolute clock: use run_stream "
                "(core/timeline.py), not the lock-step step/run engine")
        if option is not None and option not in self._head_s:
            raise ValueError(f"unknown option {option!r}; "
                             f"plan offers {self.plan.options}")
        if self.execute_model and imgs is None:
            raise ValueError("execute_model=True requires imgs "
                             "(use execute_model=False for accounting sweeps)")
        n = self.n_ues
        levels = np.broadcast_to(np.asarray(levels, float), (n,))

        # --- decide (per-UE controllers; sensing uses per-UE rngs) ----------
        preds: List[Optional[Prediction]] = [None] * n
        if option is None:
            assert self._controllers is not None, \
                "no fixed option and no controller template"
            options = []
            for i in range(n):
                rep = self._last_reports.get(i)
                kpm, spec = sense_stage(
                    levels[i], bool(self.narrowband[i]), self._ue_rngs[i],
                    grant_share=None if rep is None else rep.prb_share,
                    buffer_bytes=None if rep is None else float(rep.n_bytes))
                preds[i] = decide_stage(self._controllers[i], kpm, spec,
                                        self.plan.options, levels[i], self.path)
                options.append(preds[i].option)
        else:
            options = [option] * n

        # --- head (real per UE, or table lookups) ----------------------------
        heads: List[HeadResult] = [None] * n           # type: ignore[list-item]
        encs: List[EncodeResult] = [None] * n          # type: ignore[list-item]
        fused = self.execute_model and self.fused_head
        for i, opt in enumerate(options):
            if fused:
                # one device call covers head + quant epilogue; the
                # payload bytes match the group-encode path bit-for-bit
                heads[i], encs[i] = head_encode_stage(
                    self.plan, self.system, self.codec,
                    imgs[i % len(imgs)], opt, True,
                    self._controllers[i] if self._controllers else None)
            elif self.execute_model:
                payload, local = self.plan.head(imgs[i % len(imgs)], opt)
                heads[i] = HeadResult(head_s=self._head_s[opt],
                                      payload=payload, local_out=local)
            else:
                heads[i] = HeadResult(head_s=self._head_s[opt], payload=None,
                                      local_out=None)

        # --- encode: same-option payloads share ONE fused codec launch -------
        if fused:
            pass                       # encs already filled by the fused head
        elif self.execute_model:
            by_option: Dict[str, List[int]] = {}
            for i, opt in enumerate(options):
                by_option.setdefault(opt, []).append(i)
            for opt, idxs in by_option.items():
                group = encode_group_stage(
                    self.plan, self.system, self.codec,
                    [heads[i].payload for i in idxs], opt, True,
                    [self._controllers[i] if self._controllers else None
                     for i in idxs])
                for i, e in zip(idxs, group):
                    encs[i] = e
        else:
            encs = [self._enc[opt] for opt in options]   # per-option cache

        # --- grant + uplink --------------------------------------------------
        comp_b = np.array([e.compressed_bytes for e in encs], float)
        offload = np.array([o != UE_ONLY for o in options])
        quant_s = np.array([e.quant_s for e in encs])
        head_s = np.array([h.head_s for h in heads])
        prb_share = np.ones(n)
        harq_retx = np.zeros(n, int)
        air_s = None                   # isolated link: airtime == tx time
        if self.ran is None:
            # legacy isolated-link regime: one vectorized draw over the UE
            # axis, tx time = bytes / faded link rate
            rates = self.system.channel.sample_rate(levels, self._rng,
                                                    narrowband=self.narrowband)
            tx_s = self.system.channel.tx_time_s(comp_b, rates)
        else:
            # shared cell: the faded link rate is the SAME sample_rate
            # call (and draw) the legacy branch makes, so the shared rng
            # stream stays aligned (RAN-vs-legacy and policy-vs-policy
            # comparisons see identical fading + path jitter); the MAC
            # then schedules every payload over one PRB grid per TTI
            link = self.system.channel.sample_rate(
                levels, self._rng, narrowband=self.narrowband)
            enq = head_s + quant_s
            reqs = [UplinkRequest(ue_id=i, n_bytes=int(comp_b[i]),
                                  enqueue_s=float(enq[i]),
                                  deadline_s=self.frame_budget_s,
                                  link_rate_bps=float(link[i]))
                    for i in range(n) if offload[i] and comp_b[i] > 0]
            reports = self._mac.serve_slot(reqs, self._harq_rng)
            if self._mac is not self.ran and self.ran.record_trace:
                # keep the user-visible trace on the RanCell they passed
                self.ran.grant_trace = self._mac.grant_trace
            rates = np.asarray(link, float).copy()
            tx_s = np.zeros(n)
            air_s = np.zeros(n)
            for i, rep in reports.items():
                tx_s[i] = rep.tx_s
                # TX power is charged for granted PRB-seconds (normalized
                # to the full grid), not the MAC wait: for any policy this
                # equals payload_bits/link_rate with HARQ retransmission
                # airtime folded in, matching the isolated-link e_tx for a
                # lone UE (account_stage)
                air_s[i] = (rep.granted_prbs * self.ran.cfg.tti_s
                            / self.ran.cfg.n_prbs)
                rates[i] = rep.realized_rate_bps   # the *scheduled* rate
                prb_share[i] = rep.prb_share
                harq_retx[i] = rep.n_harq_retx
            self._last_reports = reports
            if self._controllers is not None:
                for i, c in enumerate(self._controllers):
                    if i in reports:
                        c.observe_grant(reports[i].realized_rate_bps)
                    else:
                        # no uplink this frame: the UE cannot see the cell
                        # load, so its granted-rate estimate relaxes toward
                        # the idle link rate -- it will eventually probe an
                        # offloading option again instead of locking at
                        # ue_only forever after one congestion episode
                        c.relax_grant(float(link[i]))
        path_s = np.where(offload,
                          self.path.sample_latency(self._rng, size=n), 0.0)
        arrival = head_s + quant_s + tx_s + path_s

        # --- edge: batched tails ---------------------------------------------
        requests = [TailRequest(ue_id=i, option=options[i],
                                arrival_s=float(arrival[i]),
                                payload=encs[i].payload)
                    for i in range(n) if offload[i]]
        served, records = self.batcher.run_slot(requests)
        self.stats.absorb_slot(records, served)

        # --- account ----------------------------------------------------------
        logs: List[FrameLog] = []
        outputs: Dict[int, Any] = {}
        for i, opt in enumerate(options):
            up = UplinkResult(rate_bps=float(rates[i]), tx_s=float(tx_s[i]),
                              path_s=float(path_s[i]))
            if offload[i]:
                sv = served[i]
                tail_s, queue_s, batch = sv.tail_s, sv.queue_s, sv.batch_size
                outputs[i] = sv.out
            else:
                tail_s, queue_s, batch = 0.0, 0.0, 1
                outputs[i] = heads[i].local_out
            logs.append(account_stage(
                self.system, opt, float(levels[i]), heads[i], encs[i], up,
                tail_s, queue_s=queue_s, batch_size=batch, ue_id=i,
                predicted=preds[i], prb_share=float(prb_share[i]),
                harq_retx=int(harq_retx[i]),
                deadline_s=(self.frame_budget_s if self.ran is not None
                            else float("inf")),
                air_s=None if air_s is None else float(air_s[i])))
        return logs, outputs

    # -- traces ----------------------------------------------------------------
    def run(self, interference, imgs=None, option: Optional[str] = None,
            keep_outputs: bool = False) -> CellResult:
        """``interference``: (n_frames,) shared trace or (n_frames, n_ues)
        per-UE traces.  Resets seeded state first, so repeated ``run`` calls
        on one simulator reproduce exactly."""
        self.reset()
        tele = self.telemetry
        if tele is not None:
            tele.begin_run("lockstep", "slot", self.n_ues)
        trace = np.asarray(interference, float)
        if trace.ndim == 1:
            trace = trace[:, None]
        src = FrameSource(imgs)
        all_logs: List[FrameLog] = []
        all_outs: List[Dict[int, Any]] = []
        for t in range(trace.shape[0]):
            frame_imgs = None
            if imgs is not None:
                frame_imgs = [src.frame(t, i) for i in range(self.n_ues)]
            logs, outs = self.step(trace[t], imgs=frame_imgs, option=option)
            for log in logs:
                log.frame_idx = t
                if tele is not None:
                    tele.record_frame_log(log)
            all_logs.extend(logs)
            if keep_outputs:
                all_outs.append(outs)
        return CellResult(logs=all_logs, stats=self.stats,
                          outputs=all_outs if keep_outputs else None)

    def run_stream(self, interference, imgs=None,
                   option: Optional[str] = None, *, fps=2.0,
                   jitter_s=0.0, inflight: Optional[int] = None,
                   budget_s: Optional[float] = None,
                   keep_outputs: bool = False) -> CellResult:
        """Run the SAME cell on the continuous-time event engine
        (core/timeline.py): per-UE frame clocks (``fps``/``jitter_s``
        scalar or per-UE), streaming head/uplink/tail overlap bounded by
        the ``inflight`` window (None = unbounded), cross-frame backlog
        carry-over in the MAC and at the edge, and capture-anchored
        deadlines.  Configured degenerate (uniform fps, zero jitter,
        unbounded window, load that drains within a frame period) it
        reproduces ``run``'s per-frame logs rng-paired."""
        from repro_torch.core.timeline import run_stream as _run_stream
        return _run_stream(self, interference, imgs=imgs, option=option,
                           fps=fps, jitter_s=jitter_s, inflight=inflight,
                           budget_s=budget_s, keep_outputs=keep_outputs)


def cell_interference_traces(n_frames: int, n_ues: int, seed: int = 0,
                             levels: Sequence[float] = INTERFERENCE_LEVELS,
                             p_move: float = 0.2) -> np.ndarray:
    """Per-UE interference traces: independent sticky random walks over the
    paper's jammer levels (each UE sees the jammer differently as it
    moves through the cell).  Returns (n_frames, n_ues)."""
    rng = np.random.default_rng(seed)
    levels = np.asarray(levels, float)
    idx = rng.integers(0, len(levels), size=n_ues)
    out = np.empty((n_frames, n_ues))
    for t in range(n_frames):
        move = rng.random(n_ues) < p_move
        step = rng.integers(-1, 2, size=n_ues)
        idx = np.clip(idx + np.where(move, step, 0), 0, len(levels) - 1)
        out[t] = levels[idx]
    return out
