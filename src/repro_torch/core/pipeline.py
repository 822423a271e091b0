"""E2E split-inference frame pipeline (the complete paper system).

The counterpart of ``repro/core/pipeline.py``.  Per frame: sense radio ->
estimate throughput (ML) -> AF picks split -> head (UE) -> int8 quant + zlib
-> uplink (dUPF or cUPF path) -> tail (edge) -> detections; log delay /
energy / payload.

The frame is decomposed into reusable stages

    capture -> sense -> decide -> head -> encode -> uplink -> tail -> account

so ``SplitInferencePipeline.run_frame`` is a straight composition.  The
stage functions are the JAX package's, duck-typed on plan and codec; the
multi-UE ``core/cell.py`` and the event engine ``core/timeline.py`` reuse
them per UE, and ``run_stream`` runs the one-UE cell on that engine.

Model execution and compression are REAL (the port's Swin forward, the CUDA
kernels and the codec on the card, or their plain versions on a CPU); time
and energy are *accounted* with the calibrated device and channel models,
exactly like the paper's measurement harness.  ``quant_s`` is the one
measured time that enters a frame's delay: the host wall time of the encode
(device quant, copy to the host, host zlib).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.swin_t_detection import CONFIG, reduced
from repro_torch.core.adaptive import (DEFAULT_PRIVACY_PROFILE,
                                       AdaptiveController, Objective,
                                       Prediction)
from repro_torch.core.calibration import Calibrated, calibrate
from repro_torch.core.channel import (PathModel, RadioKPM, dupf_path,
                                      iq_spectrogram, observe_kpms)
from repro_torch.core.compression import ActivationCodec
from repro_torch.core.splitting import SERVER_ONLY, UE_ONLY, SwinSplitPlan
from repro_torch.core.throughput import train_estimator
from repro_torch.models import swin as SW


@dataclass
class FrameLog:
    """One frame's accounting.  The fields of the multi-UE cell, the shared
    MAC, the event timeline, mobility and chaos keep their defaults in the
    single-UE pipeline; their comments name the JAX package's engines."""
    option: str
    interference_db: float
    delay_s: float
    head_s: float
    quant_s: float
    tx_s: float
    path_s: float
    tail_s: float
    energy_inf_j: float
    energy_tx_j: float
    raw_bytes: int
    compressed_bytes: int
    rate_bps: float
    predicted: Optional[Prediction] = None
    # multi-UE cell extensions (defaults keep the single-UE pipeline as-is)
    ue_id: int = 0
    queue_s: float = 0.0        # wait at the edge before the tail batch ran
    batch_size: int = 1         # occupancy of the tail batch that served us
    # shared-cell MAC extensions (core/ran.py; defaults = isolated link)
    prb_share: float = 1.0      # granted/offered PRBs while backlogged
    harq_retx: int = 0          # HARQ retransmissions this frame
    deadline_s: float = float("inf")   # frame budget (RAN-scheduled cells)
    air_s: float = 0.0          # radio-active time (= tx_s on isolated links;
                                # < tx_s on a contended cell, where tx_s also
                                # counts slots spent waiting for grants)
    # continuous-time extensions (core/timeline.py; lock-step defaults).
    # ``capture_s`` anchors the frame on the shared absolute clock, so
    # ``deadline_s`` is an absolute instant (= capture + budget) instead of
    # a budget that silently re-anchors every slot; cross-slot lateness is
    # countable.  Lock-step runs keep capture_s = 0, so deadline_s degrades
    # to the per-slot budget and nothing changes.
    frame_idx: int = 0          # per-UE capture index
    capture_s: float = 0.0      # absolute capture timestamp
    age_s: float = 0.0          # frame age at detection (completion - capture;
                                # == delay_s when nothing carries over)
    dropped: bool = False       # skipped by the in-flight window policy
    # mobility extensions (core/mobility.py; defaults = one eternal cell)
    serving_cell: int = 0       # cell serving the UE at capture
    handover_count: int = 0     # UE's cumulative handovers at capture
    # chaos extensions (core/chaos.py; default = no failure injection).
    # Set on frames LOST to an injected fault ("edge_outage"/"upf_outage")
    # as opposed to window-policy drops, which keep drop_reason "".
    drop_reason: str = ""

    @property
    def energy_j(self) -> float:
        return self.energy_inf_j + self.energy_tx_j

    @property
    def deadline_miss(self) -> bool:
        if self.dropped:
            return True
        return self.capture_s + self.delay_s > self.deadline_s


@dataclass(frozen=True)
class FrameSource:
    """Round-robin frame feed over a finite image list -- THE seam the
    per-UE frame clocks (core/timeline.py) plug into.  ``frame(k, ue)``
    is what both the single-UE trace loop (``imgs[i % len]``) and the
    cell's per-slot fan-out (``imgs[(t + i) % len]``) used to spell out
    inline; UE ``u`` watches the stream offset by ``u`` frames so a cell
    of UEs does not all show the edge identical images."""
    imgs: Optional[Sequence[Any]] = None

    def frame(self, frame_idx: int, ue_id: int = 0):
        if self.imgs is None:
            return None
        return self.imgs[(frame_idx + ue_id) % len(self.imgs)]


# ---------------------------------------------------------------------------
# stages -- each is a pure function of (plan/system/...) usable per-UE
# ---------------------------------------------------------------------------

@dataclass
class HeadResult:
    head_s: float
    payload: Any                 # boundary pytree (None for UE_ONLY)
    local_out: Any               # detections when the UE ran everything


@dataclass
class EncodeResult:
    quant_s: float
    raw_bytes: int
    compressed_bytes: int
    payload: Any                 # server-side view (post codec roundtrip)


@dataclass
class UplinkResult:
    rate_bps: float
    tx_s: float
    path_s: float


def sense_stage(interference_db: float, narrowband: bool,
                rng: np.random.Generator, grant_share=None,
                buffer_bytes=None) -> Tuple[RadioKPM, np.ndarray]:
    """Sample what the RAN exposes this frame: KPMs + IQ spectrogram.
    On a scheduled cell the MAC's grant history / buffer status ride along
    as KPM fields (no extra rng draws; core/ran.py)."""
    kpm = observe_kpms(interference_db, narrowband, rng,
                       grant_share=grant_share, buffer_bytes=buffer_bytes)
    spec = iq_spectrogram(interference_db, narrowband, rng)
    return kpm, spec


def decide_stage(controller: AdaptiveController, kpm: RadioKPM, spec,
                 options: List[str], interference_db: float,
                 path: PathModel) -> Prediction:
    """AF split selection from the sensed radio state."""
    controller.interference_db = interference_db
    controller.path = path
    return controller.decide(kpm, spec, options)


def head_stage(plan: Any, system: Calibrated, img, option: str,
               execute_model: bool) -> HeadResult:
    """UE-side forward up to the split boundary (accounted UE time)."""
    head_s = system.ue.compute_time_s(plan.head_flops(option))
    payload = local = None
    if execute_model:
        payload, local = plan.head(img, option)
    return HeadResult(head_s=head_s, payload=payload, local_out=local)


def encode_stage(plan: Any, system: Calibrated, codec: ActivationCodec,
                 payload, option: str, execute_model: bool,
                 controller: Optional[AdaptiveController] = None) -> EncodeResult:
    """INT8+zlib the boundary payload (or account its size via
    ``Calibrated.payload_bytes`` -- tables for the calibrated Swin plan,
    spec-based estimates for any other plan)."""
    if option == UE_ONLY:
        return EncodeResult(0.0, 0, 0, None)
    if option == SERVER_ONLY:
        raw, comp = system.payload_bytes(plan, SERVER_ONLY)
        return EncodeResult(0.0, raw, comp, payload)
    if execute_model:
        t0 = time.perf_counter()
        comp = codec.compress(payload)
        quant_s = time.perf_counter() - t0
        payload = codec.decompress(comp)             # server view
        if controller is not None:
            controller.observe_ratio(comp.compressed_bytes, comp.raw_bytes)
        return EncodeResult(quant_s, comp.raw_bytes, comp.compressed_bytes,
                            payload)
    raw, comp = system.payload_bytes(plan, option, codec)
    return EncodeResult(0.010, raw, comp, payload)


def head_encode_stage(plan: Any, system: Calibrated,
                      codec: ActivationCodec, img, option: str,
                      execute_model: bool,
                      controller: Optional[AdaptiveController] = None
                      ) -> Tuple[HeadResult, EncodeResult]:
    """Fused head->encode: ``codec.compress_head`` runs the plan's stable
    head producer and quantises its output on the device in one launch with
    one copy down, producing blobs byte-identical to head_stage +
    encode_stage.

    Falls back to the two-stage composition whenever the codec's
    configuration does not fuse (degenerate split options, accounting-only
    runs, the legacy codec and the non-int8 modes, plans without a head
    producer).  Accounting semantics: head_s stays the calibrated table
    time; ``quant_s`` is the measured wall time of the fused call -- it
    covers head+encode on this host, where the unfused path's quant_s
    covered encode alone (the calibrated delay model charges head time from
    head_s either way)."""
    producer = getattr(plan, "head_jitted", lambda _o: None)(option) \
        if execute_model and codec.supports_fused() else None
    if producer is None:
        head = head_stage(plan, system, img, option, execute_model)
        enc = encode_stage(plan, system, codec, head.payload, option,
                           execute_model, controller)
        return head, enc
    head_s = system.ue.compute_time_s(plan.head_flops(option))
    t0 = time.perf_counter()
    comp, payload = codec.compress_head(producer, plan.params, img)
    quant_s = time.perf_counter() - t0
    view = codec.decompress(comp)                    # server view
    if controller is not None:
        controller.observe_ratio(comp.compressed_bytes, comp.raw_bytes)
    return (HeadResult(head_s=head_s, payload=payload, local_out=None),
            EncodeResult(quant_s, comp.raw_bytes, comp.compressed_bytes,
                         view))


def encode_group_stage(plan: Any, system: Calibrated,
                       codec: ActivationCodec, payloads: Sequence[Any],
                       option: str, execute_model: bool,
                       controllers: Sequence[Optional[AdaptiveController]]
                       ) -> List[EncodeResult]:
    """Encode many same-option boundary payloads in ONE fused device pass.

    The cell's per-slot entry: ``codec.compress_group`` packs every UE's
    leaves into a single launch/transfer and still emits per-UE blobs
    byte-identical to per-UE ``compress`` (the uplink accounting and the
    receiver see exactly the per-UE path), then ``decompress_group``
    rebuilds all server views with one launch, device-resident for
    ``tail_batched``.  Per-UE ``quant_s`` is the group's encode wall time
    divided by the group size: encode cost is ~linear in payload bytes
    (kernel + per-UE zlib slice), so total/B estimates the time ONE UE's
    own device would spend on its own payload -- the quantity the energy
    and delay models charge.  (The same holds for the serial fallback,
    where total/B is exactly the mean per-payload time.)  Falls back to
    per-payload ``encode_stage`` for the degenerate options and
    accounting-only mode."""
    if not execute_model or option in (UE_ONLY, SERVER_ONLY):
        return [encode_stage(plan, system, codec, p, option, execute_model, c)
                for p, c in zip(payloads, controllers)]
    # quant_s covers encode only, matching per-UE encode_stage (which stops
    # its clock before the server-side decompress)
    t0 = time.perf_counter()
    comps = codec.compress_group(payloads)
    quant_s = (time.perf_counter() - t0) / max(len(payloads), 1)
    views = codec.decompress_group(comps)
    out = []
    for comp, view, ctrl in zip(comps, views, controllers):
        if ctrl is not None:
            ctrl.observe_ratio(comp.compressed_bytes, comp.raw_bytes)
        out.append(EncodeResult(quant_s, comp.raw_bytes,
                                comp.compressed_bytes, view))
    return out


def uplink_stage(system: Calibrated, path: PathModel, compressed_bytes: int,
                 interference_db: float, narrowband: bool,
                 rng: np.random.Generator, option: str) -> UplinkResult:
    """Radio transmission + user-plane path traversal."""
    rate = system.channel.sample_rate(interference_db, rng,
                                      narrowband=narrowband)
    tx_s = system.channel.tx_time_s(compressed_bytes, rate) \
        if compressed_bytes else 0.0
    path_s = path.sample_latency(rng) if option != UE_ONLY else 0.0
    return UplinkResult(rate_bps=rate, tx_s=tx_s, path_s=path_s)


def tail_stage(plan: Any, system: Calibrated, payload, option: str,
               execute_model: bool) -> Tuple[float, Any]:
    """Edge-side tail (single-UE path; the cell batches this instead)."""
    tail_s = system.edge.compute_time_s(plan.tail_flops(option))
    out = None
    if execute_model and option != UE_ONLY:
        out = plan.tail(payload, option)
    return tail_s, out


def account_stage(system: Calibrated, option: str, interference_db: float,
                  head: HeadResult, enc: EncodeResult, up: UplinkResult,
                  tail_s: float, *, queue_s: float = 0.0, batch_size: int = 1,
                  ue_id: int = 0, predicted: Optional[Prediction] = None,
                  prb_share: float = 1.0, harq_retx: int = 0,
                  deadline_s: float = float("inf"),
                  air_s: Optional[float] = None,
                  extra_wait_s: float = 0.0, capture_s: float = 0.0,
                  frame_idx: int = 0,
                  age_s: Optional[float] = None,
                  serving_cell: int = 0,
                  handover_count: int = 0,
                  dropped: bool = False,
                  drop_reason: str = "") -> FrameLog:
    """Fold stage timings into delay + energy, paper §V style.

    The UE power analyzer integrates over the whole frame interval: active
    while computing, idle while waiting for uplink + edge (incl. any cell
    queueing delay).  ``air_s`` is the radio-active time the TX power is
    charged for; on an isolated link it equals ``tx_s`` (the paper's
    setting), on a RAN-scheduled cell it is the granted slots only --
    charging the whole MAC wait at TX power would inflate UE radio energy
    by ~1/prb_share (slots without a grant idle the radio).

    ``extra_wait_s`` carries waits the per-frame stage results cannot see
    (the event timeline's compute-busy delay before the head could even
    start); it extends the frame interval at idle power.  ``capture_s``,
    ``frame_idx`` and ``age_s`` anchor the log on the absolute clock; the
    lock-step engines leave them at their zero defaults (``age_s`` then
    equals ``delay_s``).  Under streaming pipelining per-frame intervals
    of ONE UE overlap in wall time; the timeline engine additionally
    reports the non-double-counted per-UE wall-clock energy
    (``energy.interval_energy_j``)."""
    if air_s is None:
        air_s = up.tx_s
    wait_s = up.tx_s + up.path_s + queue_s + tail_s + extra_wait_s
    e_inf = (system.ue.power_active_w * head.head_s
             + system.ue.power_idle_w * wait_s)
    e_tx = system.radio.tx_energy_j(air_s, interference_db)
    delay_s = (head.head_s + enc.quant_s + up.tx_s + up.path_s
               + queue_s + tail_s + extra_wait_s)
    return FrameLog(option=option, interference_db=interference_db,
                    delay_s=delay_s,
                    head_s=head.head_s, quant_s=enc.quant_s, tx_s=up.tx_s,
                    path_s=up.path_s, tail_s=tail_s,
                    energy_inf_j=e_inf, energy_tx_j=e_tx,
                    raw_bytes=enc.raw_bytes, compressed_bytes=enc.compressed_bytes,
                    rate_bps=up.rate_bps, predicted=predicted,
                    ue_id=ue_id, queue_s=queue_s, batch_size=batch_size,
                    prb_share=prb_share, harq_retx=harq_retx,
                    deadline_s=deadline_s, air_s=air_s,
                    frame_idx=frame_idx, capture_s=capture_s,
                    age_s=delay_s if age_s is None else age_s,
                    serving_cell=serving_cell,
                    handover_count=handover_count,
                    dropped=dropped, drop_reason=drop_reason)


# ---------------------------------------------------------------------------
# single-UE pipeline: the stages composed (the paper's testbed)
# ---------------------------------------------------------------------------

@dataclass
class SplitInferencePipeline:
    plan: Any
    system: Calibrated
    codec: ActivationCodec
    controller: Optional[AdaptiveController] = None
    path: PathModel = field(default_factory=dupf_path)
    narrowband: bool = False
    seed: int = 0
    execute_model: bool = True      # False = accounting-only (fast sweeps)
    fused_head: bool = True         # one device pass for head + int8 quant
                                    # (byte-identical payloads)
    # telemetry plane (core/telemetry.py): a run-scoped recorder fed by
    # run_trace / run_stream.  Hooks only read finished FrameLogs, so
    # attaching one never perturbs the simulation (no rng draws).
    telemetry: Optional[Any] = None

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    # -- single frame ---------------------------------------------------------
    def run_frame(self, img, interference_db: float,
                  option: Optional[str] = None) -> FrameLog:
        rng = self._rng
        kpm, spec = sense_stage(interference_db, self.narrowband, rng)
        pred = None
        if option is None:
            if self.controller is None:
                raise ValueError("an adaptive frame needs a controller; "
                                 "pass option= to run a fixed split")
            pred = decide_stage(self.controller, kpm, spec, self.plan.options,
                                interference_db, self.path)
            option = pred.option

        with torch.no_grad():
            if self.fused_head:
                head, enc = head_encode_stage(
                    self.plan, self.system, self.codec, img, option,
                    self.execute_model, self.controller)
            else:
                head = head_stage(self.plan, self.system, img, option,
                                  self.execute_model)
                enc = encode_stage(self.plan, self.system, self.codec,
                                   head.payload, option, self.execute_model,
                                   self.controller)
            up = uplink_stage(self.system, self.path, enc.compressed_bytes,
                              interference_db, self.narrowband, rng, option)
            tail_s, _ = tail_stage(self.plan, self.system, enc.payload,
                                   option, self.execute_model)
        return account_stage(self.system, option, interference_db,
                             head, enc, up, tail_s, predicted=pred)

    # -- traces ------------------------------------------------------------------
    def run_trace(self, imgs, interference_trace, option: Optional[str] = None
                  ) -> List[FrameLog]:
        src = FrameSource(imgs if self.execute_model else None)
        if self.telemetry is not None:
            self.telemetry.begin_run("single_ue", "slot", 1)
        logs = []
        for i, lvl in enumerate(interference_trace):
            log = self.run_frame(src.frame(i), lvl, option)
            log.frame_idx = i
            if self.telemetry is not None:
                self.telemetry.record_frame_log(log)
            logs.append(log)
        return logs

    def run_stream(self, interference_trace, imgs=None,
                   option: Optional[str] = None, *, fps: float = 2.0,
                   jitter_s: float = 0.0, inflight: Optional[int] = None,
                   budget_s: Optional[float] = None):
        """Run the SAME single-UE system on the continuous-time event
        engine (core/timeline.py): the frame clock ticks at ``fps`` with
        capture ``jitter_s``, head/encode of frame N+1 overlaps uplink of
        frame N inside the ``inflight`` window, and congestion carries
        over between frames instead of re-anchoring each one.  Returns a
        ``core.cell.CellResult`` for the one-UE cell.  (The event engine
        owns its rng discipline -- per-frame draws pair with the
        multi-UE cell engines, not with ``run_trace``.)"""
        from repro_torch.core.cell import CellSimulator
        from repro_torch.core.timeline import run_stream as _run_stream
        sim = CellSimulator(
            plan=self.plan, system=self.system, codec=self.codec,
            controller=self.controller, path=self.path,
            narrowband=self.narrowband, seed=self.seed, n_ues=1,
            execute_model=self.execute_model, fused_head=self.fused_head,
            telemetry=self.telemetry, device=self.codec.device)
        trace = np.asarray(interference_trace, float).reshape(-1, 1)
        return _run_stream(sim, trace, imgs=imgs, option=option, fps=fps,
                           jitter_s=jitter_s, inflight=inflight,
                           budget_s=budget_s)


def build_pipeline(cfg=None, params=None, *, adaptive: bool = True,
                   execute_model: bool = True, path: Optional[PathModel] = None,
                   objective: Optional[Objective] = None, seed: int = 0,
                   privacy_profile: Optional[Dict[str, float]] = None,
                   system: Optional[Calibrated] = None,
                   generator: Optional[torch.Generator] = None,
                   device="cuda") -> SplitInferencePipeline:
    """Assemble the full system on ``device``.  Weights, when not given,
    come from the port's ``init`` on ``generator`` (default: a generator
    seeded with ``seed``)."""
    device = resolve_device(device)
    system = system or calibrate(device=device)
    cfg = cfg or (CONFIG if execute_model is False else reduced())
    if params is None and execute_model:
        params = SW.init(cfg, generator or torch.Generator().manual_seed(seed),
                         device=device)
    plan = SwinSplitPlan(cfg, params, device=device)
    # accounting always uses the calibrated full-size system
    codec = ActivationCodec(device=device)
    controller = None
    if adaptive:
        controller = build_controller(system, path=path, objective=objective,
                                      seed=seed, privacy_profile=privacy_profile,
                                      device=device)
    return SplitInferencePipeline(
        plan=plan, system=system, codec=codec, controller=controller,
        path=path or dupf_path(), seed=seed, execute_model=execute_model)


def build_controller(system: Calibrated, *, path: Optional[PathModel] = None,
                     objective: Optional[Objective] = None, seed: int = 0,
                     privacy_profile: Optional[Dict[str, float]] = None,
                     device="cuda", estimator_init: Optional[list] = None
                     ) -> AdaptiveController:
    """Train the throughput estimator on ``device`` (from
    ``estimator_init``'s weights when given, as ``train_estimator``'s
    ``params``) and wire up one AF controller."""
    est = train_estimator(system.channel, "kpm+spec", n_train=1024,
                          steps=200, seed=seed, device=device,
                          params=estimator_init)
    prof = privacy_profile or dict(DEFAULT_PRIVACY_PROFILE)
    return AdaptiveController(
        system=system, estimator=est,
        objective=objective or Objective(),
        path=path or dupf_path(), privacy_profile=prof)
