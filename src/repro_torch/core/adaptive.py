"""AF (Application Function): adaptive split selection (paper §III-C).

A copy of ``repro/core/adaptive.py`` on the port's types (numpy only; the
estimator it consults runs in torch).  The feedback hooks of the shared
cell, the event timeline, mobility and chaos (``observe_grant``,
``observe_stream``, ``notify_handover``, ``notify_outage``,
``relax_grant``, ``clone``) are kept for the port of those engines; their
comments name the JAX package's modules.

Multi-objective selection of the split point, following [1]:

    l* = argmin_l  w_d * D(l)/D_ref + w_e * E(l)/E_ref + w_p * P(l)
         s.t.      D(l) <= d_max,  E(l) <= e_max

  D(l) = T_head(l) + T_quant + B_c(l) / R_hat + T_path + T_tail(l)
  E(l) = P_ue * T_head(l) + P_tx(I) * B_c(l) / R_hat
  P(l) = distance-correlation leakage profile (core/privacy.py)

R_hat comes from the ML throughput estimator; B_c(l) from the codec's
measured compression ratio (fed back from recent frames).  Hysteresis
prevents split flapping under noisy estimates.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.core.calibration import Calibrated
from repro_torch.core.channel import PathModel, RadioKPM
from repro_torch.core.splitting import SERVER_ONLY, UE_ONLY
from repro_torch.core.throughput import ThroughputEstimator

# distance-correlation leakage per option (core/privacy.py measurements;
# split1 matches the paper's 0.527).  Shared by build_controller and the
# RAN bench/tests so the profile cannot drift between them.
DEFAULT_PRIVACY_PROFILE = {"ue_only": 0.0, "server_only": 1.0,
                           "split1": 0.53, "split2": 0.42,
                           "split3": 0.33, "split4": 0.27}


@dataclass
class Objective:
    w_delay: float = 1.0
    w_energy: float = 0.5
    w_privacy: float = 0.5
    d_max_s: float = float("inf")
    e_max_j: float = float("inf")
    p_max: float = 1.0
    d_ref_s: float = 1.0            # normalizers
    e_ref_j: float = 10.0


@dataclass
class Prediction:
    option: str
    delay_s: float
    energy_j: float
    privacy: float
    cost: float
    feasible: bool


@dataclass
class AdaptiveController:
    system: Calibrated
    estimator: ThroughputEstimator
    objective: Objective
    path: PathModel
    privacy_profile: Dict[str, float]
    # optional SplitPlan for plan-specific accounting.  None = the paper's
    # calibrated Swin tables (the single-UE default); the cell simulator
    # sets it for non-Swin plans so predictions use the plan's own FLOPs
    # and payload specs instead of Swin's.
    plan: Optional[Any] = None
    interference_db: float = -40.0   # latest sensed level (for TX power)
    hysteresis: float = 0.05
    quant_time_s: float = 0.010      # measured codec cost per frame
    _current: Optional[str] = None
    _ratio: float = 1.0              # measured compressed/raw feedback
    # EWMA of the realized *scheduled* rate the serving cell granted us
    # (core/ran.py).  None until the first grant report: an isolated link
    # (the paper's single-UE testbed) never sets it and selection is
    # unchanged.
    _granted_rate: Optional[float] = None
    # streaming feedback (core/timeline.py).  ``frame_period_s`` is the
    # UE's capture period (1/fps); the timeline engine sets it and feeds
    # ``observe_stream`` per completed/dropped frame.  While frames are
    # being dropped the pipeline demonstrably cannot sustain the capture
    # rate, so options whose predicted delay exceeds one frame period are
    # treated as infeasible -- selection moves to a split the stream can
    # actually sustain.  Lock-step engines never set these: zero drop EWMA
    # keeps ``decide`` bit-identical to the pre-timeline behavior.
    frame_period_s: Optional[float] = None
    _drop_ewma: float = 0.0
    _age_ewma: float = 0.0
    drop_backoff: float = 0.05       # drop EWMA above which delay must fit
                                     # inside one frame period
    age_backoff: float = 2.0         # ... and frame-age EWMA (in periods)
                                     # above which likewise: an unbounded
                                     # in-flight window never drops, but a
                                     # growing backlog shows up as age

    # -- per-UE replication (multi-UE cell) ----------------------------------
    def clone(self) -> "AdaptiveController":
        """Fresh controller sharing the (expensively trained) estimator and
        calibrated system, with its own hysteresis/compression-ratio state.
        ``CellSimulator`` spawns one per UE."""
        import dataclasses
        return dataclasses.replace(self, _current=None, _ratio=1.0,
                                   _granted_rate=None, _drop_ewma=0.0,
                                   _age_ewma=0.0)

    def spawn(self, n: int) -> List["AdaptiveController"]:
        return [self.clone() for _ in range(n)]

    # -- feedback from the pipeline ------------------------------------------
    def observe_ratio(self, compressed: int, raw: int):
        if raw > 0:
            self._ratio = 0.7 * self._ratio + 0.3 * (compressed / raw)

    def observe_grant(self, realized_rate_bps: float):
        """Feed back the rate the cell's scheduler actually delivered
        (payload bits over enqueue->delivered, i.e. contention included).
        The estimator predicts the *isolated link* rate; on a loaded cell
        the granted rate is what uplink time actually follows."""
        if realized_rate_bps > 0:
            self._granted_rate = (realized_rate_bps
                                  if self._granted_rate is None else
                                  0.7 * self._granted_rate
                                  + 0.3 * realized_rate_bps)

    def observe_stream(self, age_s: float, dropped: bool):
        """Per-frame streaming feedback from the event timeline: the age
        of the frame at detection and whether the in-flight window forced
        a skip.  Drops raise ``_drop_ewma`` (decide then requires delay <=
        one frame period, see ``frame_period_s``); completions decay it
        and track the age EWMA the frame-age knob optimizes against."""
        self._drop_ewma = 0.8 * self._drop_ewma + 0.2 * float(dropped)
        if not dropped:
            self._age_ewma = (age_s if self._age_ewma == 0.0
                              else 0.7 * self._age_ewma + 0.3 * age_s)

    def notify_handover(self):
        """A handover moved this UE to a different cell (core/mobility.py):
        the granted-rate EWMA describes the OLD cell's load and grants,
        so trusting it on the new cell is exactly the stale-estimate
        failure the paper's adaptive loop exists to avoid.  Drop it --
        ``decide`` falls back to the estimator's link-rate prediction and
        re-probes -- and clear the hysteresis hold so the first post-
        handover decision is made from scratch rather than defended."""
        self._granted_rate = None
        self._current = None

    def notify_outage(self):
        """An injected fault just cleared on this UE's serving path
        (core/chaos.py): edge server back up, dUPF failover/fail-back, or
        a link blackout ending.  Everything the controller learned
        through the fault is suspect -- the granted-rate EWMA observed a
        degraded (or rerouted) cell, and the drop/age EWMAs accumulated
        losses the POST-recovery system will not reproduce.  Mirror
        ``notify_handover`` (estimator reset + hysteresis clear) and
        additionally zero the streaming EWMAs so the backoff does not pin
        selection at ue_only long after the fault cleared; the next
        decisions re-probe from the estimator's link-rate prediction.
        Re-convergence speed is measured per outage
        (``RecoveryMetrics.reconverge_frames``)."""
        self._granted_rate = None
        self._current = None
        self._drop_ewma = 0.0
        self._age_ewma = 0.0

    def relax_grant(self, link_rate_bps: float):
        """Called on frames the UE sent nothing uplink: with no grant to
        observe, the stale congestion estimate decays toward the idle link
        rate so the controller eventually probes an offloading option
        again (otherwise one congestion episode would lock it at ue_only
        forever).  The slow constant makes probing sparse: a still-loaded
        cell knocks the estimate right back down on the probe frame."""
        if self._granted_rate is not None:
            self._granted_rate = (0.95 * self._granted_rate
                                  + 0.05 * link_rate_bps)

    # -- prediction ------------------------------------------------------------
    def predict(self, option: str, rate_bps: float) -> Prediction:
        sysm = self.system
        if self.plan is not None:
            head_t = sysm.ue.compute_time_s(self.plan.head_flops(option))
            tail_t = sysm.edge.compute_time_s(self.plan.tail_flops(option))
            raw_b, comp_b = sysm.payload_bytes(self.plan, option)
        else:
            head_t = sysm.head_time_s(option)
            tail_t = sysm.tail_time_s(option)
            raw_b = sysm.raw_bytes.get(option, 0)
            comp_b = sysm.compressed_bytes.get(option, 0)
        if option == SERVER_ONLY:
            est_b = raw_b                               # raw image ships as-is
        elif raw_b == 0:
            est_b = 0                                   # UE-only
        elif self._ratio < 1.0:
            est_b = int(raw_b * self._ratio)            # live feedback
        else:
            est_b = comp_b                              # calibration default
        tx_t = est_b * 8.0 / rate_bps if est_b else 0.0
        path_t = self.path.base_s if option != UE_ONLY else 0.0
        quant_t = self.quant_time_s if option not in (UE_ONLY, SERVER_ONLY) else 0.0
        delay = head_t + quant_t + tx_t + path_t + tail_t
        energy = (sysm.ue.power_active_w * head_t
                  + sysm.radio.tx_energy_j(tx_t, self.interference_db))
        priv = self.privacy_profile.get(option, 1.0)
        ob = self.objective
        cost = (ob.w_delay * delay / ob.d_ref_s
                + ob.w_energy * energy / ob.e_ref_j
                + ob.w_privacy * priv)
        feasible = (delay <= ob.d_max_s and energy <= ob.e_max_j
                    and priv <= ob.p_max)
        return Prediction(option, delay, energy, priv, cost, feasible)

    # -- decision ---------------------------------------------------------------
    def decide(self, kpm: RadioKPM, spec, options: List[str]) -> Prediction:
        rate = self.estimator.predict(kpm, spec)
        if self._granted_rate is not None:
            # contention-aware: the scheduled rate can only be <= the link
            # rate, so the min keeps an idle cell at the estimator's value
            # while a loaded cell drives selection toward earlier splits /
            # stronger compression (the paper's behavior under interference)
            rate = min(rate, self._granted_rate)
        preds = [self.predict(o, rate) for o in options]
        feas = [p for p in preds if p.feasible] or preds
        if self.frame_period_s is not None and (
                self._drop_ewma > self.drop_backoff
                or self._age_ewma > self.age_backoff * self.frame_period_s):
            # the stream is falling behind -- dropping frames, or (with an
            # unbounded in-flight window, which never drops) detections
            # aging past the backlog threshold: only options whose delay
            # fits inside one capture period can sustain the fps; fall
            # back to the plain feasible set if none does (best effort)
            feas = [p for p in feas
                    if p.delay_s <= self.frame_period_s] or feas
        best = min(feas, key=lambda p: p.cost)
        if self._current is not None and best.option != self._current:
            cur = next((p for p in preds if p.option == self._current), None)
            # the hold must stay inside the candidate set: an option the
            # drop back-off just excluded cannot be held onto
            if cur is not None and cur.feasible and cur in feas and \
               cur.cost <= best.cost * (1.0 + self.hysteresis):
                best = cur                              # hysteresis hold
        self._current = best.option
        return best
