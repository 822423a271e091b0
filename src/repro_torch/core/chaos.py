"""A copy of ``repro/core/chaos.py`` (numpy only), on the port's
``runtime/failures.py``; the same seed gives the same outage schedule.

Chaos & churn: deterministic failure injection for the streaming cell.

The paper's headline system claim is *runtime stability* on a live AI-RAN
testbed; every engine before this module only ever simulated steady
state.  This module layers four failure/churn axes on the continuous-time
event engine (core/timeline.py):

  * **UE churn** (``ChurnSpec``): UEs join and leave mid-run on
    alternating exponential sojourns, with the arrival intensity shaped
    by a diurnal sinusoid and scripted flash-crowd windows (a crowd
    compresses the off-sojourns, so departures return faster).  Absent
    UEs' captures are skipped silently -- no frame, no drop.
  * **Edge-server outages** (``ChaosConfig.edge_outage``): the
    ``EdgeQueue`` is unavailable inside the outage windows.  Policy
    ``"requeue"`` defers any batch whose execution would overlap an
    outage until recovery plus a warm-up penalty (cold caches, model
    re-load); policy ``"drop"`` rejects requests *arriving* during the
    outage -- the frame is lost (``drop_reason="edge_outage"``).
  * **dUPF outage + failover** (``ChaosConfig.upf_outage``): frames
    routed through the primary user-plane path while it is down are lost
    in flight.  With ``failover=True`` the heartbeat detector reroutes
    subsequent frames through ``failover_path`` (the cUPF backhaul,
    reusing the mobility path-selection plumbing) and fails back once
    the detector sees the primary recover.
  * **Link blackouts** (``ChaosConfig.blackout``): per-UE rate -> 0
    intervals.  At blackout start the UE's unfinished flows are parked
    out of the MAC (``migrate_ue``, in-flight HARQ transport block
    flushed as a loss -- the handover plumbing); at blackout end they
    re-enter the serving cell's stream (``adopt``) and the backlog
    drains, identically in the python and vectorized engines.

**Detection is earned, not oracle.**  ``runtime/failures.py`` provides
the control loop: a ``HeartbeatMonitor`` on the simulation's absolute
clock (``strict_clock=True`` -- wall-clock defaults are refused) beats
for every component that is actually up at each tick; ``decide_recovery``
(fed a ``StragglerMonitor`` tracking real edge batch times and path
latencies) turns missed beats into the failover state machine's
transitions.  The engine therefore reacts at the *detection* instant
(outage start + timeout + up to one period), not the ground-truth
instant -- frames in flight before detection are the detection-latency
cost.

**Rng discipline.**  ``CellSimulator.reset`` hands the model ONE
dedicated SeedSequence child (spawned at the END of the existing layout,
so no earlier stream moves); ``reset`` sub-spawns one grandchild per
chaos feature (edge / upf / blackout / churn) so enabling or tuning one
feature never moves another's schedule.  Every spec draws a FIXED count
(``OutageSpec.max_events`` exponential pairs; one uniform plus
``ChurnSpec.max_toggles`` exponentials per UE) regardless of the
configured rates, so a zero-rate ("zero-chaos") config consumes the same
draws as a live one -- and, because the child is dedicated, a zero-chaos
config replays the chaos-free engines **bitwise**
(tests/test_chaos.py).

Recovery metrics (``RecoveryMetrics``, surfaced as
``CellResult.recovery``): detection latency, time-to-recover (outage
start -> first completed frame after the outage end), dropped-frame
burst length, losses attributed to the window, and controller
re-convergence (decided frames after the outage until the pre-outage
split option is re-selected).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.channel import PathModel, cupf_path
from repro_torch.runtime.failures import (HeartbeatMonitor,
                                          StragglerMonitor, decide_recovery)

# heartbeat worker ids: the edge inference server and the primary
# user-plane function are the two monitored components
EDGE_WORKER = 0
UPF_WORKER = 1


def _merge(windows: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merge overlapping/touching (start, end) windows, sorted."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(windows):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _merge_censored(windows: List[Tuple[float, float]],
                    censored: List[bool]
                    ) -> Tuple[List[Tuple[float, float]], List[bool]]:
    """``_merge`` carrying per-window censor flags: a merged window is
    censored iff any constituent was."""
    out: List[Tuple[float, float]] = []
    flags: List[bool] = []
    for (a, b), c in sorted(zip(windows, censored)):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
            flags[-1] = flags[-1] or c
        else:
            out.append((a, b))
            flags.append(bool(c))
    return out, flags


def _pad_flags(flags: Sequence[bool], n: int) -> List[bool]:
    """Censor flags padded with False to window-list length (schedules
    poked in by hand -- tests, demos -- carry no flags)."""
    return list(flags) + [False] * (n - len(flags))


def _clamp_horizon(windows: List[Tuple[float, float]], horizon_s: float
                   ) -> Tuple[List[Tuple[float, float]], List[bool]]:
    """Clip merged windows to the simulated horizon.  A window whose
    true end lies past the horizon is CENSORED: the run ended while the
    fault was still active, so no recovery instant exists inside
    simulated time.  (Previously such windows kept their raw end, and
    ``RecoveryMetrics.time_to_recover`` / availability described time
    that was never simulated.)  Windows opening at or after the horizon
    never happen and are dropped."""
    wins: List[Tuple[float, float]] = []
    cens: List[bool] = []
    for a, b in windows:
        if a >= horizon_s:
            continue
        wins.append((a, min(b, horizon_s)))
        cens.append(b > horizon_s)
    return wins, cens


def _inside(windows: Sequence[Tuple[float, float]], t: float) -> bool:
    return any(a <= t < b for a, b in windows)


@dataclass(frozen=True)
class OutageSpec:
    """When one component is down: an explicit ``schedule`` of
    ``(start_s, duration_s)`` windows plus an optional stochastic
    process (Poisson arrivals at ``rate_hz``, exponential durations with
    mean ``mean_duration_s``).

    Draw discipline: ``windows`` consumes exactly ``max_events``
    gap/duration exponential pairs from its rng EVERY call, whatever the
    rate -- so tuning the rate (including to zero) never changes the
    draw count, and a spec left at its defaults schedules nothing while
    keeping its dedicated stream's state deterministic."""
    schedule: Tuple[Tuple[float, float], ...] = ()
    rate_hz: float = 0.0
    mean_duration_s: float = 0.0
    max_events: int = 4

    def windows(self, rng: np.random.Generator,
                horizon_s: float) -> List[Tuple[float, float]]:
        return self.windows_censored(rng, horizon_s)[0]

    def windows_censored(self, rng: np.random.Generator, horizon_s: float
                         ) -> Tuple[List[Tuple[float, float]], List[bool]]:
        """Windows clipped to the horizon plus a per-window censor flag
        (True = the fault outlived the run; see ``_clamp_horizon``)."""
        gaps = rng.standard_exponential(self.max_events)
        durs = rng.standard_exponential(self.max_events)
        out = [(float(a), float(a) + float(d)) for a, d in self.schedule]
        if self.rate_hz > 0.0 and self.mean_duration_s > 0.0:
            t = 0.0
            for g, d in zip(gaps, durs):
                t += float(g) / self.rate_hz
                if t >= horizon_s:
                    break
                dur = float(d) * self.mean_duration_s
                out.append((t, t + dur))
                t += dur
        return _clamp_horizon(_merge(out), horizon_s)


@dataclass(frozen=True)
class ChurnSpec:
    """UE admission/departure churn.  Each UE alternates exponential
    present/absent sojourns (means ``mean_on_s`` / ``mean_off_s``; zero
    means the current state is permanent).  The *arrival* intensity --
    how fast absent UEs return -- is shaped by a diurnal sinusoid
    (period/depth) and scripted ``flash_crowds`` windows
    ``(start_s, duration_s, boost)``: intensity divides the off-sojourn,
    so a flash crowd pulls the whole absent population back in.

    Draw discipline: ``intervals`` consumes one uniform (initial
    presence) plus ``max_toggles`` exponentials per UE, for EVERY UE,
    whatever the means -- a no-churn config draws the same count."""
    initial_p: float = 1.0
    mean_on_s: float = 0.0
    mean_off_s: float = 0.0
    max_toggles: int = 8
    diurnal_period_s: float = 0.0
    diurnal_depth: float = 0.0
    flash_crowds: Tuple[Tuple[float, float, float], ...] = ()

    def intensity(self, t: float) -> float:
        x = 1.0
        if self.diurnal_period_s > 0.0:
            x += self.diurnal_depth * math.sin(
                2.0 * math.pi * t / self.diurnal_period_s)
        for t0, dur, boost in self.flash_crowds:
            if t0 <= t < t0 + dur:
                x += boost
        return max(x, 1e-6)

    def _hazard(self, a: float, b: float) -> float:
        """``integral_a^b intensity(s) ds`` in closed form: the constant
        base integrates linearly, the diurnal sinusoid through its exact
        antiderivative, each flash crowd over its clipped overlap."""
        x = b - a
        if self.diurnal_period_s > 0.0:
            w = 2.0 * math.pi / self.diurnal_period_s
            x += self.diurnal_depth / w * (math.cos(w * a) - math.cos(w * b))
        for t0, dur, boost in self.flash_crowds:
            lo, hi = max(a, t0), min(b, t0 + dur)
            if hi > lo:
                x += boost * (hi - lo)
        return x

    def _off_end(self, t: float, target: float) -> float:
        """Inverse-integrated-hazard time change for one off-sojourn:
        the first ``T > t`` with ``integral_t^T intensity(s) ds ==
        target``, consuming no draws.  The off-hazard now integrates
        the intensity over the WHOLE sojourn, so a flash crowd (or
        diurnal peak) opening mid-sojourn compresses the remaining
        absence -- previously ``intensity`` was evaluated only at the
        sojourn start, so a crowd starting later never pulled the UE
        back (the ``intervals`` bugfix).  Piecewise-constant intensity
        (no diurnal term) inverts in closed form segment by segment
        over the flash-crowd breakpoints; with a diurnal sinusoid the
        cumulative hazard is still strictly increasing (intensity > 0),
        so it is inverted by bisection on the exact antiderivative."""
        if self.diurnal_period_s <= 0.0:
            if not self.flash_crowds:
                return t + target / self.intensity(t)
            a = t
            for b in sorted({e for t0, dur, _x in self.flash_crowds
                             for e in (t0, t0 + dur) if e > t}):
                seg = self._hazard(a, b)
                if target <= seg:
                    return a + target / self.intensity(a)
                target -= seg
                a = b
            return a + target / self.intensity(a)   # constant tail
        lo_int = max(1.0 - abs(self.diurnal_depth), 1e-6)
        lo, hi = t, t + target / lo_int
        for _ in range(200):
            if hi - lo <= 1e-12 * max(abs(hi), 1.0):
                break
            mid = 0.5 * (lo + hi)
            if self._hazard(t, mid) < target:
                lo = mid
            else:
                hi = mid
        return hi

    def intervals(self, rng: np.random.Generator, horizon_s: float,
                  n_ues: int) -> List[List[Tuple[float, float]]]:
        """Per-UE presence intervals over [0, horizon]."""
        pres = rng.random(n_ues)
        soj = rng.standard_exponential((n_ues, self.max_toggles))
        out: List[List[Tuple[float, float]]] = []
        for u in range(n_ues):
            on = bool(pres[u] < self.initial_p)
            t, start = 0.0, 0.0
            iv: List[Tuple[float, float]] = []
            for j in range(self.max_toggles):
                if on:
                    if self.mean_on_s <= 0.0:
                        break                      # present forever
                    t += float(soj[u, j]) * self.mean_on_s
                    iv.append((start, t))
                    on = False
                else:
                    if self.mean_off_s <= 0.0:
                        break                      # absent forever
                    # SAME single exponential draw, time-changed through
                    # the inverse integrated hazard (fixed draw budget)
                    t = self._off_end(t, float(soj[u, j]) * self.mean_off_s)
                    start, on = t, True
                if t >= horizon_s:
                    break
            if on:
                iv.append((start, math.inf))
            out.append(iv)
        return out


@dataclass(frozen=True)
class CorrelationSpec:
    """Correlated failure models: no real site outage is an independent
    window.  Three couplings, all layered on the independent specs:

      * **Site power** (``site_power`` schedule and/or the stochastic
        ``site_power_rate_hz``/``site_power_mean_s`` process): one
        window takes the edge server AND the primary dUPF down
        together -- the windows merge into BOTH components' schedules,
        so failover has nowhere useful to go while the edge is dark.
      * **Weather front** (``weather_front`` = ``(start_s,
        duration_s)`` windows): a link blackout sweeping the cell grid;
        cell ``c`` goes dark at ``start + c * front_offset_s`` for the
        front's duration.  A faulted site's RSRP proxy drops by
        ``fault_penalty_db`` (core/mobility.py), so A3 evacuates its
        UEs to healthy neighbors -- unless the front is simultaneous
        and there is no healthy neighbor to flee to.
      * **Outage-triggered churn surge** (``surge_boost`` /
        ``surge_duration_s``): a flash-crowd re-entry boost pinned to
        every edge/upf recovery instant -- the crowd that reconnects
        the moment service returns.

    Draw discipline: the site-power process consumes exactly
    ``max_site_events`` gap/duration pairs from the model's dedicated
    5th grandchild rng EVERY run, whatever the rate; weather fronts and
    churn surges are deterministic functions of already-drawn state (no
    draws).  ``SeedSequence`` sub-spawns are index-stable, so growing
    the spawn from 4 to 5 grandchildren never moved the four
    independent-feature streams -- a zero-correlation config replays
    every engine field-exact (tests/test_chaos.py)."""
    site_power: Tuple[Tuple[float, float], ...] = ()
    site_power_rate_hz: float = 0.0
    site_power_mean_s: float = 0.0
    max_site_events: int = 4
    weather_front: Tuple[Tuple[float, float], ...] = ()
    front_offset_s: float = 0.0
    surge_boost: float = 0.0
    surge_duration_s: float = 0.0
    fault_penalty_db: float = 60.0


@dataclass
class ChaosConfig:
    """What can fail, and how the cell reacts.

    ``edge_policy``: ``"requeue"`` (batches overlapping an edge outage
    re-execute after recovery + ``edge_warmup_s``) or ``"drop"``
    (requests arriving during the outage are lost).  ``failover``
    reroutes the user plane through ``failover_path`` while the
    heartbeat detector believes the primary path is down.  The detector
    ticks every ``heartbeat_period_s`` and declares a component dead
    after ``heartbeat_timeout_s`` without a beat."""
    edge_outage: Optional[OutageSpec] = None
    upf_outage: Optional[OutageSpec] = None
    blackout: Optional[OutageSpec] = None
    blackout_ues: Optional[Sequence[int]] = None   # None = every UE
    churn: Optional[ChurnSpec] = None
    correlation: Optional[CorrelationSpec] = None
    edge_policy: str = "requeue"
    edge_warmup_s: float = 0.0
    failover: bool = True
    failover_path: PathModel = field(default_factory=cupf_path)
    heartbeat_period_s: float = 0.5
    heartbeat_timeout_s: float = 1.2

    def __post_init__(self):
        if self.edge_policy not in ("requeue", "drop"):
            raise ValueError(f"unknown edge_policy {self.edge_policy!r}; "
                             f"choose 'requeue' or 'drop'")


@dataclass
class RecoveryMetrics:
    """Per-outage-window recovery record (CellResult.recovery)."""
    component: str                 # 'edge' | 'upf' | 'link'
    start_s: float
    end_s: float
    detect_s: float = float("nan")      # heartbeat declared it down
    clear_s: float = float("nan")       # heartbeat saw it back up
    action: str = ""                    # decide_recovery at detection
    time_to_recover_s: float = float("nan")  # start -> first completion
                                             # after the outage end
    n_lost: int = 0                     # frames lost to this window
    burst_len: int = 0                  # longest per-UE run of consecutive
                                        # captures in-window with no detection
    reconverge_frames: Optional[float] = None  # mean decided frames after
                                               # end until the pre-outage
                                               # option is re-selected
    censored: bool = False              # the run ended inside the window:
                                        # no recovery instant exists in
                                        # simulated time (not a recovery)
    cell: Optional[int] = None          # cell-targeted (weather front)
                                        # windows carry the cell index


class ChaosModel:
    """Failure schedule + detector/failover state for one cell run.

    ``reset(n_ues, seq)`` re-seeds from the simulator's dedicated
    SeedSequence child; ``begin(horizon_s)`` draws the schedules and
    returns the timeline's chaos events; ``heartbeat(t)`` runs one
    detector tick and returns the transition signals the engine reacts
    to; ``finalize(...)`` folds the run into ``RecoveryMetrics``."""

    def __init__(self, cfg: Optional[ChaosConfig] = None):
        self.cfg = cfg or ChaosConfig()

    # -- seeding (CellSimulator.reset) ---------------------------------------
    def reset(self, n_ues: int, seq: np.random.SeedSequence):
        self.n_ues = n_ues
        # one grandchild per feature: enabling/tuning one feature never
        # moves another's schedule (index-stable sub-spawn; the 5th
        # child is the CorrelationSpec's -- growing the spawn count
        # never moves the first four streams)
        kids = seq.spawn(5)
        self._rngs = [np.random.default_rng(k) for k in kids]
        self.edge_windows: List[Tuple[float, float]] = []
        self.upf_windows: List[Tuple[float, float]] = []
        self.blackout_windows: List[Tuple[float, float]] = []
        self.site_windows: List[Tuple[float, float]] = []
        self.edge_censored: List[bool] = []
        self.upf_censored: List[bool] = []
        self.blackout_censored: List[bool] = []
        # weather-front blackouts targeted at one cell's serving UEs:
        # (cell, start, end) plus the matching censor flags
        self.cell_blackout_windows: List[Tuple[int, float, float]] = []
        self.cell_censored: List[bool] = []
        self.effective_churn: Optional[ChurnSpec] = self.cfg.churn
        self._churn_iv: Optional[List[List[Tuple[float, float]]]] = None
        self.routed_failover = False
        self.monitor = HeartbeatMonitor(
            n_workers=2, timeout_s=self.cfg.heartbeat_timeout_s,
            strict_clock=True)
        self.straggler = StragglerMonitor(n_workers=2)
        self.transitions: List[Dict[str, Any]] = []
        self._down = {EDGE_WORKER: False, UPF_WORKER: False}

    # -- schedule -------------------------------------------------------------
    def begin(self, horizon_s: float,
              n_cells: int = 1) -> List[Tuple[float, str, Any]]:
        """Draw the run's schedules and return the chaos events for the
        event loop, sorted by time: ``(t, kind, payload)`` with kinds
        ``heartbeat`` / ``blackout_start`` / ``blackout_end`` /
        ``cell_blackout_start`` / ``cell_blackout_end``.  ``n_cells``
        sizes the weather-front sweep (the mobility site count)."""
        cfg = self.cfg
        corr = cfg.correlation
        if cfg.edge_outage is not None:
            self.edge_windows, self.edge_censored = \
                cfg.edge_outage.windows_censored(self._rngs[0], horizon_s)
        if cfg.upf_outage is not None:
            self.upf_windows, self.upf_censored = \
                cfg.upf_outage.windows_censored(self._rngs[1], horizon_s)
        if cfg.blackout is not None:
            self.blackout_windows, self.blackout_censored = \
                cfg.blackout.windows_censored(self._rngs[2], horizon_s)
        if corr is not None:
            # site power: one window takes edge + dUPF down TOGETHER --
            # drawn from the dedicated 5th grandchild with OutageSpec's
            # fixed budget, then merged into both component schedules
            spec = OutageSpec(schedule=corr.site_power,
                              rate_hz=corr.site_power_rate_hz,
                              mean_duration_s=corr.site_power_mean_s,
                              max_events=corr.max_site_events)
            self.site_windows, site_cens = spec.windows_censored(
                self._rngs[4], horizon_s)
            if self.site_windows:
                self.edge_windows, self.edge_censored = _merge_censored(
                    self.edge_windows + self.site_windows,
                    _pad_flags(self.edge_censored, len(self.edge_windows))
                    + site_cens)
                self.upf_windows, self.upf_censored = _merge_censored(
                    self.upf_windows + self.site_windows,
                    _pad_flags(self.upf_censored, len(self.upf_windows))
                    + site_cens)
            # weather front: cell c's blackout rides the front with the
            # per-cell propagation offset (deterministic, no draws)
            cwins: List[Tuple[float, int, float, bool]] = []
            for f0, fdur in corr.weather_front:
                for c in range(n_cells):
                    a = float(f0) + c * corr.front_offset_s
                    if a >= horizon_s:
                        continue
                    cwins.append((a, c, min(a + float(fdur), horizon_s),
                                  a + float(fdur) > horizon_s))
            cwins.sort()
            self.cell_blackout_windows = [(c, a, b) for a, c, b, _x in cwins]
            self.cell_censored = [x for _a, _c, _b, x in cwins]
            # outage-triggered churn surge: flash-crowd re-entry pinned
            # to every recovery instant (deterministic, no draws; the
            # churn stream's draw count is untouched)
            if (corr.surge_boost > 0.0 and corr.surge_duration_s > 0.0
                    and cfg.churn is not None):
                ends = sorted({b for _a, b in
                               self.edge_windows + self.upf_windows})
                self.effective_churn = dataclasses.replace(
                    cfg.churn, flash_crowds=cfg.churn.flash_crowds + tuple(
                        (b, corr.surge_duration_s, corr.surge_boost)
                        for b in ends))
        if self.effective_churn is not None:
            self._churn_iv = self.effective_churn.intervals(
                self._rngs[3], horizon_s, self.n_ues)

        ev: List[Tuple[float, str, Any]] = []
        ues = tuple(range(self.n_ues)) if cfg.blackout_ues is None \
            else tuple(sorted(cfg.blackout_ues))
        for b0, b1 in self.blackout_windows:
            ev.append((b0, "blackout_start", (ues, b1)))
            ev.append((b1, "blackout_end", ues))
        for w, (c, b0, b1) in enumerate(self.cell_blackout_windows):
            ev.append((b0, "cell_blackout_start", (w, c, b1)))
            ev.append((b1, "cell_blackout_end", (w, c)))
        if (cfg.edge_outage is not None or cfg.upf_outage is not None
                or self.edge_windows or self.upf_windows):
            # the detector must keep ticking past the last outage end (+
            # timeout) or recovery would never be *detected*
            last = max([horizon_s]
                       + [w[1] for w in self.edge_windows]
                       + [w[1] for w in self.upf_windows])
            p = cfg.heartbeat_period_s
            n_ticks = int(math.floor(
                (last + cfg.heartbeat_timeout_s) / p)) + 2
            ev.extend((j * p, "heartbeat", None) for j in range(n_ticks))
        ev.sort(key=lambda e: e[0])
        return ev

    # -- ground truth ---------------------------------------------------------
    def edge_down(self, t: float) -> bool:
        return _inside(self.edge_windows, t)

    def upf_down(self, t: float) -> bool:
        return _inside(self.upf_windows, t)

    def active(self, u: int, t: float) -> bool:
        """Is UE ``u`` present (churn) at absolute time ``t``?"""
        if self._churn_iv is None:
            return True
        return any(a <= t < b for a, b in self._churn_iv[u])

    # -- detection / failover state machine ----------------------------------
    def heartbeat(self, t: float) -> List[str]:
        """One detector tick on the absolute clock: every component that
        is actually up beats; ``HeartbeatMonitor`` + ``decide_recovery``
        turn missed beats into transitions.  Returns the signals the
        engine reacts to: ``failover`` / ``failback`` / ``edge_up`` (the
        re-probe triggers) plus ``{edge,upf}_{down,up}`` markers."""
        if not self.edge_down(t):
            self.monitor.beat(EDGE_WORKER, now=t)
        if not self.upf_down(t):
            self.monitor.beat(UPF_WORKER, now=t)
        dec = decide_recovery(self.monitor, self.straggler,
                              devices_per_host=1, model_parallel=1,
                              last_ckpt_step=None, now=t)
        dead = set(self.monitor.dead(now=t))
        out: List[str] = []
        for w, name in ((EDGE_WORKER, "edge"), (UPF_WORKER, "upf")):
            down = w in dead
            if down and not self._down[w]:
                self._down[w] = True
                self.transitions.append({"t": t, "component": name,
                                         "event": "down",
                                         "action": dec.action})
                if w == UPF_WORKER and self.cfg.failover \
                        and dec.action != "halt":
                    self.routed_failover = True
                    out.append("failover")
                out.append(f"{name}_down")
            elif not down and self._down[w]:
                self._down[w] = False
                self.transitions.append({"t": t, "component": name,
                                         "event": "up",
                                         "action": dec.action})
                if w == UPF_WORKER and self.routed_failover:
                    self.routed_failover = False
                    out.append("failback")
                out.append(f"{name}_up")
        return out

    # -- telemetry track ------------------------------------------------------
    def telemetry_events(self) -> List[Tuple[str, float, Dict[str, Any]]]:
        """Chaos track for the telemetry plane (core/telemetry.py):
        ground-truth outage windows as spans (attrs carry ``t1``), the
        heartbeat detector's transition log as detect/recover instants,
        and the failover periods (upf detection -> failback) as spans --
        all derived AFTER the run from state the engine recorded anyway,
        so tracing adds zero work on the hot path."""
        ev: List[Tuple[str, float, Dict[str, Any]]] = []
        for comp, windows in (("edge", self.edge_windows),
                              ("upf", self.upf_windows),
                              ("link", self.blackout_windows)):
            for t0, t1 in windows:
                ev.append((f"outage:{comp}", t0,
                           {"t1": t1, "component": comp}))
        for t0, t1 in self.site_windows:
            ev.append(("outage:site", t0, {"t1": t1, "component": "site"}))
        for c, t0, t1 in self.cell_blackout_windows:
            ev.append(("outage:cell", t0,
                       {"t1": t1, "component": "link", "cell": c}))
        failover_from: Optional[float] = None
        for tr in self.transitions:
            kind = "detect" if tr["event"] == "down" else "recover"
            ev.append((f"{kind}:{tr['component']}", tr["t"],
                       {"component": tr["component"],
                        "action": tr["action"]}))
            if tr["component"] != "upf" or not self.cfg.failover:
                continue
            if tr["event"] == "down" and failover_from is None \
                    and tr["action"] != "halt":
                failover_from = tr["t"]
            elif tr["event"] == "up" and failover_from is not None:
                ev.append(("failover:upf", failover_from,
                           {"t1": tr["t"], "component": "upf"}))
                failover_from = None
        if failover_from is not None:     # run ended still failed over
            t1 = max([failover_from] + [w[1] for w in self.upf_windows])
            ev.append(("failover:upf", failover_from,
                       {"t1": t1, "component": "upf"}))
        ev.sort(key=lambda e: e[1])
        return ev

    # -- recovery metrics -----------------------------------------------------
    def finalize(self, frames: Sequence[Any],
                 skips: Sequence[Tuple[int, int, float]]
                 ) -> List[RecoveryMetrics]:
        """Fold one finished run into per-window recovery metrics.

        ``frames`` are the engine's admitted per-frame records (duck
        typed: ``ue``/``idx``/``capture_s``/``done_s``/``drop_reason``/
        ``option``/``pred``); ``skips`` are the window-dropped captures
        as ``(ue, frame_idx, capture_s)``."""
        reason = {"edge": "edge_outage", "upf": "upf_outage"}
        out: List[RecoveryMetrics] = []
        groups: List[Tuple[str, List[Tuple[float, float]], List[bool],
                           Optional[List[int]]]] = [
            ("edge", self.edge_windows,
             _pad_flags(self.edge_censored, len(self.edge_windows)), None),
            ("upf", self.upf_windows,
             _pad_flags(self.upf_censored, len(self.upf_windows)), None),
            ("link", self.blackout_windows,
             _pad_flags(self.blackout_censored,
                        len(self.blackout_windows)), None),
            ("link", [(a, b) for _c, a, b in self.cell_blackout_windows],
             _pad_flags(self.cell_censored,
                        len(self.cell_blackout_windows)),
             [c for c, _a, _b in self.cell_blackout_windows]),
        ]
        for comp, windows, cens, cells in groups:
            for w, (t0, t1) in enumerate(windows):
                m = RecoveryMetrics(component=comp, start_s=t0, end_s=t1,
                                    censored=cens[w],
                                    cell=None if cells is None
                                    else cells[w])
                slack = (self.cfg.heartbeat_timeout_s
                         + 2.0 * self.cfg.heartbeat_period_s)
                for tr in self.transitions:
                    if tr["component"] != comp:
                        continue
                    if tr["event"] == "down" and math.isnan(m.detect_s) \
                            and t0 <= tr["t"] <= t1 + slack:
                        m.detect_s = tr["t"]
                        m.action = tr["action"]
                    if tr["event"] == "up" and math.isnan(m.clear_s) \
                            and tr["t"] >= t1:
                        m.clear_s = tr["t"]
                # a censored window never recovered inside simulated
                # time: time_to_recover stays NaN instead of faking a
                # recovery off the post-horizon drain
                if not m.censored:
                    done = [fr for fr in frames if not fr.drop_reason]
                    after = [fr.done_s for fr in done if fr.done_s >= t1]
                    if after:
                        m.time_to_recover_s = min(after) - t0
                if comp in reason:
                    m.n_lost = sum(
                        1 for fr in frames
                        if fr.drop_reason == reason[comp]
                        and t0 <= fr.done_s <= t1 + self.cfg.edge_warmup_s)
                m.burst_len = self._burst(frames, skips, t0, t1)
                m.reconverge_frames = self._reconverge(frames, t0, t1)
                out.append(m)
        out.sort(key=lambda m: (m.start_s, m.component,
                                -1 if m.cell is None else m.cell))
        return out

    def _burst(self, frames, skips, t0: float, t1: float) -> int:
        """Longest per-UE run of consecutive frame indices lost or
        skipped to this window.  A backlogged cell loses frames that
        were CAPTURED long before the outage opened, so losses are
        attributed by when they happened (done_s for lost frames), not
        by capture time."""
        hi = t1 + self.cfg.edge_warmup_s
        per: Dict[int, List[Tuple[int, bool]]] = {}
        for fr in frames:
            lost_here = bool(fr.drop_reason) and t0 <= fr.done_s <= hi
            per.setdefault(fr.ue, []).append((fr.idx, not lost_here))
        for u, k, cap in skips:
            if t0 <= cap <= hi:
                per.setdefault(u, []).append((k, False))
        best = 0
        for rows in per.values():
            rows.sort()
            run = 0
            for _k, ok in rows:
                run = 0 if ok else run + 1
                best = max(best, run)
        return best

    def _reconverge(self, frames, t0: float, t1: float
                    ) -> Optional[float]:
        """Mean decided frames after the outage end until the pre-outage
        split option is re-selected (None for fixed-option runs or when
        no UE had a pre-outage decision)."""
        decided = [fr for fr in frames if fr.pred is not None]
        if not decided:
            return None
        per_ue: List[int] = []
        for u in sorted({fr.ue for fr in decided}):
            mine = sorted((fr for fr in decided if fr.ue == u),
                          key=lambda fr: fr.capture_s)
            pre = [fr.option for fr in mine if fr.capture_s < t0]
            if not pre:
                continue
            target, cnt = pre[-1], 0
            for fr in mine:
                if fr.capture_s < t1:
                    continue
                cnt += 1
                if fr.option == target:
                    per_ue.append(cnt)
                    break
        return float(np.mean(per_ue)) if per_ue else None
