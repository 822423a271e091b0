"""A copy of ``repro/core/mobility.py`` (numpy only), on the port's
``core/channel.py``; the same seed gives the same trajectories, shadowing
and handover events.

UE mobility: trajectories, time-varying channels, multi-cell handover.

Every engine before this module drew each UE's uplink from a stationary
fading distribution inside one eternal cell, so "adaptive" split
selection was only ever exercised against i.i.d. noise.  This module
makes the radio *non-stationary* the way the paper's dynamic-5G claims
require (cf. arXiv:2509.01906's throughput drift under mobility):

  * **Trajectories** drive per-UE positions on an absolute clock:
    ``StaticTrajectory`` (the legacy degenerate case),
    ``WaypointTrajectory`` (scripted piecewise-linear paths at constant
    speed, optionally looping), and ``RandomWaypointTrajectory`` (the
    classic RWP model: pick a uniform waypoint, travel at a uniform
    speed, pause, repeat -- deterministic given its seed).

  * **A time-varying channel layered on the calibrated rate table.**
    The paper's ``ChannelModel.rate_table`` maps interference dB to
    throughput at the testbed's (fixed, close-range) geometry.  Mobility
    adds an interference-*equivalent* excess loss in dB --

        extra_db = max(0, pathloss(d) - pathloss(d_ref)
                          - shadow_db - doppler_db)

    with distance-dependent path loss (``10 * alpha * log10(d/d_ref)``),
    lognormal shadowing spatially correlated over the distance traveled
    (Gudmundson: AR(1) with coefficient ``exp(-delta_d / decorr_m)``),
    and a Doppler-correlated fast-fading residual (AR(1) over time whose
    coefficient is the small-lag Gaussian approximation of the Jakes
    autocorrelation ``J0(2*pi*f_D*dt)``; ``f_D = v * fc / c``).  The
    excess is converted to a rate multiplier through the table's own
    fitted log-rate slope (``ChannelModel.db_slope``), so the channel
    degrades geometrically with distance exactly as it does with jamming
    power.  At the reference geometry (static UE at ``ref_dist_m``,
    zero-sigma stochastic layers) ``extra_db == 0`` and the sampled rate
    is BITWISE the legacy draw -- the Fig. 4 fit is intact and the
    lone-static-UE case reproduces ``ChannelModel.mean_rate``.

  * **A3-style handover** between 2-3 cell sites: a neighbor whose RSRP
    proxy exceeds the serving cell's by ``a3_hysteresis_db`` continuously
    for ``a3_ttt_s`` (time-to-trigger) takes over.  The serving cell
    selects the user-plane ``PathModel`` (dUPF local breakout at the
    AI-RAN site vs cUPF + backhaul elsewhere), so the paper's
    dUPF-reduces-jitter claim becomes a *scenario* instead of a
    constant.  The event engine (core/timeline.py) reacts to the
    returned ``HandoverEvent``: the UE's byte queue migrates to the
    target cell's MAC, in-flight HARQ transport blocks are flushed as
    losses, the uplink stalls for ``relocation_gap_s`` (path
    relocation), and the UE's controller resets its granted-rate
    estimate (``AdaptiveController.notify_handover``).

Rng discipline: the model draws from ONE dedicated generator (a
SeedSequence child the simulator reserves, core/cell.py), with a FIXED
draw count per observation -- ``n_sites`` shadowing normals plus one
Doppler normal per UE per capture, consumed even when the sigmas are
zero -- so enabling or re-parameterizing mobility never moves the shared
fading/path streams and mobility-vs-baseline comparisons stay rng-paired.
"""
from __future__ import annotations

import math
from bisect import bisect_right
from dataclasses import dataclass, field
from functools import cached_property
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.channel import (ChannelModel, PathModel, cupf_path,
                                      dupf_path)

C_LIGHT = 299_792_458.0


# ---------------------------------------------------------------------------
# trajectories
# ---------------------------------------------------------------------------

class Trajectory:
    """Position of one UE on the absolute clock (meters)."""

    def position(self, t: float) -> Tuple[float, float]:
        raise NotImplementedError


@dataclass(frozen=True)
class StaticTrajectory(Trajectory):
    """The legacy degenerate case: the UE never moves."""
    x: float = 0.0
    y: float = 0.0

    def position(self, t: float) -> Tuple[float, float]:
        return (self.x, self.y)


@dataclass(frozen=True)
class WaypointTrajectory(Trajectory):
    """Scripted piecewise-linear path through ``points`` at constant
    ``speed_mps``.  ``loop=True`` ping-pongs back through the reversed
    path forever (a commuter shuttling between cells); ``loop=False``
    parks at the last waypoint."""
    points: Tuple[Tuple[float, float], ...]
    speed_mps: float
    loop: bool = False

    def __post_init__(self):
        if len(self.points) < 1:
            raise ValueError("WaypointTrajectory needs at least one point")
        if self.speed_mps < 0:
            raise ValueError("speed_mps must be non-negative")

    @cached_property
    def _legs(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(points, per-leg lengths, cumulative arc length) -- computed
        once (cached_property works on a frozen dataclass: it writes the
        instance __dict__ directly); position() is called per capture
        per UE, so rebuilding these arrays there would dominate."""
        pts = np.asarray(self.points, float)
        if self.loop and len(pts) > 1:
            pts = np.concatenate([pts, pts[-2::-1]])
        seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
        return pts, seg, np.concatenate([[0.0], np.cumsum(seg)])

    def position(self, t: float) -> Tuple[float, float]:
        pts, seg, cum = self._legs
        total = float(cum[-1])
        if total == 0.0 or self.speed_mps == 0.0:
            return (float(pts[0, 0]), float(pts[0, 1]))
        s = self.speed_mps * max(t, 0.0)
        if self.loop:
            s = s % total
        else:
            s = min(s, total)
        i = int(np.searchsorted(cum, s, side="right") - 1)
        i = min(i, len(seg) - 1)
        frac = (s - cum[i]) / seg[i] if seg[i] > 0 else 0.0
        p = pts[i] + frac * (pts[i + 1] - pts[i])
        return (float(p[0]), float(p[1]))


class RandomWaypointTrajectory(Trajectory):
    """Classic random-waypoint mobility: pick a uniform waypoint inside
    ``area`` = (x0, y0, x1, y1), travel there at a uniform speed in
    ``speed_mps`` = (v_min, v_max), pause ``pause_s``, repeat.  The leg
    sequence comes from a dedicated ``default_rng(seed)`` extended
    lazily, so positions are deterministic given the seed regardless of
    the query pattern."""

    def __init__(self, area: Tuple[float, float, float, float],
                 speed_mps: Tuple[float, float], pause_s: float = 0.0,
                 seed: int = 0, start: Optional[Tuple[float, float]] = None):
        lo, hi = float(speed_mps[0]), float(speed_mps[1])
        if lo < 0 or hi < lo:
            raise ValueError("speed_mps must be 0 <= v_min <= v_max")
        if hi == 0.0:
            raise ValueError("RandomWaypointTrajectory needs v_max > 0 "
                             "(use StaticTrajectory for a parked UE)")
        self.area = tuple(float(v) for v in area)
        self.speed_mps = (lo, hi)
        self.pause_s = float(pause_s)
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        x0, y0, x1, y1 = self.area
        if start is None:
            start = (float(self._rng.uniform(x0, x1)),
                     float(self._rng.uniform(y0, y1)))
        # legs: (t_start, t_end, p_start, p_end); pauses are zero-motion
        # legs.  ``_ends`` mirrors the leg end times so position() can
        # bisect instead of scanning the ever-growing history (a long
        # streaming run would otherwise go quadratic in elapsed legs --
        # the failure class RanStream._retire exists for).
        self._legs: List[Tuple[float, float, np.ndarray, np.ndarray]] = []
        self._ends: List[float] = []
        self._cursor = (0.0, np.asarray(start, float))

    def _push(self, leg):
        self._legs.append(leg)
        self._ends.append(leg[1])

    def _extend(self, t: float):
        x0, y0, x1, y1 = self.area
        lo, hi = self.speed_mps
        while not self._legs or self._legs[-1][1] <= t:
            t0, p0 = self._cursor
            target = np.array([self._rng.uniform(x0, x1),
                               self._rng.uniform(y0, y1)])
            v = self._rng.uniform(lo, hi) if hi > lo else hi
            travel = float(np.linalg.norm(target - p0)) / v if v > 0 \
                else 0.0
            self._push((t0, t0 + travel, p0, target))
            t1 = t0 + travel
            if self.pause_s > 0:
                self._push((t1, t1 + self.pause_s, target, target))
                t1 += self.pause_s
            self._cursor = (t1, target)

    def position(self, t: float) -> Tuple[float, float]:
        t = max(t, 0.0)
        self._extend(t)
        # first leg whose end lies past t; its start is <= t because legs
        # tile the time axis contiguously from zero
        t0, t1, p0, p1 = self._legs[bisect_right(self._ends, t)]
        frac = (t - t0) / (t1 - t0) if t1 > t0 else 1.0
        frac = min(max(frac, 0.0), 1.0)
        p = p0 + frac * (p1 - p0)
        return (float(p[0]), float(p[1]))


# ---------------------------------------------------------------------------
# cell geometry + config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CellSite:
    """One NR site: position plus the user-plane path its traffic takes.
    The AI-RAN site breaks out locally (dUPF); a conventional site hauls
    to the central UPF."""
    x: float
    y: float
    path: PathModel = field(default_factory=dupf_path)
    name: str = ""

    def distance(self, x: float, y: float) -> float:
        return math.hypot(self.x - x, self.y - y)


def two_cell_sites(spacing_m: float = 400.0) -> List[CellSite]:
    """The canonical mobility scenario: an AI-RAN site with local dUPF
    breakout and a conventional site anchored at the central UPF."""
    return [CellSite(0.0, 0.0, dupf_path(), name="airan-dupf"),
            CellSite(spacing_m, 0.0, cupf_path(), name="macro-cupf")]


@dataclass(frozen=True)
class MobilityConfig:
    pathloss_exp: float = 3.0       # urban-ish path-loss exponent
    ref_dist_m: float = 30.0        # geometry the rate_table was fitted at
    min_dist_m: float = 1.0         # clamp (log-distance blows up at 0)
    # stochastic layers (opt-in; zero keeps the channel pure-geometry and
    # the static-at-reference case bitwise legacy)
    shadow_sigma_db: float = 0.0    # lognormal shadowing std
    shadow_decorr_m: float = 50.0   # Gudmundson decorrelation distance
    doppler_sigma_db: float = 0.0   # Doppler-correlated fast-fading residual
    carrier_hz: float = 3.5e9       # f_D = v * carrier / c
    # A3 handover trigger + user-plane relocation
    a3_hysteresis_db: float = 3.0
    a3_ttt_s: float = 0.5           # time-to-trigger
    relocation_gap_s: float = 0.05  # uplink stall while the path relocates
    # optional override of the rate_table's fitted log-rate slope per dB
    db_slope: Optional[float] = None


@dataclass(frozen=True)
class HandoverEvent:
    ue_id: int
    t_s: float
    from_cell: int
    to_cell: int
    gap_s: float


@dataclass
class MobilityObs:
    """What one capture-instant observation of one UE yields."""
    serving: int
    extra_db: float           # interference-equivalent excess loss (>= 0)
    rate_scale: float         # multiplier on the sampled link rate
    speed_mps: float
    pos: Tuple[float, float]
    handover: Optional[HandoverEvent] = None


# ---------------------------------------------------------------------------
# the mobility model
# ---------------------------------------------------------------------------

class MobilityModel:
    """Trajectory-driven time-varying channel + A3 handover state.

    ``reset(n_ues, rng, channel)`` (re)builds per-UE state; ``observe(u,
    t)`` advances UE ``u`` to absolute time ``t`` and returns the serving
    cell, the rate multiplier and (possibly) a ``HandoverEvent``.  The
    caller observes every capture event exactly once per UE in event
    order, so the dedicated rng stream is reproducible."""

    def __init__(self, sites: Sequence[CellSite],
                 trajectories: Sequence[Trajectory],
                 cfg: MobilityConfig = MobilityConfig()):
        if not sites:
            raise ValueError("MobilityModel needs at least one CellSite")
        if not trajectories:
            raise ValueError("MobilityModel needs one Trajectory per UE")
        self.sites = list(sites)
        self.trajectories = list(trajectories)
        self.cfg = cfg
        self._rng: Optional[np.random.Generator] = None

    @property
    def n_sites(self) -> int:
        return len(self.sites)

    def trajectory(self, u: int) -> Trajectory:
        """Per-UE trajectory (a short list broadcasts round-robin, so a
        single shared trajectory spec can cover a whole cell)."""
        return self.trajectories[u % len(self.trajectories)]

    # -- lifecycle ------------------------------------------------------------
    def reset(self, n_ues: int, rng: np.random.Generator,
              channel: ChannelModel):
        cfg = self.cfg
        self._rng = rng
        self._slope = cfg.db_slope if cfg.db_slope is not None \
            else channel.db_slope()
        self._time = np.full(n_ues, math.nan)
        self._fault_db = np.zeros(self.n_sites)
        self._pos = np.array([self.trajectory(u).position(0.0)
                              for u in range(n_ues)], float)
        # initial shadowing field: one correlated value per (UE, site)
        self._shadow = cfg.shadow_sigma_db * rng.normal(
            0.0, 1.0, (n_ues, self.n_sites))
        self._doppler = np.zeros(n_ues)
        self._a3_since = np.full(n_ues, math.nan)
        self.serving = np.array([int(np.argmax(self._rsrp(u)))
                                 for u in range(n_ues)])
        self.handover_count = np.zeros(n_ues, int)

    # -- channel pieces -------------------------------------------------------
    def _pathloss_db(self, d: float) -> float:
        cfg = self.cfg
        d = max(d, cfg.min_dist_m)
        return 10.0 * cfg.pathloss_exp * math.log10(d / cfg.ref_dist_m)

    def _rsrp(self, u: int) -> np.ndarray:
        """Relative RSRP proxy per site: -pathloss + shadowing (dB),
        minus any chaos-plane fault penalty pinned on the site."""
        x, y = self._pos[u]
        return np.array([-self._pathloss_db(s.distance(x, y))
                         for s in self.sites]) + self._shadow[u] \
            - self._fault_db

    # -- chaos-plane site faults ---------------------------------------------
    def set_site_fault(self, cell: int, penalty_db: float):
        """Pin an RSRP penalty on a site (a dying cell).  A3 sees the
        faulted site collapse relative to its neighbors, so served UEs
        evacuate through the ordinary handover machinery; UEs with no
        better neighbor stay and eat the penalty as excess loss."""
        self._fault_db[cell] = float(penalty_db)

    def clear_site_fault(self, cell: int):
        self._fault_db[cell] = 0.0

    def rate_scale(self, extra_db) -> float:
        """Rate multiplier for an interference-equivalent excess loss,
        through the rate table's fitted geometric slope."""
        return math.exp(-self._slope * float(extra_db))

    def serving_path(self, u: int) -> PathModel:
        return self.sites[int(self.serving[u])].path

    def telemetry_sample(self) -> dict:
        """Cell-assignment observation for the telemetry plane
        (core/telemetry.py counter tracks): cumulative handovers plus
        the per-site UE census.  Pure read -- the dedicated mobility rng
        never moves."""
        counts = np.bincount(self.serving, minlength=self.n_sites)
        out = {"handovers_total": float(self.handover_count.sum())}
        for c in range(self.n_sites):
            out[f"ues_at_site{c}"] = float(counts[c])
        return out

    # -- one observation ------------------------------------------------------
    def observe(self, u: int, t: float) -> MobilityObs:
        assert self._rng is not None, "MobilityModel.reset was not called"
        cfg = self.cfg
        prev_t = self._time[u]
        prev_pos = self._pos[u].copy()
        pos = np.asarray(self.trajectory(u).position(t), float)
        dt = 0.0 if math.isnan(prev_t) else max(t - prev_t, 0.0)
        dd = float(np.linalg.norm(pos - prev_pos))
        speed = dd / dt if dt > 0 else 0.0
        self._time[u], self._pos[u] = t, pos

        # fixed draw count per observation: n_sites shadowing normals +
        # one Doppler normal, consumed even at zero sigma / zero motion,
        # so every mobility configuration pairs draw-for-draw
        z_sh = self._rng.normal(0.0, 1.0, self.n_sites)
        z_do = self._rng.normal(0.0, 1.0)
        a = math.exp(-dd / cfg.shadow_decorr_m)
        self._shadow[u] = (a * self._shadow[u]
                           + math.sqrt(1.0 - a * a)
                           * cfg.shadow_sigma_db * z_sh)
        # Jakes small-lag Gaussian approximation of J0(2*pi*f_D*dt): a
        # static UE (f_D = 0) keeps rho = 1 and its residual frozen at the
        # zero it was initialized with -- the calibrated fading_sigma
        # already covers the stationary testbed's fast fading
        f_d = speed * cfg.carrier_hz / C_LIGHT
        x = math.pi * f_d * dt
        rho = math.exp(-0.25 * x * x)
        self._doppler[u] = (rho * self._doppler[u]
                            + math.sqrt(max(1.0 - rho * rho, 0.0))
                            * cfg.doppler_sigma_db * z_do)

        # A3: best neighbor beats serving by hysteresis for ttt seconds
        handover = None
        rsrp = self._rsrp(u)
        serv = int(self.serving[u])
        if self.n_sites > 1:
            nb = int(np.argmax(np.where(np.arange(self.n_sites) == serv,
                                        -np.inf, rsrp)))
            if rsrp[nb] > rsrp[serv] + cfg.a3_hysteresis_db:
                if math.isnan(self._a3_since[u]):
                    self._a3_since[u] = t
                if t - self._a3_since[u] >= cfg.a3_ttt_s:
                    handover = HandoverEvent(
                        ue_id=u, t_s=t, from_cell=serv, to_cell=nb,
                        gap_s=cfg.relocation_gap_s)
                    self.serving[u] = serv = nb
                    self.handover_count[u] += 1
                    self._a3_since[u] = math.nan
            else:
                self._a3_since[u] = math.nan

        extra = (self._pathloss_db(self.sites[serv].distance(*pos))
                 - float(self._shadow[u, serv]) - float(self._doppler[u]))
        extra = max(extra, 0.0) + float(self._fault_db[serv])
        return MobilityObs(serving=serv, extra_db=extra,
                           rate_scale=self.rate_scale(extra),
                           speed_mps=speed,
                           pos=(float(pos[0]), float(pos[1])),
                           handover=handover)


def static_mobility(n_ues: int, site: Optional[CellSite] = None,
                    cfg: Optional[MobilityConfig] = None) -> MobilityModel:
    """The degenerate configuration the equivalence tests anchor on: one
    cell, every UE parked at the reference distance, zero-sigma
    stochastic layers -- ``extra_db == 0`` every frame, so the engine
    must reproduce the mobility-free run bitwise (rng-paired)."""
    cfg = cfg or MobilityConfig()
    site = site or CellSite(0.0, 0.0, dupf_path(), name="airan-dupf")
    traj = [StaticTrajectory(site.x + cfg.ref_dist_m, site.y)
            for _ in range(n_ues)]
    return MobilityModel([site], traj, cfg)
