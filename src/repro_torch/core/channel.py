"""5G uplink channel + user-plane path models.

A copy of ``repro/core/channel.py`` (numpy only).  Every draw from the
``np.random.Generator`` is made in the same order, so a seed gives the same
KPMs, spectrograms, rates and path latencies as in the JAX package.

The paper measures a physical NR uplink on an Aerial testbed under a
controlled jammer (-40 dB .. -5 dB).  Here the channel is a calibrated
simulator: the per-interference achievable-throughput table is treated as
measured input data (fitted so the simulated Split-1 E2E delay reproduces
paper Fig. 4 exactly), and stochastic fading/jitter reproduce the delay
variance.  Everything downstream (adaptive split selection, energy,
dUPF-vs-cUPF comparisons) consumes only this interface, exactly as the
real system consumes the radio.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

# Interference levels used across the paper's figures (dB)
INTERFERENCE_LEVELS = (-40, -30, -20, -10, -5)


def effective_level(interference_db, narrowband):
    """Realized-throughput interference level.  A narrowband jammer
    concentrates its power on scheduled PRBs (retransmissions + link-
    adaptation thrash), hurting throughput MORE than the same total power
    spread wideband -- while wideband-averaged KPMs register it as LESS.
    This asymmetry is exactly why KPM-only estimation fails (paper §I).

    Accepts scalars or per-UE arrays (``narrowband`` may be a bool array)."""
    if np.ndim(interference_db) == 0 and np.ndim(narrowband) == 0:
        return interference_db + (6.0 if narrowband else 0.0)
    return np.asarray(interference_db, np.float64) + np.where(narrowband, 6.0, 0.0)


@dataclass
class ChannelModel:
    """Uplink throughput vs interference, with log-normal fading.

    ``mean_rate`` / ``sample_rate`` / ``tx_time_s`` are vectorized over a
    UE axis: pass a (n_ues,) array of interference levels and get a rate
    array back.  The scalar path draws from ``rng`` exactly as the seeded
    single-UE pipeline always has (one normal per call), so existing
    paired-trace tests stay aligned; the array path draws one normal per
    UE in index order."""
    # fitted in calibration.py to reproduce paper Fig. 4 (bits/s)
    rate_table: Dict[int, float] = field(default_factory=dict)
    fading_sigma: float = 0.08        # log-normal sigma on the rate
    min_rate: float = 1e6

    def mean_rate(self, interference_db):
        if not self.rate_table:
            raise ValueError(
                "ChannelModel.rate_table is empty: it must map interference "
                "levels (dB) to calibrated uplink rates (bits/s). Build one "
                "with repro_torch.core.calibration.calibrate(), or pass e.g. "
                "ChannelModel(rate_table={-40: 60e6, -5: 11e6}).")
        lv = sorted(self.rate_table)
        if len(lv) == 1:
            # one calibration point: a constant-rate channel (np.interp
            # would silently pin every level to it anyway; be explicit)
            r = float(self.rate_table[lv[0]])
            return r if np.ndim(interference_db) == 0 \
                else np.full(np.shape(interference_db), r)
        log_r = [math.log(self.rate_table[l]) for l in lv]
        # throughput falls roughly geometrically with jamming power:
        # linear interpolation in log-rate, clamped at the table ends
        out = np.exp(np.interp(interference_db, lv, log_r))
        return float(out) if np.ndim(interference_db) == 0 else out

    def db_slope(self) -> float:
        """Fitted geometric attenuation of the rate table: mean decay of
        ``log(rate)`` per dB of interference-equivalent loss.  The
        mobility layer (core/mobility.py) converts excess path loss /
        shadowing into a rate multiplier through this slope, so distance
        degrades throughput exactly as jamming power does.  A one-point
        table has no measurable slope; fall back to a mild default."""
        lv = sorted(self.rate_table)
        if len(lv) < 2:
            return 0.05
        return ((math.log(self.rate_table[lv[0]])
                 - math.log(self.rate_table[lv[-1]]))
                / (lv[-1] - lv[0]))

    def sample_rate(self, interference_db, rng: np.random.Generator,
                    narrowband=False):
        r = self.mean_rate(effective_level(interference_db, narrowband))
        if np.ndim(r) == 0:
            r *= math.exp(rng.normal(0.0, self.fading_sigma))
            return max(r, self.min_rate)
        r = r * np.exp(rng.normal(0.0, self.fading_sigma, size=np.shape(r)))
        return np.maximum(r, self.min_rate)

    def tx_time_s(self, n_bytes, rate_bps):
        return n_bytes * 8.0 / rate_bps


@dataclass
class PathModel:
    """User-plane path latency (one-way, seconds)."""
    name: str
    base_s: float
    jitter_s: float

    def sample_latency(self, rng: np.random.Generator, size=None):
        # base + truncated-normal jitter + occasional queueing tail.
        # (fixed draw count per call so seeded traces stay aligned across
        # path models -- paired comparisons in tests/benches)
        if size is None:
            lat = self.base_s + abs(rng.normal(0.0, self.jitter_s))
            burst = rng.random() < 0.05
            tail = rng.exponential(self.jitter_s * 4)
            return lat + (tail if burst else 0.0)
        lat = self.base_s + np.abs(rng.normal(0.0, self.jitter_s, size=size))
        burst = rng.random(size=size) < 0.05
        tail = rng.exponential(self.jitter_s * 4, size=size)
        return lat + np.where(burst, tail, 0.0)


def sample_path_latencies(paths: "list[PathModel]", rng: np.random.Generator,
                          size: int) -> np.ndarray:
    """Vectorized per-index latency draws when UEs traverse DIFFERENT
    user-plane paths (mobility: the serving cell picks dUPF or cUPF per
    UE, core/mobility.py).  Draws the same three shared-stream blocks as
    ``PathModel.sample_latency(rng, size=...)`` -- one normal, one
    uniform, one exponential per index, in that order -- and composes
    them per path, so a run where every index happens to use the same
    path is BITWISE the single-path call and mixed-path traces stay
    rng-paired with uniform-path ones."""
    base = np.array([p.base_s for p in paths], float)
    jit = np.array([p.jitter_s for p in paths], float)
    lat = base + np.abs(rng.normal(0.0, 1.0, size=size)) * jit
    burst = rng.random(size=size) < 0.05
    tail = rng.standard_exponential(size=size) * (jit * 4)
    return lat + np.where(burst, tail, 0.0)


def dupf_path() -> PathModel:
    """Local breakout at the AI-RAN node (paper §III-B)."""
    return PathModel("dUPF", base_s=0.004, jitter_s=0.002)


def cupf_path() -> PathModel:
    """Central UPF + emulated backhaul: tc adds 100 ms +- 5 ms each way
    (paper §V-A) and the traffic additionally traverses the external
    internet/backbone -- the paper attributes cUPF's larger delay STD to
    this path's unpredictable queueing jitter."""
    return PathModel("cUPF", base_s=0.205, jitter_s=0.035)


@dataclass
class RadioKPM:
    """Numeric radio measurements exposed by the RAN (inputs to the
    throughput estimator).  Synthetic generator mirrors the failure mode
    the paper reports: narrowband interference barely moves wideband KPMs
    while tanking throughput."""
    sinr_db: float
    rsrp_dbm: float
    prb_util: float
    mcs: float
    bler: float
    # grant history + buffer status from the serving cell's MAC
    # (core/ran.py).  Defaults describe an uncontended cell, so the
    # legacy single-link pipeline is unchanged.
    prb_grant_share: float = 1.0   # granted/offered PRBs while backlogged
    buffer_bytes: float = 0.0      # last reported uplink buffer (BSR)


def observe_kpms(interference_db, narrowband, rng: np.random.Generator,
                 grant_share=None, buffer_bytes=None) -> RadioKPM:
    """Scalar inputs give a scalar KPM (byte-identical rng stream to the
    original single-UE path); array inputs give a ``RadioKPM`` whose fields
    are (n_ues,) arrays -- batch sensing for whole-cell analysis.  (The
    adaptive cell decide loop stays per-UE: each UE senses from its own
    seeded rng so traces are reproducible per UE.)

    ``grant_share`` / ``buffer_bytes`` report the serving cell's MAC state
    (grant history and buffer status, core/ran.py); they consume no rng
    draws, so passing them keeps the stream byte-identical."""
    # wideband SINR reacts to total interference power; narrowband jammers
    # hit only a few PRBs, so the wideband average underestimates the damage.
    if np.ndim(interference_db) == 0 and np.ndim(narrowband) == 0:
        eff = interference_db if not narrowband else interference_db - 12.0
        sinr = 22.0 + eff * 0.45 + rng.normal(0, 1.0)
        kpm = RadioKPM(
            sinr_db=sinr,
            rsrp_dbm=-78.0 + rng.normal(0, 2.0),
            prb_util=min(1.0, max(0.0, 0.55 + 0.01 * interference_db + rng.normal(0, 0.05))),
            mcs=max(0.0, min(27.0, 18 + 0.3 * eff + rng.normal(0, 1.0))),
            bler=min(1.0, max(0.0, 0.08 - 0.004 * eff + rng.normal(0, 0.02))),
        )
    else:
        lvl = np.asarray(interference_db, np.float64)
        eff = np.where(narrowband, lvl - 12.0, lvl)
        n = eff.shape
        kpm = RadioKPM(
            sinr_db=22.0 + eff * 0.45 + rng.normal(0, 1.0, n),
            rsrp_dbm=-78.0 + rng.normal(0, 2.0, n),
            prb_util=np.clip(0.55 + 0.01 * lvl + rng.normal(0, 0.05, n), 0.0, 1.0),
            mcs=np.clip(18 + 0.3 * eff + rng.normal(0, 1.0, n), 0.0, 27.0),
            bler=np.clip(0.08 - 0.004 * eff + rng.normal(0, 0.02, n), 0.0, 1.0),
        )
    if grant_share is not None:
        kpm.prb_grant_share = grant_share
    if buffer_bytes is not None:
        kpm.buffer_bytes = buffer_bytes
    return kpm


def iq_spectrogram(interference_db: float, narrowband: bool,
                   rng: np.random.Generator, t: int = 16, f: int = 32) -> np.ndarray:
    """Synthetic IQ-derived spectrogram (T x F energy map, dB).

    A narrowband jammer appears as a bright stripe in a few frequency bins
    -- visible to the spectrogram, invisible to wideband KPMs.  This is the
    paper's (and [1]'s) motivation for IQ-augmented estimation.
    """
    noise_floor = -95.0
    spec = noise_floor + rng.normal(0, 1.5, (t, f))
    signal_bins = slice(4, 28)
    spec[:, signal_bins] += 18.0 + rng.normal(0, 1.0, (t, 24))
    jam_power = 60.0 + interference_db         # dB above floor at -5 dB -> 55
    if narrowband:
        j0 = int(rng.integers(4, 26))
        spec[:, j0:j0 + 3] += jam_power
    else:
        spec[:, :] += jam_power * 0.35
    return spec.astype(np.float32)
