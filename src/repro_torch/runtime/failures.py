"""A copy of ``repro/runtime/failures.py`` (no JAX, no numpy).

Fault tolerance primitives: failure detection, straggler mitigation,
elastic re-meshing.

At 1000+ nodes the control plane must (a) notice dead hosts fast,
(b) keep one slow host from stalling every step, and (c) produce a new
device layout + restore plan without human intervention.  These classes
are the pure-logic core of that loop (transport is heartbeats over the
job's RPC bus; simulated in tests by advancing a fake clock).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class HeartbeatMonitor:
    """Declares a worker dead after ``timeout_s`` without a heartbeat.

    Clock discipline: ``now`` defaults to wall-clock ``time.monotonic()``
    for the live control plane, which is NONDETERMINISTIC inside a
    simulation -- two replays of the same seeded trace would disagree on
    detection instants.  Simulated users (core/chaos.py) construct the
    monitor with ``strict_clock=True``, which refuses any call that does
    not thread an explicit ``now`` on the simulation's absolute clock."""
    n_workers: int
    timeout_s: float = 10.0
    strict_clock: bool = False
    _last: Dict[int, float] = field(default_factory=dict)

    def _now(self, now: Optional[float]) -> float:
        if now is not None:
            return now
        if self.strict_clock:
            raise ValueError(
                "HeartbeatMonitor(strict_clock=True) requires an explicit "
                "`now`: wall-clock time.monotonic() is nondeterministic "
                "on the simulated path")
        return time.monotonic()

    def beat(self, worker: int, now: Optional[float] = None):
        self._last[worker] = self._now(now)

    def dead(self, now: Optional[float] = None) -> List[int]:
        now = self._now(now)
        out = []
        for w in range(self.n_workers):
            t = self._last.get(w)
            if t is None or now - t > self.timeout_s:
                out.append(w)
        return out

    def alive(self, now: Optional[float] = None) -> List[int]:
        d = set(self.dead(self._now(now)))
        return [w for w in range(self.n_workers) if w not in d]


def _median(xs: Sequence[float]) -> float:
    """Proper median: mean of the two middles for even-length samples.
    (The old ``sorted(xs)[len(xs) // 2]`` took the UPPER middle, biasing
    the rolling median high on even windows -- a straggler threshold off
    an inflated median under-flags slow hosts.)"""
    s = sorted(xs)
    m = len(s) // 2
    return float(s[m]) if len(s) % 2 else 0.5 * (s[m - 1] + s[m])


@dataclass
class StragglerMonitor:
    """Flags workers whose step time exceeds ``factor`` x the rolling
    median.  Mitigation at the framework level: the launcher excludes
    flagged hosts at the next elastic re-mesh, and the data pipeline
    re-balances shards away from them immediately."""
    n_workers: int
    window: int = 32
    factor: float = 2.0
    _hist: Dict[int, List[float]] = field(default_factory=dict)

    def record(self, worker: int, step_time_s: float):
        h = self._hist.setdefault(worker, [])
        h.append(step_time_s)
        if len(h) > self.window:
            h.pop(0)

    def medians(self) -> Dict[int, float]:
        return {w: _median(h) for w, h in self._hist.items()}

    def stragglers(self) -> List[int]:
        med = self.medians()
        if len(med) < 2:
            return []
        global_med = _median(list(med.values()))
        return [w for w, m in med.items() if m > self.factor * global_med]


@dataclass(frozen=True)
class MeshPlan:
    """A concrete device layout the launcher can build."""
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    n_devices: int

    @property
    def data_parallel(self) -> int:
        out = 1
        for s, a in zip(self.shape, self.axes):
            if a in ("data", "pod"):
                out *= s
        return out


def elastic_plan(n_healthy_hosts: int, devices_per_host: int,
                 model_parallel: int, *, pods: int = 1) -> Optional[MeshPlan]:
    """Largest power-of-two data axis that fits the healthy fleet, keeping
    the model axis intact (TP must not shrink: weights are sharded over it).

    Returns None when fewer devices remain than one model replica needs.
    """
    total = n_healthy_hosts * devices_per_host
    if total < model_parallel:
        return None
    dp = total // model_parallel
    dp = 2 ** int(math.floor(math.log2(dp)))
    if pods > 1 and dp % pods == 0:
        return MeshPlan(shape=(pods, dp // pods, model_parallel),
                        axes=("pod", "data", "model"),
                        n_devices=pods * (dp // pods) * model_parallel)
    return MeshPlan(shape=(dp, model_parallel), axes=("data", "model"),
                    n_devices=dp * model_parallel)


@dataclass
class RecoveryDecision:
    action: str                  # 'continue' | 'remesh' | 'halt'
    plan: Optional[MeshPlan]
    restore_step: Optional[int]
    excluded_workers: Tuple[int, ...] = ()


def decide_recovery(monitor: HeartbeatMonitor, straggler: StragglerMonitor,
                    devices_per_host: int, model_parallel: int,
                    last_ckpt_step: Optional[int], *, pods: int = 1,
                    now: Optional[float] = None) -> RecoveryDecision:
    """The control loop's single decision point, run between steps."""
    dead = monitor.dead(now)
    slow = straggler.stragglers()
    if not dead and not slow:
        return RecoveryDecision("continue", None, None)
    excluded = tuple(sorted(set(dead) | set(slow)))
    healthy = monitor.n_workers - len(excluded)
    plan = elastic_plan(healthy, devices_per_host, model_parallel, pods=pods)
    if plan is None:
        return RecoveryDecision("halt", None, last_ckpt_step, excluded)
    # dead hosts lose state -> restore; pure stragglers keep params in HBM
    restore = last_ckpt_step if dead else None
    return RecoveryDecision("remesh", plan, restore, excluded)
