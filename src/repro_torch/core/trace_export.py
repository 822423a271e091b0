"""A copy of ``repro/core/trace_export.py``, on the port's
``core/telemetry.py``.

Exporters for the telemetry plane (core/telemetry.py).

Two formats:

  * **Chrome-trace / Perfetto JSON** (``chrome_trace`` /
    ``write_chrome_trace``): load the file at https://ui.perfetto.dev or
    chrome://tracing.  Layout: one process per cell, one thread per UE
    (stage + cause spans), plus per-cell resource threads (MAC cohort
    grants, edge busy) and counter tracks (PRB backlog, live flows); a
    dedicated control process carries the chaos track (outage windows
    with detect/failover/recover instants).
  * **flat JSONL** (``write_jsonl``): one self-describing record per
    line (spans, instants, counter samples, then one final registry
    snapshot) for bench post-processing without a trace viewer.

Timestamps enter in sim seconds and leave in microseconds (the trace
format's unit).  Runs recorded on the lock-step engines carry
slot-relative times (``clock == "slot"``); the exporter lays their
frames out at a fixed pitch -- the longest slot -- so the per-frame
structure stays readable on one timeline.  Everything here is a pure
function of the recorded run: exporting draws no rng and mutates no
simulator state.
"""
from __future__ import annotations

import json
import math
from typing import Any, Dict, Iterator, List, Optional

from repro_torch.core.telemetry import Span, Telemetry

# thread ids for per-cell resource tracks (UE ids live well below this)
_TID_MAC = 100000
_TID_EDGE = 100001
_PID_CONTROL = 1000000      # the chaos/control process


def _pitch_s(tele: Telemetry) -> float:
    """Frame pitch for slot-relative runs: the longest slot, padded."""
    t1 = max((s.t1 for s in tele.spans), default=0.0)
    t1 = max(t1, max((e["t"] for e in tele.instants), default=0.0))
    return (t1 or 1.0) * 1.05


def chrome_trace(tele: Telemetry) -> Dict[str, Any]:
    """Render a recorded run as a Chrome-trace / Perfetto JSON object."""
    slot_clock = tele.meta.get("clock") == "slot"
    pitch = _pitch_s(tele) if slot_clock else 0.0

    def us(t: float, frame_idx: int = -1) -> float:
        if slot_clock and frame_idx >= 0:
            t += frame_idx * pitch
        return round(t * 1e6, 3)

    events: List[Dict[str, Any]] = []
    pids: Dict[int, str] = {}
    tids: Dict[tuple, str] = {}

    def pid_of(cell: int) -> int:
        p = cell + 1
        pids.setdefault(p, f"cell {cell}")
        return p

    def tid_of(cell: int, tid: int, name: str) -> int:
        tids.setdefault((pid_of(cell), tid), name)
        return tid

    for s in tele.spans:
        if s.cat in ("frame", "cause"):
            pid = pid_of(s.cell)
            tid = tid_of(s.cell, s.ue, f"ue {s.ue}")
        elif s.cat == "mac":
            pid = pid_of(s.cell)
            tid = tid_of(s.cell, _TID_MAC, "MAC grants")
        elif s.cat == "edge":
            pid = pid_of(s.cell)
            tid = tid_of(s.cell, _TID_EDGE, "edge batches")
        else:                                    # chaos
            pid, tid = _PID_CONTROL, 0
            pids.setdefault(pid, "chaos/control")
            tids.setdefault((pid, 0), "faults")
        args: Dict[str, Any] = {}
        if s.frame_idx >= 0:
            args["frame_idx"] = s.frame_idx
        if s.attrs:
            args.update(s.attrs)
        events.append({
            "ph": "X", "name": s.name, "cat": s.cat, "pid": pid,
            "tid": tid, "ts": us(s.t0, s.frame_idx),
            "dur": max(round((s.t1 - s.t0) * 1e6, 3), 0.0),
            "args": args})

    for ev in tele.instants:
        ue, cell = ev.get("ue", -1), ev.get("cell", 0)
        chaos_ev = ev["name"].split(":")[0] in (
            "detect", "failover", "failback", "recover", "outage")
        if chaos_ev:
            pid, tid, scope = _PID_CONTROL, 0, "p"
            pids.setdefault(pid, "chaos/control")
            tids.setdefault((pid, 0), "faults")
        elif ue >= 0:
            pid = pid_of(cell)
            tid, scope = tid_of(cell, ue, f"ue {ue}"), "t"
        else:
            pid, tid, scope = pid_of(cell), 0, "p"
        args = {k: v for k, v in ev.items()
                if k not in ("name", "t", "ue", "cell")}
        events.append({
            "ph": "i", "name": ev["name"], "cat": "instant", "pid": pid,
            "tid": tid, "ts": us(ev["t"], ev.get("frame_idx", -1)
                                 if slot_clock else -1),
            "s": scope, "args": args})

    for t, name, cell, value in tele.samples:
        events.append({
            "ph": "C", "name": name, "pid": pid_of(cell), "tid": 0,
            "ts": us(t), "args": {name: value}})

    meta_events: List[Dict[str, Any]] = []
    for p, name in sorted(pids.items()):
        meta_events.append({"ph": "M", "name": "process_name", "pid": p,
                            "tid": 0, "args": {"name": name}})
    for (p, tid), name in sorted(tids.items()):
        meta_events.append({"ph": "M", "name": "thread_name", "pid": p,
                            "tid": tid, "args": {"name": name}})

    return {
        "traceEvents": meta_events + events,
        "displayTimeUnit": "ms",
        "otherData": dict(tele.meta, format="chrome-trace",
                          slot_pitch_us=round(pitch * 1e6, 3)),
    }


def write_chrome_trace(tele: Telemetry, path: str) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(tele), f, indent=1)
        f.write("\n")
    return path


# ---------------------------------------------------------------------------
# flat JSONL
# ---------------------------------------------------------------------------

def jsonl_records(tele: Telemetry) -> Iterator[Dict[str, Any]]:
    yield {"kind": "meta", **tele.meta}
    for s in tele.spans:
        yield {"kind": "span", "name": s.name, "cat": s.cat, "t0": s.t0,
               "t1": s.t1, "ue": s.ue, "cell": s.cell,
               "frame_idx": s.frame_idx, "attrs": s.attrs}
    for ev in tele.instants:
        yield {"kind": "instant", **ev}
    for t, name, cell, value in tele.samples:
        yield {"kind": "sample", "t": t, "name": name, "cell": cell,
               "value": value}
    yield {"kind": "snapshot", **tele.registry.snapshot()}


def write_jsonl(tele: Telemetry, path: str) -> str:
    with open(path, "w") as f:
        for rec in jsonl_records(tele):
            f.write(json.dumps(rec) + "\n")
    return path


# ---------------------------------------------------------------------------
# validation (used by tests and the CI schema check)
# ---------------------------------------------------------------------------

_VALID_PH = {"X", "i", "C", "M", "B", "E"}


def validate_chrome_trace(trace: Any) -> List[str]:
    """Structural validation of a Chrome-trace object (or a path to
    one).  Returns a list of problems; empty means the trace parses and
    every event is well-formed (Perfetto would accept it)."""
    if isinstance(trace, str):
        try:
            with open(trace) as f:
                trace = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            return [f"unreadable trace: {e}"]
    errors: List[str] = []
    if not isinstance(trace, dict):
        return ["top level must be an object"]
    evs = trace.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        return ["traceEvents must be a non-empty list"]
    for i, ev in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _VALID_PH:
            errors.append(f"{where}: bad ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            errors.append(f"{where}: missing name")
        if not isinstance(ev.get("pid"), int) \
                or not isinstance(ev.get("tid"), int):
            errors.append(f"{where}: pid/tid must be ints")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or not math.isfinite(ts) \
                or ts < 0:
            errors.append(f"{where}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) \
                    or not math.isfinite(dur) or dur < 0:
                errors.append(f"{where}: bad dur {dur!r}")
        if ph == "C" and not isinstance(ev.get("args"), dict):
            errors.append(f"{where}: counter event needs args")
    if len(errors) > 20:
        errors = errors[:20] + [f"... {len(errors) - 20} more"]
    return errors
