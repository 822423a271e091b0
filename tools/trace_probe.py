#!/usr/bin/env python3
"""Count the device events a torch.profiler session loses, opened bare and
opened as ``chip_smoke.py`` opens its sessions (``padded_profile``).

    python3 tools/trace_probe.py [--rounds 250] [--load] [--log PATH]

The profiler (Kineto over CUPTI) keeps a device event only if its time
stamp, on the card's clock, falls inside the session's window on the host's
clock, and counts the others as "Out-of-range" in its own log.  This script
runs, in a child process with ``KINETO_LOG_LEVEL=0`` (so that Kineto logs
each session's record counts into PATH), ``--rounds`` rounds of six
sessions: a burst of twelve 1024 x 1024 f32 matmuls ending in a read to
the host, and B2's encode of a split-1-sized f32 stream (3,923,968
elements, block 8192) with one copy to the host, as phase 16 traces it;
each opened bare (a synchronize at its end, as the script opened them
before), after a synchronize, through ``chip_smoke.padded_profile``, and
through it after an empty session of its own ("drained").  With
``--load``, one bare session first traces a queue the card lags far behind,
as a full-width train step is (3,000 f32 2048 x 2048 matmuls, each with a
tanh, launched at once).  Per kind of session it prints the sessions, those
with no device event, those in which Kineto counted out-of-range records
(and the most in one), the device events a session kept (min, median,
max), and the first device event's start less the first launch call's, in
us, on the profiler's time line; then the card's name and power limit.
Needs an NVIDIA card.
"""
from __future__ import annotations

import argparse
import collections
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402  (its helpers; it imports no package)

OPENINGS = ("bare", "synced", "padded", "drained")
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaMemcpy", "cuLaunchKernel")


def child(rounds: int, load: bool) -> None:
    """Run the sessions, printing a marker before each and its result
    after it, so that the parent can pair Kineto's lines with them."""
    import contextlib

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(CS.SEED)
    flat = torch.randn(3_923_968, generator=g, device=dev)
    a = torch.randn(1024, 1024, generator=g, device=dev)

    def encode():
        stream, scales = ops.codec_encode(flat, 8192, False)
        torch.cat([stream.view(torch.uint8), scales.view(torch.uint8)]).cpu()

    def matmuls():
        x = a
        for _ in range(12):
            x = torch.tanh(x @ a) * 0.5
        x.sum().item()

    @contextlib.contextmanager
    def bare(synced):
        if synced:
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            yield prof
            torch.cuda.synchronize()

    def queue():
        w = torch.randn(2048, 2048, generator=g, device=dev) / 2048 ** 0.5
        x = w
        for _ in range(3000):
            x = torch.tanh(x @ w)

    openings = {"bare": lambda: bare(False), "synced": lambda: bare(True),
                "padded": CS.padded_profile, "drained": CS.padded_profile}
    for _ in range(3):
        encode()
        matmuls()
    sessions = [(opening, fn) for _ in range(rounds) for opening in OPENINGS
                for fn in (matmuls, encode)]
    if load:
        sessions.insert(0, ("bare", queue))
    for opening, fn in sessions:
        if opening == "drained":            # an empty session just before
            print("SESSION drain nothing", flush=True)
            with CS.padded_profile():
                pass
            print("RESULT 0 none", flush=True)
        print(f"SESSION {opening} {fn.__name__}", flush=True)
        with openings[opening]() as prof:
            fn()
        events = prof.events()
        dev_ev = [e for e in events if e.device_type == DeviceType.CUDA]
        calls = [e for e in events if e.device_type == DeviceType.CPU
                 and e.name.startswith(LAUNCH_CALLS)]
        offset = (min(e.time_range.start for e in dev_ev)
                  - min(e.time_range.start for e in calls)
                  if dev_ev and calls else "none")
        print(f"RESULT {len(dev_ev)} {offset}", flush=True)


def summarize(log_path: Path) -> None:
    sessions, empty, dropping = (collections.Counter() for _ in range(3))
    most = collections.Counter()
    offsets, kept = collections.defaultdict(list), collections.defaultdict(list)
    key = None
    for line in log_path.read_text(errors="replace").splitlines():
        if line.startswith("SESSION "):
            key = tuple(line.split()[1:3])
            sessions[key] += 1
        elif line.startswith("RESULT ") and key:
            _, n, offset = line.split()
            empty[key] += n == "0"
            kept[key].append(int(n))
            if offset != "none":
                offsets[key].append(float(offset))
        elif key and (m := re.search(r"Out-of-range = (\d+)", line)):
            dropped = int(m.group(1))
            dropping[key] += dropped > 0
            most[key] = max(most[key], dropped)
    for key in sorted(sessions):
        off = offsets[key]
        print(f"{key[0]:>7} {key[1]:>8}: {sessions[key]} sessions, "
              f"{empty[key]} with no device event, {dropping[key]} with "
              f"out-of-range records (at most {most[key]} in one); device "
              f"events kept {min(kept[key])} / "
              f"{statistics.median(kept[key]):g} / {max(kept[key])}; first "
              f"device event - first launch call: "
              + (f"min {min(off):.1f} median {statistics.median(off):.1f} "
                 f"max {max(off):.1f} us" if off else "none"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=250)
    ap.add_argument("--log", type=Path,
                    default=ROOT / "build" / "trace_probe.log")
    ap.add_argument("--load", action="store_true",
                    help="trace a long queue on the card before the rounds")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.rounds, args.load)
        return 0
    args.log.parent.mkdir(parents=True, exist_ok=True)
    with open(args.log, "w") as out:
        rc = subprocess.run(
            [sys.executable, __file__, "--child", "--rounds", str(args.rounds)]
            + ["--load"] * args.load,
            stdout=out, stderr=subprocess.STDOUT,
            env={**os.environ, "KINETO_LOG_LEVEL": "0"}).returncode
    if rc:
        print(f"the sessions failed (rc {rc}); see {args.log}")
        return rc
    summarize(args.log)
    print(CS.gpu_name_and_limit(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
