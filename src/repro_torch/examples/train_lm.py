"""Train a small LM end-to-end with the full production stack: the train
step, async checkpointing, simulated failure + restart.  The port of
``examples/train_lm.py``: ``python -m repro_torch.launch.train`` in a
subprocess, 100 steps checkpointing every 40, then a restart with
``--resume`` to 200 steps.  The port's trainer labels a checkpoint with
the number of steps it holds, so the restart resumes at step 100 from the
first run's final checkpoint.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --reduced \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.examples.train_lm  # full width
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from typing import Any, Dict, List

from repro_torch.examples import ROOT, SRC, add_port_flags

# the port's own directory, never the JAX example's /tmp/repro_train_ckpt
CKPT = os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt")
TIMEOUT_S = 900.0
STEP_LINE = re.compile(r"^step\s+(\d+) loss (\S+)", re.M)
RESUMED = re.compile(r"^resumed from step (\d+)", re.M)
LAUNCHES_LINE = re.compile(r"^kernel launches: (\{.*\})$", re.M)


def losses(stdout: str) -> Dict[int, float]:
    """The losses of the step lines a run printed, by step."""
    return {int(s): float(l) for s, l in STEP_LINE.findall(stdout)}


def launches(stdout: str) -> Dict[str, int]:
    """The kernel launches of the runs whose output ``stdout`` holds, summed
    by kernel (each trainer prints its own on its last line)."""
    total: collections.Counter = collections.Counter()
    for line in LAUNCHES_LINE.findall(stdout):
        total.update(json.loads(line))
    return dict(total)


def argv(args, ckpt: str) -> List[str]:
    """The trainer's options both runs share, as the JAX example passes
    them, plus ``--device`` (and ``--reduced`` where given)."""
    return (["--arch", "smollm-360m", "--seq", "64", "--batch", "8",
             "--lr", "3e-3", "--ckpt", ckpt, "--ckpt-every", "40",
             "--log-every", "20", "--device", args.device]
            + (["--reduced"] if args.reduced else []))


def train(args, ckpt: str, *extra: str, timeout: float = TIMEOUT_S) -> str:
    """One trainer run with ``argv(args, ckpt)`` and ``extra``, in a
    subprocess within ``timeout`` seconds; returns its standard output.  A
    failed run raises."""
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train"]
        + argv(args, ckpt) + list(extra), check=True,
        env=dict(os.environ, PYTHONPATH=str(SRC)), cwd=ROOT,
        stdout=subprocess.PIPE, text=True, timeout=timeout).stdout


def result(first: str, resumed: str, ckpt: str) -> Dict[str, Any]:
    """The two runs' standard output and printed losses, the step the
    restart resumed from, the checkpoints left and the kernel launches."""
    m = RESUMED.search(resumed)
    return {"first": first, "resumed": resumed,
            "first_losses": losses(first), "resumed_losses": losses(resumed),
            "resumed_from": int(m.group(1)) if m else None,
            "checkpoints": sorted(os.listdir(ckpt)), "ckpt": ckpt,
            "launches": launches(first + resumed)}


def run(args, *, ckpt: str = CKPT, timeout: float = TIMEOUT_S
        ) -> Dict[str, Any]:
    """The two runs, each within ``timeout`` seconds, with checkpoints in
    ``ckpt`` (emptied first): 100 steps, then the restart to 200 at the
    simulated failure.  Returns ``result``."""
    shutil.rmtree(ckpt, ignore_errors=True)
    first = train(args, ckpt, "--steps", "100", timeout=timeout)
    resumed = train(args, ckpt, "--steps", "200", "--resume",
                    timeout=timeout)
    return result(first, resumed, ckpt)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    add_port_flags(ap)
    return ap.parse_args(argv)


def main(argv=None) -> Dict[str, Any]:
    out = run(parse_args(argv))
    print("== phase 1: train 100 steps, checkpointing every 40 ==")
    print(out["first"], end="")
    print("\n== simulated node failure: process died; restart resumes from "
          "the last committed checkpoint ==")
    print(out["resumed"], end="")
    print("\ntrained 200 steps across a restart; checkpoints:",
          out["checkpoints"])
    return out


if __name__ == "__main__":
    main()
