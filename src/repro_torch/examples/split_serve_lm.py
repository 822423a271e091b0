"""The paper's technique generalized to LM serving: run the first half of
an LM on the 'UE', ship the INT8+zlib-compressed residual stream, finish
on the 'edge' -- then keep decoding with the production serving path.
The port of ``examples/split_serve_lm.py``: ``python -m
repro_torch.launch.serve`` in a subprocess per arch.

    PYTHONPATH=src python -m repro_torch.examples.split_serve_lm --reduced \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.examples.split_serve_lm  # full width
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, Optional

from repro_torch.examples import ROOT, SRC, add_port_flags

ARCHS = ("qwen3-1.7b", "hymba-1.5b")
TIMEOUT_S = 900.0


def run(args, *, status_dir: Optional[str] = None,
        timeout: float = TIMEOUT_S) -> Dict[str, Any]:
    """Serve each of ARCHS split at half depth (prompt 32, gen 8, batch 2)
    through the port's CLI, each run within ``timeout`` seconds; returns
    each arch's standard output and, with ``status_dir``, the status
    payload (``--status-out``) it wrote there.  A failed run raises."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out: Dict[str, Any] = {}
    for arch in ARCHS:
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
               arch, "--prompt-len", "32", "--gen", "8", "--batch", "2",
               "--split", "0.5", "--device", args.device]
        if args.reduced:
            cmd.append("--reduced")
        status = None
        if status_dir is not None:
            status = str(Path(status_dir) / f"{arch}.json")
            cmd += ["--status-out", status]
        proc = subprocess.run(cmd, check=True, env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, text=True,
                              timeout=timeout)
        out[arch] = {"stdout": proc.stdout}
        if status is not None:
            with open(status) as f:
                out[arch]["status"] = json.load(f)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    add_port_flags(ap)
    return ap.parse_args(argv)


def main(argv=None) -> Dict[str, Any]:
    out = run(parse_args(argv))
    for arch, got in out.items():
        print(f"== {arch}: split serving at 50% depth ==")
        print(got["stdout"])
    return out


if __name__ == "__main__":
    main()
