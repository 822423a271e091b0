"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on its own into a shared library with a
plain C interface, ``build/kernels/<name>-<digest>.so`` at the root of the
checkout (a directory ``.gitignore`` lists).  The digest covers the source
and the flags, so an edited source is rebuilt and a stale library is never
loaded.  Nothing is built when a module is imported: ``library`` builds at
first use, and ``build`` starts one nvcc per source, all at once.

``LAUNCHES`` counts kernel launches by name.  A wrapper adds one exactly
where it launches its kernel, so a run can show that it went through the
kernels and not through their plain versions.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("window_attention", "codec", "quant")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: collections.Counter = collections.Counter()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source on the machine with the card")
    return path


def target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every source in ``names`` that has no current library, one
    nvcc process per source, all started together.  Returns the compiler's
    report (ptxas register and shared-memory use) per built source; raises
    with the compiler's output if any build fails."""
    todo = [n for n in names if not target(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = target(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {n}.cu failed ({proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, target(n))          # atomic: readers never see a partial file
        reports[n] = out
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    build((name,))
    return ctypes.CDLL(str(target(name)))


def check_operands(what: str, *tensors) -> None:
    """Raise unless every operand lies on one CUDA device: a wrapper never
    takes a host tensor in its kernel's place."""
    if any(t.device.type != "cuda" or t.device != tensors[0].device
           for t in tensors):
        raise ValueError(f"{what}: every operand must lie on the same CUDA "
                         "device")


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")
