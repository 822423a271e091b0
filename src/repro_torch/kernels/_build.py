"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on its own into a shared library with a
plain C interface, ``build/kernels/<name>-<digest>.so`` at the root of the
checkout (a directory ``.gitignore`` lists).  The digest covers the source,
the headers of ``csrc/`` (``hopper.cuh``) and the flags, so an edited
source or header is rebuilt and a stale library is never loaded.  Nothing
is built when a module is imported: ``library`` builds at first use, and
``build`` starts one nvcc per source, all at once.

``LAUNCHES`` counts kernel launches by name.  A wrapper adds one exactly
where it launches its kernel, so a run can show that it went through the
kernels and not through their plain versions.  ``COSTS`` counts the work
of every call of a kernel's function, on any route (the kernel, its plain
version, or shapes alone on the meta device): ``(name, "flop")`` and
``(name, "bytes")``, from the operands' shapes by each kernel module's
cost function, the counts its bound is taken from.
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
SOURCES = ("window_attention", "codec", "flash_attention",
           "flash_attention_bwd", "decode_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: collections.Counter = collections.Counter()
COSTS: collections.Counter = collections.Counter()


def count(name: str, cost) -> None:
    """Add one call's (flop, bytes) to ``COSTS``."""
    flop, nbytes = cost
    COSTS[(name, "flop")] += flop
    COSTS[(name, "bytes")] += nbytes


def route(t) -> str:
    """Where a call on ``t`` goes: "cuda" (the kernel), "cpu" (its plain
    version) or "meta" (empty outputs of the right shapes, nothing run)."""
    if t.device.type in ("cpu", "cuda", "meta"):
        return t.device.type
    raise ValueError(f"no kernel or plain version for device {t.device}")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source on the machine with the card")
    return path


def target(name: str, csrc: Path = CSRC) -> Path:
    """The library of ``csrc/<name>.cu``: its name carries a digest of that
    source, of every header in ``csrc`` (any source may include one) and of
    the flags."""
    digest = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


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
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors[1:]):
        raise ValueError(f"{what}: every operand must lie on the same CUDA "
                         "device")


def current_stream(device) -> int:
    """The raw handle of PyTorch's current stream on ``device``, without
    building a ``torch.cuda.Stream`` object: the stream argument of every
    C entry point."""
    import torch
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")
