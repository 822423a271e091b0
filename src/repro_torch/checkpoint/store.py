"""Atomic, asynchronous checkpoints of tensor trees: ``repro/checkpoint/
store.py`` on the same on-disk layout, so a checkpoint written by either
package restores in the other.

Layout (one directory per step):
    step_00000123/
      MANIFEST.json      the step, each leaf's key path (``jax.tree_util.
                         keystr``'s spelling) and its shape and dtype
      leaf_00000.npy ... one .npy per leaf, in the JAX package's leaf order;
                         bfloat16 stored as its uint16 bits
      COMMITTED          written last: a directory without it is ignored

``AsyncCheckpointer.save_async`` copies the tree to the host on the
caller's thread, then writes it from a background thread, so the training
loop does not wait on the disk.  ``restore`` rebuilds the tree of
``like_tree`` (its structure, key paths and shapes must match the
manifest's) on a device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.tree import tree_flatten

COMMITTED = "COMMITTED"
MANIFEST = "MANIFEST.json"


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array; bfloat16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf) -> str:
    """The manifest's dtype: numpy's name, ``bfloat16`` for bf16."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def save(tree, directory: str, step: int) -> str:
    """Synchronous atomic save.  Returns the checkpoint's path."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    leaves, treedef = tree_flatten(tree)
    manifest = {"step": step, "paths": treedef.paths(), "leaves": []}
    for i, leaf in enumerate(leaves):
        arr = _host(leaf)
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
        manifest["leaves"].append({"shape": list(arr.shape),
                                   "dtype": _dtype_name(leaf)})
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, COMMITTED), "w") as f:
        f.write(str(time.time()))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


class AsyncCheckpointer:
    """Snapshot to the host on the caller's thread, write on a daemon
    thread, one write in flight; keeps the newest ``keep`` checkpoints."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self.last_path: Optional[str] = None

    def wait(self):
        """Wait for the write in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, tree, step: int):
        self.wait()
        leaves, treedef = tree_flatten(tree)
        # bf16 leaves keep their dtype on the host, so the manifest names it
        host_tree = treedef.unflatten([
            leaf.detach().cpu() if isinstance(leaf, torch.Tensor)
            else np.asarray(leaf) for leaf in leaves])

        def _write():
            try:
                self.last_path = save(host_tree, self.directory, step)
                self._gc()
            except Exception as e:        # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def _gc(self):
        ckpts = sorted(p for p in os.listdir(self.directory)
                       if p.startswith("step_") and not p.endswith(".tmp"))
        for p in ckpts[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, p))


def latest_step(directory: str) -> Optional[int]:
    """The newest committed step in ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(p.split("_")[1]) for p in os.listdir(directory)
             if p.startswith("step_")
             and os.path.exists(os.path.join(directory, p, COMMITTED))]
    return max(steps) if steps else None


def restore(directory: str, step: int, like_tree: Any, device="cuda"):
    """The checkpoint of ``step`` as a tree of ``like_tree``'s structure
    (tensors, or anything with ``.shape``, as leaves), each leaf a tensor on
    ``device`` in the manifest's dtype.  Raises if the checkpoint is not
    committed or its key paths, leaf count or shapes differ."""
    device = resolve_device(device)
    path = os.path.join(directory, f"step_{step:08d}")
    if not os.path.exists(os.path.join(path, COMMITTED)):
        raise FileNotFoundError(f"uncommitted or missing checkpoint: {path}")
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    leaves_like, treedef = tree_flatten(like_tree)
    if len(leaves_like) != len(manifest["leaves"]):
        raise ValueError(f"leaf count mismatch: {len(leaves_like)} vs "
                         f"{len(manifest['leaves'])}")
    if treedef.paths() != manifest["paths"]:
        raise ValueError("the checkpoint's key paths differ from like_tree's")
    out = []
    for i, (like, meta) in enumerate(zip(leaves_like, manifest["leaves"])):
        arr = np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"leaf {i} ({manifest['paths'][i]}): shape "
                             f"{arr.shape} != expected {tuple(like.shape)}")
        if meta["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        out.append(t.to(device))
    return treedef.unflatten(out)
