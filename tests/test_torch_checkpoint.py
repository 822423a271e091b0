"""The port's checkpoint store (``repro_torch/checkpoint/store.py``) on the
CPU: a bitwise round trip, the committed-only latest step, the async
writer's garbage collection, the shape check, and the on-disk layout shared
with the JAX package's ``repro/checkpoint/store.py``: each package restores,
bitwise, a params + AdamW-state checkpoint the other wrote, bf16 leaves
included.  And the training driver's restart on it."""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as JCK
from repro.configs import get_reduced_config as jreduced
from repro.models import transformer as JT
from repro.optim.adamw import AdamW as JAdamW
from repro_torch.bridge import adamw_state_from_numpy, lm_params_from_numpy
from repro_torch.checkpoint import store as CK
from repro_torch.launch import train as TR
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.tree import tree_flatten, tree_leaves, tree_paths

CPU = torch.device("cpu")


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.randn(5, generator=g).to(torch.bfloat16),
                  "step": torch.tensor(7, dtype=torch.int32)},
            "runs": [{"w": torch.randn(2, 3, generator=g)}]}


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                       b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


def test_save_restore_roundtrip_is_bitwise(tmp_path):
    tree = _tree()
    path = CK.save(tree, str(tmp_path), step=3)
    assert os.path.exists(os.path.join(path, CK.COMMITTED))
    out = CK.restore(str(tmp_path), 3, tree, CPU)
    assert tree_flatten(out)[1] == tree_flatten(tree)[1]
    for a, b in zip(tree_leaves(tree), tree_leaves(out)):
        _same(a, b)


def test_latest_step_ignores_uncommitted(tmp_path):
    CK.save(_tree(), str(tmp_path), step=1)
    CK.save(_tree(), str(tmp_path), step=2)
    os.remove(os.path.join(str(tmp_path), "step_00000002", CK.COMMITTED))
    assert CK.latest_step(str(tmp_path)) == 1
    with pytest.raises(FileNotFoundError):
        CK.restore(str(tmp_path), 2, _tree(), CPU)


def test_async_checkpointer_keeps_the_newest(tmp_path):
    ck = CK.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        ck.save_async(_tree(), s)
    ck.wait()
    steps = sorted(int(p.split("_")[1]) for p in os.listdir(str(tmp_path)))
    assert steps == [2, 3]
    assert CK.latest_step(str(tmp_path)) == 3
    assert ck.last_path.endswith("step_00000003")


def test_restore_shape_mismatch_raises(tmp_path):
    CK.save(_tree(), str(tmp_path), step=1)
    bad = _tree()
    bad["a"] = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="shape"):
        CK.restore(str(tmp_path), 1, bad, CPU)
    other = _tree()
    other["z"] = torch.zeros(1)
    with pytest.raises(ValueError, match="leaf count"):
        CK.restore(str(tmp_path), 1, other, CPU)


def _jax_state(arch="smollm-360m"):
    """A bf16 copy of a reduced model's JAX params and an AdamW state one
    update on, so that every leaf is nonzero."""
    cfg = jreduced(arch).replace(dtype="bfloat16")
    params = JT.init(cfg, jax.random.PRNGKey(3))
    opt = JAdamW(lr=1e-2)
    grads = jax.tree.map(lambda a: jnp.full(a.shape, 0.5, a.dtype), params)
    params, state, _ = opt.update(grads, opt.init(params), params)
    return params, state


def test_port_restores_a_jax_checkpoint_bitwise(tmp_path):
    params, state = _jax_state()
    JCK.save((params, state), str(tmp_path), step=5)
    np_tree = jax.tree.map(np.asarray, (params, state))
    like = (lm_params_from_numpy(np_tree[0], CPU),
            adamw_state_from_numpy(np_tree[1], CPU))
    assert tree_paths(like) == [jax.tree_util.keystr(kp) for kp, _ in
                                jax.tree_util.tree_flatten_with_path(
                                    (params, state))[0]]
    out = CK.restore(str(tmp_path), 5, like, CPU)
    assert isinstance(out[1], AdamWState)
    assert any(a.dtype == torch.bfloat16 for a in tree_leaves(out))
    for a, b in zip(tree_leaves(out), tree_leaves(like)):
        _same(a, b)


def test_jax_package_restores_a_port_checkpoint_bitwise(tmp_path):
    params, state = _jax_state()
    np_tree = jax.tree.map(np.asarray, (params, state))
    ours = (lm_params_from_numpy(np_tree[0], CPU),
            adamw_state_from_numpy(np_tree[1], CPU))
    CK.save(ours, str(tmp_path), step=9)
    assert JCK.latest_step(str(tmp_path)) == 9
    out = JCK.restore(str(tmp_path), 9, jax.eval_shape(lambda: (params, state)))
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves((params, state))):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_resumed_training_continues_the_straight_run(tmp_path):
    """``launch.train``: 4 steps straight against 2, a checkpoint, and a
    resumed run of steps 2-3 on the CPU (bitwise: the CPU's sums are
    deterministic)."""
    base = ["--arch", "smollm-360m", "--reduced", "--device", "cpu",
            "--seq", "16", "--batch", "4", "--log-every", "1"]
    straight = TR.main(base + ["--steps", "4"])
    ck = str(tmp_path / "ck")
    first = TR.main(base + ["--steps", "4", "--ckpt", ck, "--ckpt-every", "2"])
    assert CK.latest_step(ck) == 4
    saved = CK.restore(ck, 2, (first["params"], first["opt_state"]), CPU)
    assert int(saved[1].step) == 2
    shutil.rmtree(os.path.join(ck, "step_00000004"))
    resumed = TR.main(base + ["--steps", "4", "--ckpt", ck, "--resume"])
    assert [m["step"] for m in resumed["steps"]] == [2, 3]
    for a, b in zip(resumed["steps"], straight["steps"][2:]):
        assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
    for a, b in zip(tree_leaves(resumed["params"]),
                    tree_leaves(straight["params"])):
        _same(a, b)
    assert [m["loss"] for m in first["steps"]] == [m["loss"] for m in
                                                   straight["steps"]]
