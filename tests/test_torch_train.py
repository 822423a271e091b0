"""The port's training loss and gradients against the JAX package's, on the
CPU.

For the reduced config of each LM family (dense: smollm-360m, qwen3-1.7b;
MoE: granite-moe-3b-a800m; MLA: deepseek-v2-lite-16b; hybrid and windowed:
hymba-1.5b; recurrent: xlstm-350m; audio: musicgen-medium; vision:
internvl2-26b) the port's ``loss_fn`` and every gradient leaf, taken by
``launch.steps.value_and_grad`` on the JAX package's weights (``T.init``
with a PRNGKey, carried across by ``bridge.lm_params_from_numpy``) and the
same ``TokenStream`` batch, are held to ``jax.value_and_grad`` of the JAX
package's ``loss_fn``: the loss within LOSS_TOL relative, each gradient leaf
within GRAD_TOL of that leaf's max |g|.  The reduced configs are float32;
the two sides differ by sums in other orders (B5's backward recomputes P
from the log-sum-exp where XLA differentiates the softmax; the recurrent
blocks' loops and scans sum in other orders), up to about 1.1e-5 of a
leaf's max (an xLSTM leaf).  Then, on the port alone: remat on and off give
the same loss and gradients, and ``grad_accum`` 2 the gradients of one
batch of twice the size.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jreduced
from repro.data.tokens import TokenStream as JStream
from repro.models import transformer as JT
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import InputShape
from repro_torch.launch.steps import build_train_step, value_and_grad
from repro_torch.optim.adamw import AdamW
from repro_torch.tree import tree_leaves, tree_paths

ARCHS = ("smollm-360m", "qwen3-1.7b", "granite-moe-3b-a800m",
         "deepseek-v2-lite-16b", "hymba-1.5b", "xlstm-350m",
         "musicgen-medium", "internvl2-26b")
LOSS_TOL = 2e-6
GRAD_TOL = 5e-5
CPU = torch.device("cpu")


def seq_len(arch):
    """Long enough for Hymba's window (16) to bind and for InternVL's 8
    patches to sit before its text; 3 loss chunks where ``loss_chunk`` is
    cut below it."""
    return 40 if arch in ("hymba-1.5b", "internvl2-26b") else 24


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    """The JAX package's reduced weights as numpy, drawn once per arch (the
    tests read them and never write)."""
    return jax.tree.map(np.asarray, JT.init(jreduced(arch),
                                            jax.random.PRNGKey(7)))


def setup(arch, batch=2, seed=1):
    jcfg, tcfg = jreduced(arch), get_reduced_config(arch)
    b = next(JStream(jcfg, seq_len=seq_len(arch), batch=batch, seed=seed))
    return jcfg, tcfg, jax_params(arch), b


def to_port(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_the_jax_package(arch):
    jcfg, tcfg, jp, batch = setup(arch)
    # three loss chunks, the last padded with ignored labels
    jcfg = jcfg.replace(loss_chunk=seq_len(arch) // 3 + 1)
    tcfg = tcfg.replace(loss_chunk=jcfg.loss_chunk)
    jl, jg = jax.value_and_grad(lambda p, b: JT.loss_fn(jcfg, p, b))(
        jax.tree.map(jnp.asarray, jp), {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = value_and_grad(tcfg, lm_params_from_numpy(jp, CPU),
                                 to_port(batch))
    assert abs(float(loss) - float(jl)) <= LOSS_TOL * abs(float(jl))
    want = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert tree_paths(grads) == [jax.tree_util.keystr(kp) for kp, _ in want]
    for name, g, (_, w) in zip(tree_paths(grads), tree_leaves(grads), want):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape and g.dtype == torch.float32, name
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_TOL * float(np.abs(w).max()), (name, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_inputs_and_model_loss_match_the_registry(arch):
    """``LMModel.train_inputs`` gives the JAX registry's shapes and dtypes,
    and ``LMModel.loss_fn`` is ``loss_fn`` of its config."""
    from repro.configs.base import InputShape as JShape
    from repro.models.registry import get_model as jget_model
    from repro_torch.models.registry import get_model
    jcfg, tcfg, jp, batch = setup(arch)
    want = jget_model(jcfg).train_inputs(JShape("t", seq_len(arch), 2, "train"))
    model = get_model(tcfg, CPU)
    got = model.train_inputs(InputShape("t", seq_len(arch), 2, "train"))
    assert sorted(got) == sorted(want)
    for name, spec in got.items():
        assert spec.shape == tuple(want[name].shape), name
        assert str(spec.dtype).removeprefix("torch.") == str(want[name].dtype)
        assert tuple(batch[name].shape) == spec.shape
    params = lm_params_from_numpy(jp, CPU)
    loss = value_and_grad(tcfg, params, to_port(batch))[0]
    with torch.no_grad():               # the forward alone: the same bits
        assert torch.equal(model.loss_fn(params, to_port(batch)), loss)


@pytest.mark.parametrize("arch", ("smollm-360m", "hymba-1.5b",
                                  "granite-moe-3b-a800m"))
def test_remat_on_and_off_give_the_same_gradients(arch):
    _, tcfg, jp, batch = setup(arch)
    params, b = lm_params_from_numpy(jp, CPU), to_port(batch)
    l1, g1 = value_and_grad(tcfg, params, b)
    l0, g0 = value_and_grad(tcfg.replace(remat=False), params, b)
    assert torch.equal(l1, l0)
    for a, c in zip(tree_leaves(g1), tree_leaves(g0)):
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-7)


def test_grad_accum_matches_one_batch():
    """Two micro-batches of 2 give the loss and the gradients (as the
    optimizer receives them) of the batch of 4, since every row has as many
    labels."""
    _, tcfg, jp, batch = setup("qwen3-1.7b", batch=4)
    params, b = lm_params_from_numpy(jp, CPU), to_port(batch)
    shape = InputShape("t", seq_len=seq_len("qwen3-1.7b"), global_batch=4,
                       kind="train")
    seen = []

    class Capture(AdamW):
        def update(self, grads, state, p):
            seen.append(grads)
            return super().update(grads, state, p)

    opt = Capture(lr=1e-3)
    losses = [build_train_step(tcfg, shape, opt=opt, grad_accum=n)(
        params, opt.init(params), b)[2]["loss"] for n in (1, 2)]
    torch.testing.assert_close(losses[1], losses[0], rtol=1e-6, atol=0)
    for a, c in zip(tree_leaves(seen[1]), tree_leaves(seen[0])):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="micro-batches"):
        build_train_step(tcfg, InputShape("t", 8, 3, "train"), grad_accum=2)


def test_training_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """The trainer and the checkpoint restore default to the card and raise
    when there is none, instead of running on the CPU."""
    from repro_torch.checkpoint import store as CK
    from repro_torch.launch import train as TR
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TR.main(["--arch", "smollm-360m", "--reduced", "--steps", "1"])
    CK.save({"a": torch.zeros(2)}, str(tmp_path), step=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CK.restore(str(tmp_path), 1, {"a": torch.zeros(2)})
