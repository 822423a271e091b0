"""The port's AdamW (``repro_torch/optim/adamw.py``) against the JAX
package's ``repro/optim/adamw.py``, on the CPU.

Both take the same parameters, gradients and state (numpy, carried across
by ``bridge.lm_params_from_numpy`` and ``adamw_state_from_numpy``) and must
give the same update: the learning rate, the global gradient norm, the new
moments and float32 parameters within OPT_TOL relative (float32 throughout,
with sums and a few roundings in other orders).  A bf16 parameter is the
float32 update rounded once, so where the two float32 values straddle a
rounding boundary the bf16 results differ by one bf16 step: bf16 parameters
are held within one bf16 step (2^-8 of the value) of the JAX package's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import AdamWState as JState
from repro_torch.bridge import adamw_state_from_numpy, lm_params_from_numpy
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.tree import tree_leaves

OPT_TOL = 1e-6
CPU = torch.device("cpu")
KW = dict(lr=3e-3, warmup_steps=10, total_steps=40, min_lr_frac=0.1,
          weight_decay=0.1)


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _problem(seed, dtype, grad_scale):
    """Params (one bf16 or f32 matrix, one f32 vector), gradients in the
    params' dtypes and a state with nonzero moments at step 7."""
    rng = np.random.default_rng(seed)
    p = {"w": jnp.asarray(rng.standard_normal((16, 24)), dtype),
         "b": jnp.asarray(rng.standard_normal((24,)), jnp.float32)}
    g = {"w": jnp.asarray(rng.standard_normal((16, 24)) * grad_scale, dtype),
         "b": jnp.asarray(rng.standard_normal((24,)) * grad_scale, jnp.float32)}
    m = {k: jnp.asarray(rng.standard_normal(a.shape) * 0.1, jnp.float32)
         for k, a in p.items()}
    v = {k: jnp.asarray(rng.random(a.shape) * 0.01, jnp.float32)
         for k, a in p.items()}
    return p, g, JState(step=jnp.asarray(7, jnp.int32), m=m, v=v)


def _port(tree):
    return lm_params_from_numpy(jax.tree.map(np.asarray, tree), CPU)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])      # clip idle, binding
def test_update_matches_the_jax_package(dtype, grad_scale):
    jp, jg, jst = _problem(3, dtype, grad_scale)
    jopt, opt = JAdamW(**KW), AdamW(**KW)
    want_p, want_s, want_m = jopt.update(jg, jst, jp)
    state = adamw_state_from_numpy(jax.tree.map(np.asarray, jst), CPU)
    got_p, got_s, got_m = opt.update(_port(jg), state, _port(jp))
    assert isinstance(got_s, AdamWState) and int(got_s.step) == 8
    gnorm = float(want_m["grad_norm"])
    assert (gnorm > 1.0) == (grad_scale > 1.0)               # the clip binds
    assert _rel(float(got_m["grad_norm"]), gnorm) <= OPT_TOL
    assert _rel(float(got_m["lr"]), float(want_m["lr"])) <= OPT_TOL
    for a, b in zip(tree_leaves(got_s.m) + tree_leaves(got_s.v),
                    jax.tree.leaves(want_s.m) + jax.tree.leaves(want_s.v)):
        assert _rel(a.numpy(), np.asarray(b)) <= OPT_TOL
    for name in ("w", "b"):
        a, b = _np(got_p[name]), np.asarray(want_p[name], np.float32)
        assert got_p[name].dtype == (torch.bfloat16 if name == "w" and
                                     dtype == jnp.bfloat16 else torch.float32)
        if got_p[name].dtype == torch.bfloat16:
            assert np.all(np.abs(a - b) <= np.abs(b) * 2.0 ** -8)
            assert np.mean(a == b) > 0.95
        else:
            assert _rel(a, b) <= OPT_TOL


def test_schedule_matches_over_warmup_cosine_and_floor():
    jopt, opt = JAdamW(**KW), AdamW(**KW)
    for step in range(0, 60):      # warmup to 10, cosine to 40, the floor after
        want = float(jopt.schedule(jnp.asarray(step, jnp.int32)))
        got = float(opt.schedule(torch.tensor(step, dtype=torch.int32)))
        assert abs(got - want) <= OPT_TOL * max(abs(want), 1e-30), step
    assert float(opt.schedule(torch.tensor(0))) == 0.0
    assert abs(float(opt.schedule(torch.tensor(40))) - 0.1 * KW["lr"]) < 1e-9


def test_several_steps_match_on_identical_gradients():
    """Five steps from init on the same gradient sequence, f32 params."""
    rng = np.random.default_rng(5)
    jp = {"w": jnp.asarray(rng.standard_normal((8, 8)), jnp.float32)}
    jopt, opt = JAdamW(**KW), AdamW(**KW)
    jst, p = jopt.init(jp), _port(jp)
    st = opt.init(p)
    for _ in range(5):
        g = rng.standard_normal((8, 8)).astype(np.float32)
        jp, jst, _ = jopt.update({"w": jnp.asarray(g)}, jst, jp)
        p, st, _ = opt.update({"w": torch.from_numpy(g)}, st, p)
    assert _rel(p["w"].numpy(), np.asarray(jp["w"])) <= 10 * OPT_TOL


def test_adamw_converges_quadratic():
    """``tests/test_optim.py``'s case on the port."""
    opt = AdamW(lr=0.1, weight_decay=0.0, warmup_steps=5, total_steps=200)
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    state = opt.init(params)
    for _ in range(150):
        params, state, _ = opt.update({"w": 2 * params["w"]}, state, params)
    assert float((params["w"] ** 2).sum()) < 1e-2


def test_bf16_params_keep_f32_state():
    opt = AdamW(lr=0.01)
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = opt.init(params)
    assert state.m["w"].dtype == torch.float32 and state.step.dtype == torch.int32
    new, state, _ = opt.update({"w": torch.ones(4, dtype=torch.bfloat16)},
                               state, params)
    assert new["w"].dtype == torch.bfloat16
