"""The port's prefill and gradients tensor-parallel over a "model" axis of
two gloo ranks (``tests/_torch_ranks.py``, one spawn with a timeout) for a
reduced model of every family whose layers the train step does not cover:
qwen3-1.7b (qk-norm), deepseek-v2-lite-16b (MLA and MoE with a shared
expert), hymba-1.5b (attention beside mamba, a sliding window),
xlstm-350m (mLSTM and sLSTM), musicgen-medium (frames in, four codebook
heads out) and internvl2-26b (patches before the tokens).  Weights are the
port's init from a seeded generator, in the JAX package's layout (which
the port's trees keep, and which the rules cut): the JAX package runs on
the same numpy trees, the port on them through
``bridge.lm_params_from_numpy``.

* The prefill's last-position logits, gathered whole over "model", within
  LM_TOL of their max |x| of the one-process prefill (the tolerance of
  ``tests/test_torch_lm.py``: float32 with sums in other orders); each
  rank's chunk of every cache leaf is its chunk of the one-process cache
  in ``cache_shardings``' placement, within LM_TOL of the leaf's max.
* ``value_and_grad`` on the rank's shards inside ``model_parallel``: the
  loss within LOSS_TOL relative and every gradient leaf, gathered whole,
  within LEAF_TOL of its max |g| of the one-process gradient: the
  replicated leaves too (norms, MLA's ``w_dkv``, the MoE router, mLSTM's
  and sLSTM's biases), whose partial gradients the f operators sum.
* Both also against the JAX package's ``prefill`` and
  ``jax.value_and_grad`` of its ``loss_fn`` (jitted, one device) on the
  same weights and inputs, within the tolerances that hold the
  one-process port to it (``tests/test_torch_lm.py``'s LM_TOL,
  ``tests/test_torch_train.py``'s LOSS_TOL and GRAD_TOL).
* The reduced xlstm-350m on the JAX package's own init (``PRNGKey(8)``),
  where the (1, 2) gradients of mLSTM's ``b_if`` and ``gn`` differ from
  the one-process port's by more than LEAF_TOL (up to 1.37e-5 of the
  leaf's max): both float32 gradients against the port's gradient in
  float64 (the weights and inputs cast, float32 pins turned to float64 in
  the test only).  Each leaf of either within F64_TOL of the float64
  leaf's max, and the (1, 2) error within twice the one-process error plus
  LEAF_TOL: the split is float32 rounding (sums in another order on a
  gradient that is small beside the terms it sums, ``b_if`` of the last
  mLSTM run 6.08e-5 one-process, 7.45e-5 at (1, 2);
  this case prints every leaf's under ``pytest -s``), not a fault.
* The packed projections (mamba's ``w_in``, mLSTM's ``w_up``, sLSTM's
  ``w_gates``) are held by each rank as the rules' column chunk of the
  packed weight in the JAX package's layout, bitwise: the activation is
  resharded, not the weight.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_ranks import spawn_ranks, tp_forward_rank
from repro.configs import get_reduced_config as jreduced
from repro.models import transformer as JT
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import InputShape
from repro_torch.launch.sharding import cache_shardings, shard
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_model
from repro_torch.tree import tree_leaves, tree_map, tree_paths

ARCHS = ("qwen3-1.7b", "deepseek-v2-lite-16b", "hymba-1.5b", "xlstm-350m",
         "musicgen-medium", "internvl2-26b")
LM_TOL = 2e-5
LOSS_TOL = 2e-6
LEAF_TOL = 1.1e-5
GRAD_TOL = 5e-5             # the port against the JAX package's gradients
F64_TOL = 1e-4              # float32 gradients against float64, per leaf
JAX_INIT = ("xlstm-350m", 8)  # the arch and PRNGKey of the float64 case
S, B = 20, 2
CPU = torch.device("cpu")


def _inputs(cfg, specs, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for name, s in specs.items():
        if s.dtype.is_floating_point:
            out[name] = rng.standard_normal(s.shape).astype(np.float32)
        else:
            out[name] = rng.integers(0, cfg.vocab_size, s.shape,
                                     dtype=np.int32)
    return out


@pytest.fixture(scope="module")
def cases():
    out = {}
    for i, arch in enumerate(ARCHS):
        cfg = get_reduced_config(arch)
        model = get_model(cfg, CPU)
        shape = InputShape("t", S, B, "train")
        params = tree_map(lambda x: x.numpy(), model.init(
            torch.Generator().manual_seed(5 + i)))
        train = _inputs(cfg, model.train_inputs(shape), seed=i)
        prompt = {k: v for k, v in train.items() if k != "labels"}
        out[arch] = dict(params=params, train=train, prompt=prompt)
    return out


@pytest.fixture(scope="module")
def jax_init(cases):
    """JAX_INIT's arch on the JAX package's init, its train batch."""
    arch, key = JAX_INIT
    params = jax.tree.map(np.asarray, JT.init(jreduced(arch),
                                              jax.random.PRNGKey(key)))
    return dict(params=params, train=cases[arch]["train"])


@pytest.fixture(scope="module")
def ranks(cases, jax_init, tmp_path_factory):
    todo = [(arch, cases[arch]["params"], cases[arch][what])
            for arch in ARCHS for what in ("prompt", "train")]
    todo.append((JAX_INIT[0], jax_init["params"], jax_init["train"]))
    got = spawn_ranks(tp_forward_rank, 2, tmp_path_factory.mktemp("tpfwd"),
                      todo, timeout=240)
    out = {(arch, what): [r[2 * i + j] for r in got]
           for i, arch in enumerate(ARCHS)
           for j, what in enumerate(("prompt", "train"))}
    out["jax_init"] = [r[-1] for r in got]
    return out


@pytest.fixture(scope="module")
def jax_side(cases):
    """The JAX package's prefill logits and (loss, gradient leaves with
    their key paths) for each arch, on the cases' weights and inputs."""
    out = {}
    for arch in ARCHS:
        jcfg, c = jreduced(arch), cases[arch]
        logits, _ = jax.jit(lambda p, b: JT.prefill(jcfg, p, b, S))(
            c["params"], c["prompt"])
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: JT.loss_fn(jcfg, p, b)))(c["params"], c["train"])
        out[arch] = dict(logits=np.asarray(logits), loss=float(loss),
                         grads=[(jax.tree_util.keystr(kp), np.asarray(g))
                                for kp, g in
                                jax.tree_util.tree_flatten_with_path(grads)[0]])
    return out


class _StandIn:
    """A (1, 2) mesh's axes, sizes and one rank's coordinate, for the
    sharding rules."""
    axis_names = ("data", "model")
    shape = {"data": 1, "model": 2}

    def __init__(self, coord):
        self._coord = coord

    def coordinate(self):
        return self._coord


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_over_two_model_ranks_matches_one_process(arch, cases,
                                                          ranks):
    cfg = get_reduced_config(arch)
    c = cases[arch]
    params = lm_params_from_numpy(c["params"], CPU)
    want, caches = T.prefill(cfg, params, _torch(c["prompt"]), S)
    want = want.numpy()
    lim = LM_TOL * max(float(np.abs(want).max()), 1.0)
    for got in ranks[(arch, "prompt")]:
        assert got["logits"].shape == want.shape
        assert float(np.abs(got["logits"] - want).max()) <= lim
    # every cache leaf: the rank's chunk in cache_shardings' placement
    for got in ranks[(arch, "prompt")]:
        mesh = _StandIn(got["coord"])
        want_chunks = shard(caches, cache_shardings(mesh, caches), mesh)
        for path, a, b in zip(tree_paths(caches), tree_leaves(got["caches"]),
                              tree_leaves(want_chunks)):
            b = b.numpy()
            lim = LM_TOL * max(float(np.abs(b).max()), 1e-30)
            assert a.shape == b.shape, path
            assert float(np.abs(a - b).max()) <= lim, path


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_over_two_model_ranks_match_one_process(arch, cases,
                                                          ranks):
    cfg = get_reduced_config(arch)
    c = cases[arch]
    params = lm_params_from_numpy(c["params"], CPU)
    loss, grads = value_and_grad(cfg, params, _torch(c["train"]))
    paths = tree_paths(grads)
    for got in ranks[(arch, "train")]:
        assert abs(got["loss"] - float(loss)) <= LOSS_TOL * abs(float(loss))
        for path, a, b in zip(paths, tree_leaves(got["grads"]),
                              tree_leaves(grads)):
            b = b.numpy()
            lim = LEAF_TOL * max(float(np.abs(b).max()), 1e-30)
            assert a.shape == b.shape, path
            assert float(np.abs(a - b).max()) <= lim, path


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_over_two_model_ranks_matches_the_jax_package(arch, jax_side,
                                                              ranks):
    want = jax_side[arch]["logits"]
    lim = LM_TOL * max(float(np.abs(want).max()), 1.0)
    for got in ranks[(arch, "prompt")]:
        assert got["logits"].shape == want.shape
        assert float(np.abs(got["logits"] - want).max()) <= lim


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_over_two_model_ranks_match_the_jax_package(arch, jax_side,
                                                              ranks):
    want = jax_side[arch]
    for got in ranks[(arch, "train")]:
        assert abs(got["loss"] - want["loss"]) <= LOSS_TOL * abs(want["loss"])
        assert tree_paths(got["grads"]) == [p for p, _ in want["grads"]]
        for a, (path, b) in zip(tree_leaves(got["grads"]), want["grads"]):
            lim = GRAD_TOL * max(float(np.abs(b).max()), 1e-30)
            assert a.shape == b.shape, path
            assert float(np.abs(a - b).max()) <= lim, path


PACKED = (("hymba-1.5b", ("mamba", "w_in")), ("xlstm-350m", ("w_up",)),
          ("xlstm-350m", ("w_gates",)))


@pytest.mark.parametrize("arch,leaf", PACKED,
                         ids=[f"{a}-{'.'.join(k)}" for a, k in PACKED])
def test_packed_projections_keep_the_rules_chunks(arch, leaf, cases, ranks):
    """Every run of ``arch`` whose layers hold ``leaf``: rank r's chunk is
    the r-th half of the packed weight along its last dim, bitwise."""
    seen = 0
    for ri, run in enumerate(cases[arch]["params"]["runs"]):
        whole = run
        for k in leaf:
            whole = whole.get(k) if isinstance(whole, dict) else None
        if whole is None:
            continue
        seen += 1
        for r, got in enumerate(ranks[(arch, "prompt")]):
            mine = got["chunks"]["runs"][ri]
            for k in leaf:
                mine = mine[k]
            half = np.split(np.asarray(whole), 2, axis=-1)[r]
            assert mine.dtype == half.dtype
            assert np.array_equal(mine, half)
    assert seen


def _grads_f64(cfg, params, batch, monkeypatch):
    """The one-process port's loss and gradients in float64: the weights
    cast, the config's dtype float64, and the float32 the code pins
    (``Tensor.float``, the recurrent states' init) turned to float64."""
    from repro_torch.models import ssm as SSM
    init_m, init_s = SSM.mlstm_state_init, SSM.slstm_state_init

    def f64(fn):
        return lambda *a, **k: tree_map(lambda t: t.double(), fn(*a, **k))
    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "float", torch.Tensor.double)
        m.setattr(SSM, "mlstm_state_init", f64(init_m))
        m.setattr(SSM, "slstm_state_init", f64(init_s))
        loss, grads = value_and_grad(cfg.replace(dtype="float64"), tree_map(
            lambda a: a.double(), params), batch)
    assert all(g.dtype == torch.float64 for g in tree_leaves(grads))
    return loss, grads


def test_xlstm_gradients_on_jax_init_weights_are_f32_rounding(
        jax_init, ranks, monkeypatch):
    cfg = get_reduced_config(JAX_INIT[0])
    params = lm_params_from_numpy(jax_init["params"], CPU)
    batch = _torch(jax_init["train"])
    _, one = value_and_grad(cfg, params, batch)
    _, ref = _grads_f64(cfg, params, batch, monkeypatch)
    for got in ranks["jax_init"]:
        readings = []
        for path, a, b, c in zip(tree_paths(one), tree_leaves(one),
                                 tree_leaves(ref), tree_leaves(got["grads"])):
            b = b.numpy()
            top = max(float(np.abs(b).max()), 1e-300)
            readings.append((path, float(np.abs(a.double().numpy() - b).max())
                             / top, float(np.abs(c - b).max()) / top))
        # every leaf's errors of the one-process and the (1, 2) float32
        # gradient against float64 (shown with ``pytest -s``)
        for path, e_one, e_tp in readings:
            print(f"{path}: e_one {e_one:.3g}, e_tp {e_tp:.3g}")
        for path, e_one, e_tp in readings:
            assert e_one <= F64_TOL and e_tp <= F64_TOL, (path, e_one, e_tp)
            assert e_tp <= 2 * e_one + LEAF_TOL, (path, e_one, e_tp)
