"""The port's train step over a mesh (``launch/steps.py`` with ``mesh=``)
against the mesh-free step and the JAX package's step on a 2 x 1 mesh.

* On a 1 x 1 mesh (a one-rank gloo group) three steps of the reduced
  smollm-360m and granite-moe-3b-a800m, with two micro-batches, are bit
  for bit the mesh-free step's: loss, gradient norm, learning rate, every
  parameter and moment.  The mesh steps here are built with
  ``seq_shard=False``; ``tests/test_torch_tp_seq.py`` holds the default
  (sequence-parallel) step on a 1 x 1 mesh the same way.
* On two gloo ranks (a (2, 1) mesh; ``torch.multiprocessing`` over a
  ``FileStore``), one step of the reduced smollm-360m with FSDP (the
  "embed" dims sharded over "data") and with ``fsdp=False`` matches the
  one-process step on the whole batch, and the JAX package's
  ``build_train_step`` on a 2 x 1 mesh of forced host devices (one
  subprocess; weights from the JAX package's init, through
  ``bridge.lm_params_from_numpy``), within the training tolerances of the
  port's other tests: the loss within LOSS_TOL relative (each rank's mean
  of its half of the rows, averaged, against one mean over all: the same
  sum in another order), the gradient norm within NORM_TOL relative, each
  updated parameter leaf within LEAF_TOL of its largest magnitude, but
  where the one-process gradient is within FLAT_GRAD (100 eps) of 0: the
  first AdamW step moves a parameter by lr g / (|g| + eps), whose slope
  there is lr eps / (|g| + eps)^2, so a rounding of such a g (a sum that
  cancels) moves the update by up to twice the learning rate, the bound
  held there.
* Every kind of step (train, prefill, decode) builds over a "model" axis
  of 2; decode's takes its caches in ``cache_shardings``' placement
  (``tests/test_torch_tp_decode.py`` runs it).
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_ranks import one_rank_group, spawn_ranks, train_rank
from repro.configs import get_reduced_config as jreduced
from repro.data.tokens import TokenStream as JStream
from repro.models import transformer as JT
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import InputShape
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.launch.sharding import gather
from repro_torch.launch.steps import build_train_step
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import AdamW
from repro_torch.tree import tree_leaves, tree_paths

ROOT = Path(__file__).resolve().parents[1]
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=3)
LOSS_TOL = 2e-6
NORM_TOL = 1e-5
LEAF_TOL = 1.1e-5
FLAT_GRAD = 1e-6            # 100 x AdamW's eps
S, B = 24, 4
CPU = torch.device("cpu")

_JAX_CHILD = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs import get_reduced_config
    from repro.configs.base import InputShape
    from repro.launch.steps import build_train_step
    from repro.optim.adamw import AdamW
    with open(sys.argv[1], "rb") as f:
        arch, params, batch, opt_kw = pickle.load(f)
    cfg = get_reduced_config(arch)
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
    B, S = batch["tokens"].shape
    opt = AdamW(**opt_kw)
    step = build_train_step(cfg, mesh, InputShape("t", S, B, "train"),
                            opt=opt).jit()
    params = jax.tree.map(jnp.asarray, params)
    with mesh:
        new, _, m = step(params, opt.init(params),
                         {k: jnp.asarray(v) for k, v in batch.items()})
    with open(sys.argv[2], "wb") as f:
        pickle.dump(({k: float(v) for k, v in m.items()},
                     jax.tree.map(np.asarray, new)), f)
""")


@pytest.fixture
def one_rank(tmp_path):
    with one_rank_group(tmp_path):
        yield


def _batches(arch, n):
    stream = JStream(jreduced(arch), seq_len=S, batch=B, seed=2)
    return [next(stream) for _ in range(n)]


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-3b-a800m"])
def test_one_by_one_mesh_is_the_mesh_free_step(one_rank, arch):
    cfg = get_reduced_config(arch)
    shape = InputShape("t", S, B, "train")
    opt = AdamW(**OPT)
    free = build_train_step(cfg, shape, opt=opt, grad_accum=2)
    meshed = build_train_step(cfg, shape, mesh=make_host_mesh(device="cpu"),
                              opt=opt, grad_accum=2, seq_shard=False)
    p = get_model(cfg, CPU).init(torch.Generator().manual_seed(3))
    st = opt.init(p)
    pp, sp = meshed.place(p, st)
    for b in _batches(arch, 3):
        b = {k: torch.from_numpy(v) for k, v in b.items()}
        p, st, m0 = free(p, st, b)
        pp, sp, m1 = meshed(pp, sp, b)
        for k in m0:
            assert torch.equal(m0[k], m1[k]), k
        for a, c in zip(tree_leaves((p, st)), tree_leaves(gather((pp, sp)))):
            assert torch.equal(a, c)


@pytest.fixture(scope="module")
def two_rank_case(tmp_path_factory):
    """The JAX package's weights and batch, the one-process port step on
    the whole batch, and the JAX package's step on a 2 x 1 mesh."""
    import pickle
    tmp = tmp_path_factory.mktemp("jaxstep")
    arch = "smollm-360m"
    params_np = jax.tree.map(np.asarray,
                             JT.init(jreduced(arch), jax.random.PRNGKey(11)))
    batch = _batches(arch, 1)[0]
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump((arch, params_np, batch, OPT), f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", _JAX_CHILD, str(tmp / "in.pkl"),
                          str(tmp / "out.pkl")], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(tmp / "out.pkl", "rb") as f:
        jax_metrics, jax_params = pickle.load(f)
    cfg = get_reduced_config(arch)
    opt = AdamW(**OPT)
    step = build_train_step(cfg, InputShape("t", S, B, "train"), opt=opt)
    params = lm_params_from_numpy(params_np, CPU)
    new, _, m = step(params, opt.init(params),
                     {k: torch.from_numpy(v) for k, v in batch.items()})
    one = ({k: float(v) for k, v in m.items()},
           [x.numpy() for x in tree_leaves(new)])
    from repro_torch.launch.steps import value_and_grad
    grads = [g.numpy() for g in tree_leaves(value_and_grad(
        cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})[1])]
    jax_leaves = [np.asarray(x) for x in jax.tree.leaves(jax_params)]
    return dict(arch=arch, params_np=params_np, batch=batch, one=one,
                jax=(jax_metrics, jax_leaves), paths=tree_paths(new),
                grads=grads)


def _close(got, want, paths, grads):
    (gm, gp), (wm, wp) = got, want
    assert abs(gm["loss"] - wm["loss"]) <= LOSS_TOL * abs(wm["loss"])
    assert abs(gm["grad_norm"] - wm["grad_norm"]) <= \
        NORM_TOL * abs(wm["grad_norm"])
    assert gm["lr"] == pytest.approx(wm["lr"], rel=1e-6)
    for path, a, b, g in zip(paths, gp, wp, grads):
        lim = LEAF_TOL * max(float(np.abs(b).max()), 1e-30)
        flat = np.abs(g) < FLAT_GRAD
        assert float(np.abs(a - b)[~flat].max(initial=0.0)) <= lim, path
        assert float(np.abs(a - b)[flat].max(initial=0.0)) <= \
            2 * wm["lr"] + lim, path


@pytest.mark.parametrize("fsdp", [True, False])
def test_two_ranks_match_one_process_and_the_jax_package(tmp_path, fsdp,
                                                         two_rank_case):
    c = two_rank_case
    ranks = spawn_ranks(train_rank, 2, tmp_path, c["arch"], c["params_np"],
                        c["batch"], fsdp, OPT)
    d = get_reduced_config(c["arch"]).d_model
    for got in ranks:
        leaves = tree_leaves(got["params"])
        _close((got["metrics"], leaves), c["one"], c["paths"], c["grads"])
        _close((got["metrics"], leaves), c["jax"], c["paths"], c["grads"])
    # FSDP holds half of each "embed" dim a rank; replicated, the whole
    emb = ranks[0]["shards"]["embed"]
    assert emb == ((get_reduced_config(c["arch"]).vocab_size, d // 2)
                   if fsdp else (get_reduced_config(c["arch"]).vocab_size, d))
    for k in ranks[0]["metrics"]:
        assert ranks[0]["metrics"][k] == ranks[1]["metrics"][k]


def test_a_model_axis_over_one_raises():
    """Nothing is refused over a "model" axis over 1 any more: every kind
    of step builds there (tests/test_torch_tp_*.py run them), and the
    decode step's placed arguments are the parameters and the caches, the
    latter in ``cache_shardings``' placement for its shape (the name is
    kept from when decode there raised)."""
    from repro_torch.launch.sharding import cache_shardings
    from repro_torch.launch.steps import build_step
    from repro_torch.models.registry import get_model
    cfg = get_reduced_config("smollm-360m")
    mesh = Mesh(None, ("data", "model"), {"data": 1, "model": 2})
    for kind in ("train", "prefill", "decode"):
        step = build_step(cfg, InputShape("t", S, B, kind), mesh=mesh)
        assert step.local_fn is not None
    want = cache_shardings(mesh, get_model(cfg, "cpu").abstract_cache(B, S))
    assert step.in_specs[1] == want and step.in_specs[2:] == (None, None)
    assert "model" in want[0]["attn"]["k"]


def test_meshes_over_one_rank(one_rank):
    """On a group of one rank the production layouts degrade as the JAX
    package's do (every rank on "data", the other axes of size one), and
    ``strict`` raises; the host mesh takes a model axis only where it
    divides the ranks."""
    from repro_torch.launch.mesh import make_production_mesh
    m = make_production_mesh(device="cpu")
    assert (m.axis_names, m.shape) == (("data", "model"),
                                       {"data": 1, "model": 1})
    m = make_production_mesh(multi_pod=True, device="cpu")
    assert (m.axis_names, m.shape) == (("pod", "data", "model"),
                                       {"pod": 1, "data": 1, "model": 1})
    with pytest.raises(RuntimeError, match="need 256 ranks"):
        make_production_mesh(strict=True, device="cpu")
    assert make_host_mesh(model_parallel=2, device="cpu").shape == {
        "data": 1, "model": 1}
