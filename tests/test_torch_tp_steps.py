"""The port's train step tensor-parallel over a "model" axis
(``launch/steps.py`` with ``mesh=``, the layers inside
``collectives.model_parallel``) against the one-process step and the JAX
package's step, and the collectives the dry-run counts for it.  Every mesh
step here is Megatron-TP alone (``seq_shard=False``: the residual stream
whole on each rank); ``tests/test_torch_tp_seq.py`` holds the default,
sequence-parallel step.

* Gloo ranks on the CPU (``tests/_torch_ranks.py``; every spawn has a
  timeout): one step of the reduced smollm-360m and granite-moe-3b-a800m
  at (data, model) = (1, 2), (2, 2) and (1, 4), FSDP on.  At (1, 4) the
  4 q heads split one a rank while the 2 kv heads stay whole: each rank
  slices the kv head its q head reads, and the replicated wk and wv sum
  their gradients over the ranks.  Each is held against the one-process
  step on the whole batch within the tolerances of
  ``tests/test_torch_mesh_steps.py`` (the loss within LOSS_TOL relative,
  the gradient norm within NORM_TOL, each updated leaf within LEAF_TOL of
  its largest magnitude, and where the one-process gradient is within
  FLAT_GRAD of 0 within twice the learning rate: AdamW's first step turns
  a rounding of such a gradient into a move of up to 2 lr).  (1, 2) and
  (2, 2) are also held against the JAX package's ``build_train_step`` on a
  forced-host mesh of that shape, four devices in one subprocess for all
  four runs.
* A9d: the dry-run's counts of the mesh step (``launch/dryrun.py`` on the
  meta device over a stand-in process group).  At (2, 1) the all-reduces
  are the float32 gradient of every leaf and the loss, twice their bytes
  (the JAX package's unit), and with FSDP the all-gathers are the full
  bytes of the leaves whose "embed" dim the rules shard.  At (1, 2) the
  all-reduces are the ones the layers' f and g operators make, counted here
  from the activation shapes.  The JAX package's HLO count of the same
  cell (its partitioner picks its own collectives) is printed beside it
  for the record, not held.
"""
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_ranks import spawn_ranks, tp_train_rank
from repro.configs import get_reduced_config as jreduced
from repro.data.tokens import TokenStream as JStream
from repro.models import transformer as JT
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import InputShape
from repro_torch.launch.dryrun import run_cells
from repro_torch.launch.sharding import ShardingRules, param_shardings
from repro_torch.launch.steps import build_train_step, value_and_grad
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import AdamW
from repro_torch.tree import spec_map, tree_leaves, tree_paths

ROOT = Path(__file__).resolve().parents[1]
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=3)
LOSS_TOL = 2e-6
NORM_TOL = 1e-5
LEAF_TOL = 1.1e-5
FLAT_GRAD = 1e-6            # 100 x AdamW's eps
S, B = 24, 4
CPU = torch.device("cpu")
ARCHS = ("smollm-360m", "granite-moe-3b-a800m")
MESHES = ((1, 2), (2, 2), (1, 4))
JAX_MESHES = ((1, 2), (2, 2))
# the dry-run's counted cells: the reduced smollm-360m's train step
COUNT_SHAPE = InputShape("t", 16, 8, "train")

_JAX_CHILD = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs import get_reduced_config
    from repro.configs.base import InputShape
    from repro.launch.hlo_cost import analyze
    from repro.launch.sharding import ShardingRules
    from repro.launch.steps import build_train_step
    from repro.optim.adamw import AdamW
    with open(sys.argv[1], "rb") as f:
        runs, counted, opt_kw = pickle.load(f)

    def mesh_of(data, model):
        devs = np.asarray(jax.devices()[:data * model])
        return Mesh(devs.reshape(data, model), ("data", "model"))

    out = {"runs": [], "hlo": []}
    for arch, (data, model), params, batch in runs:
        cfg = get_reduced_config(arch)
        mesh = mesh_of(data, model)
        B, S = batch["tokens"].shape
        opt = AdamW(**opt_kw)
        step = build_train_step(cfg, mesh, InputShape("t", S, B, "train"),
                                opt=opt).jit()
        p = jax.tree.map(jnp.asarray, params)
        with mesh:
            new, _, m = step(p, opt.init(p),
                             {k: jnp.asarray(v) for k, v in batch.items()})
        out["runs"].append(({k: float(v) for k, v in m.items()},
                            [np.asarray(x) for x in jax.tree.leaves(new)]))
    for arch, (data, model), fsdp, (S, B) in counted:
        cfg = get_reduced_config(arch)
        mesh = mesh_of(data, model)
        built = build_train_step(cfg, mesh, InputShape("t", S, B, "train"),
                                 rules=ShardingRules(fsdp=fsdp))
        with mesh:
            hlo = built.lower().compile().as_text()
        la = analyze(hlo)
        out["hlo"].append({"collective_bytes": la["collective_bytes"],
                           "collective_count": la["collective_count"]})
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
""")

COUNTED = (((2, 1), True), ((2, 1), False), ((1, 2), True))


def _case(arch):
    params = jax.tree.map(np.asarray,
                          JT.init(jreduced(arch), jax.random.PRNGKey(11)))
    batch = next(JStream(jreduced(arch), seq_len=S, batch=B, seed=2))
    return params, batch


@pytest.fixture(scope="module")
def cases():
    return {arch: _case(arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def one_process(cases):
    """The mesh-free port step of each arch on the whole batch: metrics,
    updated leaves and the gradient leaves."""
    out = {}
    for arch, (params_np, batch) in cases.items():
        cfg = get_reduced_config(arch)
        opt = AdamW(**OPT)
        params = lm_params_from_numpy(params_np, CPU)
        b = {k: torch.from_numpy(v) for k, v in batch.items()}
        step = build_train_step(cfg, InputShape("t", S, B, "train"), opt=opt)
        new, _, m = step(params, opt.init(params), b)
        grads = tree_leaves(value_and_grad(cfg, params, b)[1])
        out[arch] = dict(metrics={k: float(v) for k, v in m.items()},
                         leaves=[x.numpy() for x in tree_leaves(new)],
                         paths=tree_paths(new),
                         grads=[g.numpy() for g in grads])
    return out


@pytest.fixture(scope="module")
def jax_side(cases, tmp_path_factory):
    """The JAX package's step at each of JAX_MESHES for each arch, and its
    HLO collective count of the COUNTED cells, in one subprocess."""
    tmp = tmp_path_factory.mktemp("jaxtp")
    runs = [(arch, mesh) + cases[arch] for arch in ARCHS
            for mesh in JAX_MESHES]
    counted = [("smollm-360m", mesh, fsdp,
                (COUNT_SHAPE.seq_len, COUNT_SHAPE.global_batch))
               for mesh, fsdp in COUNTED]
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump((runs, counted, OPT), f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", _JAX_CHILD, str(tmp / "in.pkl"),
                          str(tmp / "out.pkl")], env=env, capture_output=True,
                         text=True, timeout=400)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(tmp / "out.pkl", "rb") as f:
        out = pickle.load(f)
    keys = [(arch, mesh) for arch in ARCHS for mesh in JAX_MESHES]
    return dict(zip(keys, out["runs"])), out["hlo"]


@pytest.fixture(scope="module")
def tp_runs(cases, tmp_path_factory):
    """Each (arch, mesh) of MESHES through the port's mesh step on gloo
    ranks: two ranks for (1, 2), four for the rest; every rank's result."""
    got = {}
    for world, meshes in ((2, [(1, 2)]), (4, [(2, 2), (1, 4)])):
        todo = [(arch, mesh) + cases[arch] + (True,) for arch in ARCHS
                for mesh in meshes]
        ranks = spawn_ranks(tp_train_rank, world,
                            tmp_path_factory.mktemp(f"tp{world}"), todo, OPT,
                            False, timeout=240)
        for i, (arch, mesh, *_) in enumerate(todo):
            got[(arch, mesh)] = [r[i] for r in ranks]
    return got


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


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_tp_step_matches_the_one_process_step(arch, mesh, tp_runs,
                                              one_process):
    one = one_process[arch]
    ranks = tp_runs[(arch, mesh)]
    for got in ranks:
        _close((got["metrics"], tree_leaves(got["params"])),
               (one["metrics"], one["leaves"]), one["paths"], one["grads"])
    # every rank reports the same step
    for got in ranks[1:]:
        assert got["metrics"] == ranks[0]["metrics"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", JAX_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_tp_step_matches_the_jax_package(arch, mesh, tp_runs, one_process,
                                         jax_side):
    one = one_process[arch]
    want = jax_side[0][(arch, mesh)]
    got = tp_runs[(arch, mesh)][0]
    _close((got["metrics"], tree_leaves(got["params"])), want, one["paths"],
           one["grads"])


def _leaf_bytes(arch, fsdp, mesh_shape):
    """(f32 bytes of every parameter leaf, full bytes of the leaves whose
    spec names "data") of the reduced arch."""
    cfg = get_reduced_config(arch)
    model = get_model(cfg, "cpu")
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh(None, ("data", "model"), dict(zip(("data", "model"),
                                                   mesh_shape)))
    abstract = model.abstract_params()
    specs = param_shardings(ShardingRules(fsdp=fsdp), model.spec(), abstract,
                            mesh)
    f32, sharded = [], []
    spec_map(lambda sp, x: (f32.append(4 * x.numel()),
                            sharded.append(x.numel() * x.element_size()
                                           if "data" in sp else 0)),
             specs, abstract)
    return f32, sum(sharded)


@pytest.fixture(scope="module")
def counted():
    """The dry-run's records of the COUNTED cells, counted in spawned
    workers (each starts its own stand-in process group)."""
    todo = [("smollm-360m", COUNT_SHAPE,
             {"mesh_shape": mesh, "fsdp": fsdp, "reduced": True,
              "seq_shard": False})
            for mesh, fsdp in COUNTED]
    return run_cells(todo, jobs=len(todo))


@pytest.mark.parametrize("fsdp", [True, False])
def test_data_parallel_collectives_are_the_gradient_and_fsdp_bytes(
        fsdp, counted, jax_side):
    cell = counted[COUNTED.index(((2, 1), fsdp))]
    assert cell["status"] == "OK", cell.get("traceback")
    f32, gathered = _leaf_bytes("smollm-360m", fsdp, (2, 1))
    cb, cc = cell["collective_bytes"], cell["collective_count"]
    # one all-reduce a gradient leaf and one for the loss, 2x their bytes
    assert cc["all-reduce"] == len(f32) + 1
    assert cb["all-reduce"] == 2 * (sum(f32) + 4)
    # FSDP gathers each "embed"-sharded leaf whole, once a step
    assert cb["all-gather"] == gathered
    assert (gathered > 0) == fsdp
    assert cb["reduce-scatter"] == cb["all-to-all"] == 0
    assert cell["total_collective_bytes"] == sum(cb.values())
    hlo = jax_side[1][COUNTED.index(((2, 1), fsdp))]
    print(f"\n(2, 1) fsdp={fsdp}: port {cb} in {cc}; JAX HLO "
          f"{hlo['collective_bytes']} in {hlo['collective_count']}")


def test_model_parallel_collectives_are_the_f_and_g_operators(counted,
                                                              jax_side):
    """At (1, 2) every collective is an all-reduce of the model group (no
    batch group, no FSDP gather), and they are, in order of the step:

    forward: the embedding's g, each layer's two g (attention's wo,
    the MLP's w_down) and the loss chunk's three (the maximum, the sum of
    exponentials, the target logit);
    backward: the loss chunk recomputed (three), the f before the
    unembedding, and per layer its recompute up to the last tensor the
    backward needs (the attention's g, whose sum the second norm keeps; the
    MLP's g feeds only the residual add, so the recompute stops before
    it) and its two f (the MLP's, the attention's);
    then the clip norm's sum of squares over the model group."""
    cfg = get_reduced_config("smollm-360m")
    Bc, Sc, L, d = (COUNT_SHAPE.global_batch, COUNT_SHAPE.seq_len,
                    cfg.n_layers, cfg.d_model)
    assert Sc <= cfg.loss_chunk            # one loss chunk
    cell = counted[COUNTED.index(((1, 2), True))]
    assert cell["status"] == "OK", cell.get("traceback")
    act = Bc * Sc * d * 4                  # a (B, S, d) f32 activation
    row = Bc * Sc * 4                      # a (B, S) f32 per-position value
    n_act = (1 + 2 * L) + (1 + L + 2 * L)
    n_row = 3 + 3
    want_count = n_act + n_row + 1
    want_bytes = 2 * (n_act * act + n_row * row + 4)
    cb, cc = cell["collective_bytes"], cell["collective_count"]
    assert cc == {"all-reduce": want_count, "all-gather": 0,
                  "reduce-scatter": 0, "all-to-all": 0,
                  "collective-permute": 0}
    assert cb["all-reduce"] == want_bytes
    hlo = jax_side[1][COUNTED.index(((1, 2), True))]
    print(f"\n(1, 2): port {cb} in {cc}; JAX HLO {hlo['collective_bytes']} "
          f"in {hlo['collective_count']}")
