"""The port's default train step over a mesh: sequence parallelism over the
"model" axis (``build_train_step(..., seq_shard=True)``, the JAX package's
default), where the residual stream between layers is each rank's chunk of
the sequence (Megatron-SP), against the one-process step and the JAX
package's default step.

* The sequence operators of ``launch/collectives.py`` on two gloo ranks:
  ``gather_seq`` (all-gather, backward reduce-scatter), ``scatter_seq``
  (reduce-scatter, backward all-gather), ``gather_seq_whole`` (backward the
  rank's own chunk), ``split_seq`` (backward all-gather) and
  ``seq_weight`` (backward all-reduce), each against numpy; the identity
  under Megatron-TP alone and outside ``model_parallel``.
* One step of six reduced families at (data, model) = (1, 2) on gloo ranks
  (``tests/_torch_ranks.py``; every spawn has a timeout): smollm-360m with
  3 q heads over 1 kv head (whole on every rank: its gather's backward is
  the rank's own chunk, its output cut), granite-moe-3b-a800m (heads and
  experts split, routing on the gathered tokens), deepseek-v2-lite-16b
  (MLA, MoE with a shared expert), hymba-1.5b (attention and mamba on the
  gathered sequence, the fuse on the chunk, a window of 16), xlstm-350m
  (mLSTM and sLSTM scans on the gathered sequence) and internvl2-26b (the
  patches prepended before the cut); smollm-360m and granite at (2, 2).
  Each is held to the one-process step on the whole batch within
  ``tests/test_torch_tp_steps.py``'s tolerances (the loss within LOSS_TOL
  relative, the gradient norm within NORM_TOL, each updated leaf within
  LEAF_TOL of its max, and where the one-process gradient is within
  FLAT_GRAD of 0 within twice the learning rate), and to the JAX
  package's default ``build_train_step`` on a forced-host mesh of the same
  shape (four devices, one subprocess for every run): within the same
  tolerances beyond the one-process port's own distance to the JAX
  package's step on one device, figure by figure and leaf by leaf (that
  distance is below 1e-6 of a leaf's max but for xLSTM, whose float32
  step moves with the sum order alone: the JAX package's own (1, 2) step
  without ``seq_shard`` is 1.2e-5 of mLSTM's ``wq`` from its one-device
  step, its gradient norm 1.4e-5 from its (1, 2) default's, and the
  one-process port 2.1e-5 and 1.9e-5 from its one-device step).  Weights
  are the JAX package's init on both sides; every rank reports the same
  step.
* A sequence that the model axis does not divide (23 over 2) leaves the
  residual whole, as ``fit_pspec`` drops "model" there: the step is
  bitwise the ``seq_shard=False`` step.  On a 1 x 1 mesh the default step
  is bitwise the mesh-free step.
* The dry-run's counts of the (1, 2) step of the reduced smollm-360m
  (heads, MLP and vocabulary split), derived from the activation shapes.
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

from _torch_ranks import (one_rank_group, seq_ops_rank, sp_train_rank,
                          spawn_ranks)
from repro.configs import get_reduced_config as jreduced
from repro.models import transformer as JT
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import InputShape
from repro_torch.launch.dryrun import run_cells
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.sharding import gather
from repro_torch.launch.steps import build_train_step, value_and_grad
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
ODD_S = 23                  # not divided by the model axis
CPU = torch.device("cpu")
# smollm-360m with heads that stay whole over two ranks
OVER = {"smollm-360m": {"n_heads": 3, "n_kv_heads": 1}}
ARCHS = ("smollm-360m", "granite-moe-3b-a800m", "deepseek-v2-lite-16b",
         "hymba-1.5b", "xlstm-350m", "internvl2-26b")
RUNS = tuple((a, (1, 2)) for a in ARCHS) + (
    ("smollm-360m", (2, 2)), ("granite-moe-3b-a800m", (2, 2)))
COUNT_SHAPE = InputShape("t", 16, 8, "train")

_JAX_CHILD = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs import get_reduced_config
    from repro.configs.base import InputShape
    from repro.launch.steps import build_train_step
    from repro.optim.adamw import AdamW
    with open(sys.argv[1], "rb") as f:
        runs, opt_kw = pickle.load(f)
    out = []
    # every run at its mesh, then each arch on one device
    for arch, over, (data, model), params, batch in runs:
        cfg = get_reduced_config(arch).replace(**over)
        devs = np.asarray(jax.devices()[:data * model])
        mesh = Mesh(devs.reshape(data, model), ("data", "model"))
        B, S = batch["labels"].shape[:2]
        opt = AdamW(**opt_kw)
        step = build_train_step(cfg, mesh, InputShape("t", S, B, "train"),
                                opt=opt).jit()
        p = jax.tree.map(jnp.asarray, params)
        with mesh:
            new, _, m = step(p, opt.init(p),
                             {k: jnp.asarray(v) for k, v in batch.items()})
        out.append(({k: float(v) for k, v in m.items()},
                    [np.asarray(x) for x in jax.tree.leaves(new)]))
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
""")


def _cfg(arch):
    return get_reduced_config(arch).replace(**OVER.get(arch, {}))


def _batch(arch, seq, seed):
    """A training batch of the reduced ``arch`` from ``seed``: token ids and
    labels in the vocabulary, patches and frames standard normal; the
    labels of a vision config's patch positions -1."""
    cfg = _cfg(arch)
    specs = get_model(cfg, CPU).train_inputs(InputShape("t", seq, B, "train"))
    rng = np.random.default_rng(seed)
    out = {}
    for name, sp in specs.items():
        if sp.dtype.is_floating_point:
            out[name] = rng.standard_normal(sp.shape).astype(np.float32)
        else:
            out[name] = rng.integers(0, cfg.vocab_size, sp.shape,
                                     dtype=np.int32)
    if "patches" in out:
        out["labels"][:, :cfg.n_frontend_tokens] = -1
    return out


def _case(arch, seq=S):
    jcfg = jreduced(arch).replace(**OVER.get(arch, {}))
    params = jax.tree.map(np.asarray, JT.init(jcfg, jax.random.PRNGKey(11)))
    return params, _batch(arch, seq, 2)


@pytest.fixture(scope="module")
def cases():
    return {arch: _case(arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def one_process(cases):
    """The mesh-free port step of each arch on the whole batch: metrics,
    updated leaves and the gradient leaves."""
    out = {}
    for arch, (params_np, batch) in cases.items():
        cfg = _cfg(arch)
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
def jax_child(cases, tmp_path_factory):
    """The subprocess that runs the JAX package's default step at each
    run's mesh and each arch on one device, started before the gloo ranks
    (``sp_runs`` asks for it first) so that both run at once; yields (the
    process, its output file, the runs' keys) and ends it if still
    running."""
    tmp = tmp_path_factory.mktemp("jaxsp")
    keys = list(RUNS) + [(arch, (1, 1)) for arch in ARCHS]
    runs = [(arch, OVER.get(arch, {}), mesh) + cases[arch]
            for arch, mesh in keys]
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump((runs, OPT), f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    with open(tmp / "err.txt", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", _JAX_CHILD, str(tmp / "in.pkl"),
             str(tmp / "out.pkl")], env=env, stdout=subprocess.DEVNULL,
            stderr=err)
    try:
        yield proc, tmp, keys
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def jax_side(jax_child):
    """The JAX package's steps, by (arch, mesh)."""
    proc, tmp, keys = jax_child
    rc = proc.wait(timeout=400)
    assert rc == 0, (tmp / "err.txt").read_text()[-3000:]
    with open(tmp / "out.pkl", "rb") as f:
        return dict(zip(keys, pickle.load(f)))


@pytest.fixture(scope="module")
def sp_runs(jax_child, cases, tmp_path_factory):
    """Each run of RUNS through the port's default mesh step on gloo ranks
    (two for (1, 2), four for (2, 2)), and on the two ranks smollm-360m at
    ODD_S with and without ``seq_shard``: every rank's result."""
    odd = _case("smollm-360m", ODD_S)
    got = {}
    for world in (2, 4):
        runs = [run for run in RUNS if run[1][0] * run[1][1] == world]
        todo = [(arch, OVER.get(arch, {}), mesh) + cases[arch] + (True,)
                for arch, mesh in runs]
        if world == 2:
            runs += [("odd", sq) for sq in (True, False)]
            todo += [("smollm-360m", OVER["smollm-360m"], (1, 2)) + odd
                     + (sq,) for sq in (True, False)]
        ranks = spawn_ranks(sp_train_rank, world,
                            tmp_path_factory.mktemp(f"sp{world}"), todo, OPT,
                            timeout=240)
        for i, key in enumerate(runs):
            got[key] = [r[i] for r in ranks]
    return got


def _gaps(got, want, grads):
    """|got - want| of the loss and the gradient norm, and of each leaf
    its largest over the elements whose gradient is not flat and over
    those whose gradient is."""
    (gm, gp), (wm, wp) = got, want
    leaves = []
    for a, b, g in zip(gp, wp, grads):
        d, flat = np.abs(a - b), np.abs(g) < FLAT_GRAD
        leaves.append((float(d[~flat].max(initial=0.0)),
                       float(d[flat].max(initial=0.0))))
    return ({k: abs(gm[k] - wm[k]) for k in ("loss", "grad_norm")}, leaves)


def _close(got, want, paths, grads, slack=None):
    """``got`` within the tolerances of ``want``, beyond ``slack`` (a
    ``_gaps`` of another pair) where given."""
    (gm, gp), (wm, wp) = got, want
    (ds, dl), (ss, sl) = _gaps(got, want, grads), slack or (
        {"loss": 0.0, "grad_norm": 0.0}, [(0.0, 0.0)] * len(gp))
    assert ds["loss"] <= LOSS_TOL * abs(wm["loss"]) + ss["loss"]
    assert ds["grad_norm"] <= NORM_TOL * abs(wm["grad_norm"]) + \
        ss["grad_norm"]
    assert gm["lr"] == pytest.approx(wm["lr"], rel=1e-6)
    for path, b, (d, df), (s, sf) in zip(paths, wp, dl, sl):
        lim = LEAF_TOL * max(float(np.abs(b).max()), 1e-30)
        assert d <= lim + s, path
        assert df <= 2 * wm["lr"] + lim + sf, path


def _ids(run):
    arch, (data, model) = run
    return f"{arch}-{data}x{model}"


@pytest.mark.parametrize("run", RUNS, ids=_ids)
def test_sp_step_matches_the_one_process_step(run, sp_runs, one_process):
    one = one_process[run[0]]
    ranks = sp_runs[run]
    for got in ranks:
        assert got["seq"]                  # the step cut the sequence
        _close((got["metrics"], tree_leaves(got["params"])),
               (one["metrics"], one["leaves"]), one["paths"], one["grads"])
    for got in ranks[1:]:
        assert got["metrics"] == ranks[0]["metrics"]


@pytest.mark.parametrize("run", RUNS, ids=_ids)
def test_sp_step_matches_the_jax_package_default_step(run, sp_runs,
                                                      one_process, jax_side):
    one = one_process[run[0]]
    got = sp_runs[run][0]
    own = _gaps((one["metrics"], one["leaves"]), jax_side[(run[0], (1, 1))],
                one["grads"])
    _close((got["metrics"], tree_leaves(got["params"])), jax_side[run],
           one["paths"], one["grads"], own)


def test_a_sequence_that_does_not_divide_is_the_megatron_step(sp_runs):
    on, off = sp_runs[("odd", True)], sp_runs[("odd", False)]
    for a, b in zip(on, off):
        assert not a["seq"] and not b["seq"]
        assert a["metrics"] == b["metrics"]
        for x, y in zip(tree_leaves(a["params"]), tree_leaves(b["params"])):
            assert np.array_equal(x, y)


def test_a_one_by_one_mesh_is_the_mesh_free_step(tmp_path):
    """The default (``seq_shard=True``) over a model axis of one rank: no
    cut, no collective, bit for bit the mesh-free step, two steps."""
    arch = "granite-moe-3b-a800m"
    cfg = get_reduced_config(arch)
    shape = InputShape("t", S, B, "train")
    opt = AdamW(**OPT)
    with one_rank_group(tmp_path):
        free = build_train_step(cfg, shape, opt=opt)
        meshed = build_train_step(cfg, shape, opt=opt,
                                  mesh=make_host_mesh(device="cpu"))
        p = get_model(cfg, CPU).init(torch.Generator().manual_seed(3))
        st = opt.init(p)
        pp, sp = meshed.place(p, st)
        for seed in (4, 5):
            b = {k: torch.from_numpy(v)
                 for k, v in _batch(arch, S, seed).items()}
            p, st, m0 = free(p, st, b)
            pp, sp, m1 = meshed(pp, sp, b)
            for k in m0:
                assert torch.equal(m0[k], m1[k]), k
        for a, c in zip(tree_leaves((p, st)), tree_leaves(gather((pp, sp)))):
            assert torch.equal(a, c)


def test_sequence_operators_and_their_backward(tmp_path):
    n = 2
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 4)).astype(np.float32)
    shapes = {"gather_seq": x.shape, "gather_seq_whole": x.shape,
              "scatter_seq": (2, 3, 4), "split_seq": (2, 3, 4),
              "seq_weight": (4,)}
    g = {k: rng.standard_normal((n,) + sh).astype(np.float32)
         for k, sh in shapes.items()}
    ranks = spawn_ranks(seq_ops_rank, n, tmp_path, x, g, timeout=120)
    chunks = np.split(x, n, axis=1)
    for r, got in enumerate(ranks):
        y, gx = got["gather_seq"]
        assert np.array_equal(y, x)
        np.testing.assert_allclose(gx, np.split(g["gather_seq"].sum(0), n,
                                                axis=1)[r], rtol=1e-6)
        y, gx = got["gather_seq_whole"]
        assert np.array_equal(y, x)
        assert np.array_equal(gx, np.split(g["gather_seq_whole"][r], n,
                                           axis=1)[r])
        y, gx = got["scatter_seq"]
        np.testing.assert_allclose(y, n * chunks[r], rtol=1e-6)
        assert np.array_equal(gx, np.concatenate(list(g["scatter_seq"]), 1))
        y, gx = got["split_seq"]
        assert np.array_equal(y, chunks[r])
        assert np.array_equal(gx, np.concatenate(list(g["split_seq"]), 1))
        y, gx = got["seq_weight"]
        assert np.array_equal(y, x[0, 0])
        np.testing.assert_allclose(gx, g["seq_weight"].sum(0), rtol=1e-6)
        assert got["tp_identity"] and got["outside_identity"]


@pytest.fixture(scope="module")
def counted():
    """The dry-run's records of the reduced smollm-360m's (1, 2) step with
    and without ``seq_shard``, counted in spawned workers."""
    todo = [("smollm-360m", COUNT_SHAPE,
             {"mesh_shape": (1, 2), "reduced": True, "seq_shard": sq})
            for sq in (True, False)]
    return run_cells(todo, jobs=2)


def test_sp_collectives_are_each_layers_gather_and_scatter(counted):
    """At (1, 2), in order of the step (L layers, each an attention and an
    MLP split over "model", the vocabulary split, remat on):

    forward: the embedding's reduce-scatter of its partial rows, each
    layer's two all-gathers (attention's and the MLP's entry) and two
    reduce-scatters (their row-parallel exits), the loss's all-gather of
    the final norm's chunk, and the loss chunk's three all-reduces (the
    maximum, the sum of exponentials, the target logit);
    backward: the loss chunk recomputed (three all-reduces), the loss
    gather's reduce-scatter, the final norm's weight (an all-reduce of d),
    and per layer its recompute up to the last tensor the backward needs
    (both entries' all-gathers and the attention's reduce-scatter, whose
    chunk the second norm keeps; the MLP's exit feeds only the residual
    add) and the conjugates of its four operators (two all-gathers, two
    reduce-scatters) and of its two norms' weights (all-reduces of d);
    then the embedding's all-gather and the clip norm's sum of squares.
    An all-gather counts its output, a reduce-scatter its input: each a
    whole (B, S, d) float32 activation.  Without ``seq_shard`` the step is
    Megatron-TP's, all-reduces alone (``tests/test_torch_tp_steps.py``
    holds them)."""
    cfg = get_reduced_config("smollm-360m")
    Bc, Sc, L, d = (COUNT_SHAPE.global_batch, COUNT_SHAPE.seq_len,
                    cfg.n_layers, cfg.d_model)
    assert Sc <= cfg.loss_chunk and cfg.remat
    sp, tp = counted
    for cell in counted:
        assert cell["status"] == "OK", cell.get("traceback")
    assert sp["seq_shard"] and not tp["seq_shard"]
    act = Bc * Sc * d * 4
    row = Bc * Sc * 4
    n_ag = (2 * L + 1) + 2 * L + (2 * L + 1)
    n_rs = (1 + 2 * L) + L + (1 + 2 * L)
    n_row, n_vec = 3 + 3, 1 + 2 * L
    cb, cc = sp["collective_bytes"], sp["collective_count"]
    assert cc == {"all-reduce": n_row + n_vec + 1, "all-gather": n_ag,
                  "reduce-scatter": n_rs, "all-to-all": 0,
                  "collective-permute": 0}
    assert cb["all-gather"] == n_ag * act
    assert cb["reduce-scatter"] == n_rs * act
    assert cb["all-reduce"] == 2 * (n_row * row + n_vec * d * 4 + 4)
    assert set(tp["collective_count"]) == set(cc)
    assert tp["collective_count"]["all-gather"] == 0
    assert tp["collective_count"]["reduce-scatter"] == 0
    print(f"\n(1, 2) smollm-360m reduced: SP {cb} in {cc}; TP "
          f"{tp['collective_bytes']} in {tp['collective_count']}")
