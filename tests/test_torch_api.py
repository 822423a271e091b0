"""The port's package-level names, ``models/swin.py::detection_loss``,
``models/transformer.py::param_count`` and the dry-run's ``--resume`` and
incremental write, against the JAX package's.

- Every name that ``repro.core`` and ``repro.models`` export has a
  counterpart of the same name in ``repro_torch.core`` /
  ``repro_torch.models``, the object of the port's module; both split plans
  implement the port's ``SplitPlan`` protocol.
- ``detection_loss`` on numpy levels and targets (two levels, positives in
  one, none in the other, background labels outside the classes) within
  LOSS_RTOL of the JAX function, its autograd gradient on every level map
  within GRAD_TOL of ``jax.grad``'s (of that map's max |g|).
- ``param_count`` equal to the JAX one on a reduced LM's bridged weights.
- The dry-run over one arch's reduced cells: ``--out`` holds the first cell
  before the second completes; ``--resume`` keeps the OK and SKIP cells
  without counting them again and counts a FAIL cell again; a failing cell
  still exits 1 with the same summary line.
"""
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core
import repro.models
import repro_torch.core
import repro_torch.models
from repro.configs import get_reduced_config as jget_reduced
from repro.configs.swin_t_detection import reduced as jreduced
from repro.models import swin as JSW
from repro.models import transformer as JT
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.configs import get_reduced_config
from repro_torch.configs.swin_t_detection import reduced
from repro_torch.core.splitting import LMSplitPlan, SplitPlan, SwinSplitPlan
from repro_torch.launch import dryrun as DR
from repro_torch.models import swin as SW
from repro_torch.models import transformer as T

LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5


def _exported(pkg):
    return {n: v for n, v in vars(pkg).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)}


@pytest.mark.parametrize("ref,port", [(repro.core, repro_torch.core),
                                      (repro.models, repro_torch.models)])
def test_package_level_names_have_counterparts(ref, port):
    names = _exported(ref)
    assert names
    got = _exported(port)
    assert set(names) <= set(got)
    for n, v in got.items():
        mod = getattr(v, "__module__", None)
        if mod is not None:
            assert mod.startswith(port.__name__ + "."), n


def test_split_plans_implement_the_protocol():
    assert isinstance(SwinSplitPlan(reduced(), None, device="cpu"), SplitPlan)
    cfg = get_reduced_config("qwen3-1.7b")
    assert isinstance(LMSplitPlan(cfg, None, device="cpu"), SplitPlan)
    assert not isinstance(object(), SplitPlan)


def _levels_and_targets(rng, cfg):
    levels, targets = [], []
    for (h, w), n_pos in (((6, 5), 7), ((3, 3), 0)):
        levels.append({
            "cls": rng.normal(size=(2, h, w, cfg.num_classes)).astype(np.float32),
            "box": np.abs(rng.normal(size=(2, h, w, 4))).astype(np.float32),
            "ctr": rng.normal(size=(2, h, w, 1)).astype(np.float32)})
        pos = np.zeros((2, h, w), bool)
        pos.reshape(-1)[rng.choice(pos.size, n_pos, replace=False)] = True
        labels = rng.integers(0, cfg.num_classes, size=(2, h, w))
        labels[~pos & (rng.random((2, h, w)) < 0.5)] = -1
        targets.append({"cls": labels.astype(np.int32),
                        "box": np.abs(rng.normal(size=(2, h, w, 4))).astype(np.float32),
                        "pos": pos})
    return levels, targets


def test_detection_loss_and_its_gradient_match(rng):
    cfg, jcfg = reduced(), jreduced()
    levels, targets = _levels_and_targets(rng, cfg)
    assert targets[0]["pos"].any() and not targets[1]["pos"].any()
    tl = [{k: torch.tensor(v, requires_grad=True) for k, v in lv.items()}
          for lv in levels]
    loss = SW.detection_loss(cfg, tl, targets)
    loss.backward()
    jl = [{k: jnp.asarray(v) for k, v in lv.items()} for lv in levels]
    jt = [{k: jnp.asarray(v) for k, v in tg.items()} for tg in targets]
    jloss, jgrad = jax.value_and_grad(
        lambda lv: JSW.detection_loss(jcfg, lv, jt))(jl)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    for lv, jg, tg in zip(tl, jgrad, targets):
        for k in ("cls", "box"):
            g, want = lv[k].grad.numpy(), np.asarray(jg[k])
            if k == "box" and not tg["pos"].any():   # L1 on no positive
                assert not want.any() and not g.any()
                continue
            np.testing.assert_allclose(
                g, want, rtol=0, atol=GRAD_TOL * np.abs(want).max())
        assert lv["ctr"].grad is None or not lv["ctr"].grad.any()


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "hymba-1.5b"])
def test_param_count_matches(arch):
    jp = jax.tree.map(np.asarray, JT.init(jget_reduced(arch),
                                          jax.random.PRNGKey(0)))
    assert T.param_count(lm_params_from_numpy(jp, "cpu")) == JT.param_count(jp)


# -- the dry-run -------------------------------------------------------------

def _main(out, *extra):
    return DR.main(["--arch", "smollm-360m", "--mesh-shape", "1,1",
                    "--out", str(out), *extra])


def test_dryrun_writes_as_it_goes_and_resumes(tmp_path, monkeypatch):
    out = tmp_path / "dryrun.json"
    real = DR.run_cell
    calls = []

    def counted(arch, shape, **kw):
        if calls:               # every cell done so far is on disk already
            on_disk = [(c["arch"], c["shape"]) for c in
                       json.loads(out.read_text())]
            assert on_disk == calls
        calls.append((arch, shape))
        return real(arch, shape, **{**kw, "reduced": True})
    monkeypatch.setattr(DR, "run_cell", counted)
    assert _main(out) == 0
    first = json.loads(out.read_text())
    assert [(c["arch"], c["shape"]) for c in first] == calls
    assert len(calls) == 4 and {c["status"] for c in first} == {"OK", "SKIP"}

    # a record left FAIL is counted again; OK and SKIP ones are kept
    failed = next(i for i, c in enumerate(first) if c["status"] == "OK")
    first[failed]["status"] = "FAIL"
    out.write_text(json.dumps(first))
    del calls[:]
    assert _main(out, "--resume") == 0
    assert calls == [(first[failed]["arch"], first[failed]["shape"])]
    again = json.loads(out.read_text())
    assert [DR.cell_key(c) for c in again] == [DR.cell_key(c) for c in first]
    for i, (a, b) in enumerate(zip(again, first)):
        assert a["status"] in ("OK", "SKIP")
        if i != failed:
            assert a == b

    # without --resume every cell is counted again
    del calls[:]
    assert _main(out, "--shape", first[0]["shape"]) == 0
    assert len(calls) == 1


def test_dryrun_exit_code_and_summary_on_a_failing_cell(tmp_path, monkeypatch,
                                                        capsys):
    def failing(arch, shape, **kw):
        return {"arch": arch, "shape": shape, "mesh": "1x1", "status": "FAIL",
                "error": "ValueError: injected"}
    monkeypatch.setattr(DR, "run_cell", failing)
    out = tmp_path / "dryrun.json"
    assert _main(out, "--shape", "train_4k") == 1
    assert "dry-run: 0 OK, 0 SKIP, 1 FAIL" in capsys.readouterr().out
    assert json.loads(out.read_text())[0]["status"] == "FAIL"
