"""The whole slice against the JAX package, and the port's package rules.

The slice: ``SwinSplitPlan.head_jitted`` -> ``ActivationCodec.compress_head``
(int8_delta_zlib) -> ``decompress_group`` -> ``tail_batched(pad_to=)``, for
three UEs, on the reduced config with the JAX package's weights and a random
``rel_bias``.  The payload accounting must match exactly.  The detections go
through int8 quantisation on both sides: a head activation that the two
sides compute 1e-6 apart can round to neighbouring grid points, so the
end-to-end detections are held to 2e-3 of each map's largest value (a
misplaced tensor or a wrong stride shows at order 1), while the port's tail
on the JAX package's own payloads is held to the fp32 tolerance of
test_torch_swin.py.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.swin_t_detection import reduced as jreduced
from repro.core.compression import ActivationCodec as JCodec
from repro.core.splitting import SwinSplitPlan as JPlan
from repro.models import swin as JSW
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.swin_t_detection import reduced
from repro_torch.core.compression import ActivationCodec
from repro_torch.core.splitting import (SERVER_ONLY, UE_ONLY, SwinSplitPlan,
                                        split_option)
from repro_torch.models import swin as SW
from repro_torch.tree import tree_flatten

SRC = Path(__file__).resolve().parents[1] / "src"
N_UES = 3
FP32_TOL = 5e-5
CODEC_TOL = 2e-3


@pytest.fixture(scope="module")
def slice_setup():
    cfg, jcfg = reduced(), jreduced()
    init = jax.jit(lambda key: JSW.init(jcfg, key))
    jparams = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(2)
    for stage in jparams["stages"]:
        for bp in stage["blocks"]:
            bp["rel_bias"] = rng.normal(size=bp["rel_bias"].shape).astype(np.float32)
    imgs = rng.uniform(size=(N_UES, 1, cfg.img_h, cfg.img_w, 3)).astype(np.float32)
    params = params_from_numpy(jparams, "cpu")
    return cfg, jcfg, jparams, params, imgs


def _leaves(tree):
    return tree_flatten(tree)[0]


@pytest.mark.parametrize("split,ship_merged", [(2, True), (3, False)])
def test_slice_matches_reference(slice_setup, split, ship_merged):
    cfg, jcfg, jparams, params, imgs = slice_setup
    opt = split_option(split)
    jplan = JPlan(jcfg, jax.tree.map(jnp.asarray, jparams),
                  ship_merged=ship_merged)
    jcodec = JCodec(mode="int8_delta_zlib")
    jps = [jcodec.compress_head(jplan.head_jitted(opt), jplan.params,
                                jnp.asarray(img))[0] for img in imgs]
    jouts = jplan.tail_batched(jcodec.decompress_group(jps), opt, pad_to=4)

    plan = SwinSplitPlan(cfg, params, ship_merged=ship_merged, device="cpu")
    codec = ActivationCodec(mode="int8_delta_zlib", device="cpu")
    producer = plan.head_jitted(opt)
    assert producer is plan.head_jitted(opt)
    tps = [codec.compress_head(producer, params, torch.from_numpy(img))[0]
           for img in imgs]
    touts = plan.tail_batched(codec.decompress_group(tps), opt, pad_to=4)

    assert len(touts) == len(jouts) == N_UES
    for tp, jp in zip(tps, jps):
        assert tp.raw_bytes == jp.raw_bytes == plan.raw_payload_bytes(opt)
        assert ([dataclasses.astuple(m) for m in tp.meta]
                == [dataclasses.astuple(m) for m in jp.meta])
    for tout, jout in zip(touts, jouts):
        for a, b in zip(_leaves(tout), jax.tree.leaves(jout)):
            b = np.asarray(b)
            assert tuple(a.shape) == b.shape
            scale = max(1.0, float(np.abs(b).max()))
            assert float(np.abs(a.numpy() - b).max()) <= CODEC_TOL * scale
    # the port's decode + tail on the JAX package's own payloads
    for tout, jout in zip(plan.tail_batched(codec.decompress_group(jps), opt,
                                            pad_to=4), jouts):
        for a, b in zip(_leaves(tout), jax.tree.leaves(jout)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=FP32_TOL, atol=FP32_TOL)


def test_plan_accounting_matches_reference():
    cfg, jcfg = reduced(), jreduced()
    for early in (False, True):
        for sm in (True, False):
            plan = SwinSplitPlan(cfg, None, ship_merged=sm,
                                 include_early_split=early, device="cpu")
            jplan = JPlan(jcfg, None, ship_merged=sm, include_early_split=early)
            assert plan.options == jplan.options
            for opt in plan.options:
                assert plan.head_flops(opt) == jplan.head_flops(opt)
                assert plan.tail_flops(opt) == jplan.tail_flops(opt)
                assert plan.payload_specs(opt) == jplan.payload_specs(opt)
                for batch in (1, 4):
                    assert (plan.raw_payload_bytes(opt, batch)
                            == jplan.raw_payload_bytes(opt, batch))


def test_plan_degenerate_options(slice_setup):
    cfg, _, _, params, imgs = slice_setup
    plan = SwinSplitPlan(cfg, params, device="cpu")
    img = torch.from_numpy(imgs[0])
    payload, local = plan.head(img, UE_ONLY)
    assert payload is None and plan.head_jitted(UE_ONLY) is None
    payload, none = plan.head(img, SERVER_ONLY)
    assert none is None and plan.head_jitted(SERVER_ONLY) is None
    full = plan.tail(payload, SERVER_ONLY)
    for a, b in zip(_leaves(local), _leaves(full)):
        assert torch.equal(a, b)
    split, _ = plan.head(img, "split1")
    for a, b in zip(_leaves(plan.tail(split, "split1")), _leaves(full)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=FP32_TOL,
                                   atol=FP32_TOL)


def test_cuda_entry_points_raise_without_a_card(monkeypatch):
    """Every entry point defaults to the card and raises when there is none,
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SW.init(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SwinSplitPlan(cfg, None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ActivationCodec()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"w": np.zeros((2, 2), np.float32)})


def test_import_leaves_jax_and_the_reference_out():
    code = ("import sys, repro_torch.bridge, repro_torch.core.splitting, "
            "repro_torch.core.compression, repro_torch.data.video, "
            "repro_torch.kernels.quant, repro_torch.core.pipeline, "
            "repro_torch.core.privacy, repro_torch.core.energy, "
            "repro_torch.launch.serve, repro_torch.launch.steps, "
            "repro_torch.models.transformer, repro_torch.models.registry, "
            "repro_torch.core.telemetry, repro_torch.configs, "
            "repro_torch.kernels.flash_attention, "
            "repro_torch.kernels.decode_attention, "
            "repro_torch.kernels.window_attention, repro_torch.core.cell, "
            "repro_torch.core.timeline, repro_torch.core.ran, "
            "repro_torch.core.mobility, repro_torch.core.chaos, "
            "repro_torch.core.trace_export, repro_torch.runtime.failures, "
            "repro_torch.core.ran_vec, repro_torch.core.engine_vec, "
            "repro_torch.launch.train, repro_torch.checkpoint.store, "
            "repro_torch.optim.adamw, repro_torch.data.tokens, "
            "repro_torch.launch.mesh, repro_torch.launch.sharding, "
            "repro_torch.launch.cost, repro_torch.launch.dryrun, "
            "repro_torch.optim.compress, repro_torch.core, "
            "repro_torch.models, repro_torch.examples.quickstart, "
            "repro_torch.examples.adaptive_split_video, "
            "repro_torch.examples.cell_video, "
            "repro_torch.examples.split_serve_lm, "
            "repro_torch.examples.train_lm\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_file_of_the_port_imports_jax_or_the_reference():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    assert {"ran_vec.py", "engine_vec.py", "train.py", "store.py", "adamw.py",
            "tokens.py"} <= {p.name for p in files}
    for path in files + [SRC.parent / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path


def test_tree_flatten_frees_its_leaves_without_the_collector():
    """``tree_flatten`` and ``tree_map`` leave no reference cycle behind: a
    leaf is freed when its last reference goes, not at the next collection
    (a cycle once kept every layer drawn by a model's init alive until
    then)."""
    import gc
    import weakref

    import torch

    from repro_torch.tree import tree_map
    gc.disable()
    try:
        tree = {"a": [torch.zeros(3), (torch.ones(2), None)], "b": torch.ones(1)}
        refs = [weakref.ref(leaf) for leaf in tree_flatten(tree)[0]]
        doubled = tree_map(lambda x: x * 2, tree)
        assert tree_flatten(doubled)[1] == tree_flatten(tree)[1]
        del tree, doubled
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
