"""The port's Swin-T model against the JAX package's, on the same weights.

The JAX package's ``init`` draws the weights; ``repro_torch.bridge`` hands
them over as numpy.  ``rel_bias`` is randomised (init sets it to zero, where
a wrong bias gather would not show).  Both sides run fp32 on the CPU with
different summation orders (XLA:CPU against ATen/oneDNN) through up to five
blocks and the FPN; the largest difference seen is about 5e-6 on outputs of
magnitude up to 7, so 5e-5 leaves a margin while any layout or gather error
shows at order 1.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.swin_t_detection import CONFIG as JFULL
from repro.configs.swin_t_detection import reduced as jreduced
from repro.models import swin as JSW
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.swin_t_detection import CONFIG, reduced
from repro_torch.models import swin as SW
from repro_torch.tree import tree_flatten

ATOL = RTOL = 5e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def model():
    cfg, jcfg = reduced(), jreduced()
    # jitted: the eager init dispatches one op at a time, ten times slower
    init = jax.jit(lambda key: JSW.init(jcfg, key))
    jparams = _np_tree(init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    for stage in jparams["stages"]:
        for bp in stage["blocks"]:
            bp["rel_bias"] = rng.normal(size=bp["rel_bias"].shape).astype(np.float32)
    img = rng.uniform(size=(2, cfg.img_h, cfg.img_w, 3)).astype(np.float32)
    return cfg, jcfg, jparams, params_from_numpy(jparams, "cpu"), img, {}


def _jax_head(model, split, ship_merged):
    """The JAX head's payload.  Only ship_merged=True is traced (each trace
    costs about a second): without the merged tensor the payload is the same
    minus its "x"."""
    _, jcfg, jparams, _, img, cache = model
    if split not in cache:
        cache[split] = _np_tree(JSW.head_apply_jit(jcfg, split, True)(
            jparams, jnp.asarray(img)))
    payload = dict(cache[split])
    if not ship_merged and 0 < split < jcfg.n_stages:
        del payload["x"]
    return payload


def _close(port_tree, jax_tree):
    pl, _ = tree_flatten(port_tree)
    jl = jax.tree.leaves(jax_tree)
    assert len(pl) == len(jl)
    for a, b in zip(pl, jl):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)


def test_static_tables_match_reference():
    assert np.array_equal(SW.rel_pos_index(7), JSW.rel_pos_index(7))
    for geom in ((14, 14, 7, 3), (140, 203, 7, 3), (21, 28, 7, 3)):
        assert np.array_equal(SW.shift_attn_mask(*geom), JSW.shift_attn_mask(*geom))
    for geom in ((14, 14, 10, 12, 7), (140, 203, 136, 200, 7)):
        assert np.array_equal(SW.pad_region_mask(*geom), JSW.pad_region_mask(*geom))


@pytest.mark.parametrize("cfgs", [(reduced(), jreduced()), (CONFIG, JFULL)],
                         ids=["reduced", "full"])
def test_init_and_accounting_match_reference(cfgs):
    """The port's own init has the JAX init's nesting and shapes (convs
    OIHW); FLOPs and boundary payloads are the same plain arithmetic."""
    cfg, jcfg = cfgs
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jshapes = jax.eval_shape(lambda: JSW.init(jcfg, jax.random.PRNGKey(0)))
    bridged = params_from_numpy(
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jshapes), "cpu")
    own = SW.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    lb, tb = tree_flatten(bridged)
    lo, to = tree_flatten(own)
    assert tb == to
    assert [tuple(x.shape) for x in lb] == [tuple(x.shape) for x in lo]
    assert SW.stage_flops(cfg) == JSW.stage_flops(jcfg)
    for split in range(5):
        assert SW.head_flops(cfg, split) == JSW.head_flops(jcfg, split)
        assert SW.tail_flops(cfg, split) == JSW.tail_flops(jcfg, split)
        for sm in (True, False):
            assert (SW.boundary_shapes(cfg, split, ship_merged=sm)
                    == JSW.boundary_shapes(jcfg, split, ship_merged=sm))
            assert (SW.boundary_bytes(cfg, split, ship_merged=sm)
                    == JSW.boundary_bytes(jcfg, split, ship_merged=sm))


def test_patch_merge_gather_order_with_odd_sizes(model):
    cfg, jcfg, jparams, params, _, _ = model
    x = np.random.default_rng(1).normal(size=(2, 7, 9, cfg.embed_dim)).astype(np.float32)
    merge = jparams["stages"][0]["merge"]
    want = JSW.patch_merge(jcfg, jax.tree.map(jnp.asarray, merge), jnp.asarray(x))
    got = SW.patch_merge(cfg, params["stages"][0]["merge"], torch.from_numpy(x))
    assert tuple(got.shape) == (2, 4, 5, 2 * cfg.embed_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
@pytest.mark.parametrize("ship_merged", [True, False])
@pytest.mark.parametrize("split", [0, 1, 2, 3, 4])
def test_head_apply_matches_reference(model, split, ship_merged, attn_impl):
    cfg, _, _, params, img, _ = model
    cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    got = SW.head_apply(cfg, params, torch.from_numpy(img), split,
                        ship_merged=ship_merged)
    _close(got, _jax_head(model, split, ship_merged))


@pytest.mark.parametrize("ship_merged", [True, False])
@pytest.mark.parametrize("split", [0, 1, 2, 3, 4])
def test_tail_apply_matches_reference(model, split, ship_merged):
    """Both tails take the same boundary payload (the JAX head's output).
    Without the merged tensor the port's tail recomputes the merge, and the
    detections are the same function of the image as the JAX tail's."""
    cfg, jcfg, jparams, params, _, _ = model
    want = JSW.tail_apply_jit(jcfg, split)(jparams,
                                           _jax_head(model, split, True))
    payload = _jax_head(model, split, ship_merged)
    got = SW.tail_apply(cfg, params, jax.tree.map(torch.tensor, payload),
                        split)
    _close(got, want)


@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
def test_forward_full_matches_reference(model, attn_impl):
    cfg, jcfg, jparams, params, img, _ = model
    cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    want = JSW.forward_full_jit(jcfg)(jparams, jnp.asarray(img))
    got = SW.forward_full(cfg, params, torch.from_numpy(img))
    assert [sorted(lv) for lv in got] == [["box", "cls", "ctr"]] * cfg.n_stages
    _close(got, want)


def test_head_producer_is_stable():
    cfg = reduced()
    assert SW.head_producer(cfg, 1, True) is SW.head_producer(cfg, 1, True)
    assert SW.head_producer(cfg, 1, True) is not SW.head_producer(cfg, 1, False)
    assert SW.head_producer(cfg, 1, True) is not SW.head_producer(cfg, 2, True)
