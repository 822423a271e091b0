"""The port's fused activation codec against the JAX package's.

For identical numpy leaves the two codecs must put the same bytes on the
wire: the same zlib blobs, the same f32 scale bits and the same per-leaf
metas, across the int8 modes, both delta layouts and the three encode entry
points (``compress``, ``compress_group``, ``compress_head``), over leaves
that need block padding, a scalar, an empty leaf and batches on both sides
of the delta-axis switch.  Each side decodes the other's payloads to the
same bits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compression import ActivationCodec as JCodec
from repro_torch.core.compression import ActivationCodec, spatial_delta_axis
from repro_torch.tree import tree_flatten

BLOCK = 256
MODES = ["int8", "int8_zlib", "int8_delta_zlib"]
LAYOUTS = ["spatial", "block"]


def _tree(seed=3):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {
        "a": (rng.normal(size=(2, 13, 7, 24)) * 5).astype(f32),   # pads its block
        "b": (rng.normal(size=(311,)) * 0.3).astype(f32),
        "scalar": np.asarray(2.75, f32),
        "empty": np.zeros((0, 4), f32),
        "c": rng.normal(size=(1, 6, 6, 3)).astype(f32),
        "wide": rng.normal(size=(5, 4, 6, 8)).astype(f32),      # delta axis 0
    }


def _port(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _codecs(mode, layout):
    return (ActivationCodec(mode=mode, quant_block=BLOCK, delta_layout=layout,
                            device="cpu"),
            JCodec(mode=mode, quant_block=BLOCK, delta_layout=layout))


def _assert_same_wire(tp, jp):
    assert tp.blobs == jp.blobs
    assert len(tp.scales) == len(jp.scales) == 1
    assert tp.scales[0].dtype == np.float32
    assert tp.scales[0].tobytes() == np.asarray(jp.scales[0]).tobytes()
    assert ([dataclasses.astuple(m) for m in tp.meta]
            == [dataclasses.astuple(m) for m in jp.meta])
    assert tp.raw_bytes == jp.raw_bytes
    assert (tp.mode, tp.fused, tp.delta_layout) == (jp.mode, jp.fused,
                                                    jp.delta_layout)


def _assert_same_leaves(port_tree, jax_tree):
    pl, _ = tree_flatten(port_tree)
    jl = jax.tree.leaves(jax_tree)
    assert len(pl) == len(jl)
    for a, b in zip(pl, jl):
        assert tuple(a.shape) == tuple(b.shape)
        assert a.numpy().tobytes() == np.asarray(b).tobytes()


def _cross_decode(tc, jc, tp, jp, tree):
    """Each side decodes the other's payload (the JAX decoder takes the
    port's payload with a JAX tree definition: the wire carries none)."""
    _assert_same_leaves(tc.decompress(jp), jc.decompress(jp))
    jp_from_port = dataclasses.replace(tp, treedef=jax.tree.structure(tree))
    _assert_same_leaves(tc.decompress(tp), jc.decompress(jp_from_port))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_compress_is_byte_identical_and_cross_decodes(mode, layout):
    tree = _tree()
    tc, jc = _codecs(mode, layout)
    tp, jp = tc.compress(_port(tree)), jc.compress(_jax(tree))
    _assert_same_wire(tp, jp)
    _cross_decode(tc, jc, tp, jp, _jax(tree))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_compress_group_is_byte_identical_and_cross_decodes(mode, layout):
    trees = [_tree(seed) for seed in (3, 4, 5)]
    tc, jc = _codecs(mode, layout)
    tps = tc.compress_group([_port(t) for t in trees])
    jps = jc.compress_group([_jax(t) for t in trees])
    for tp, jp in zip(tps, jps):
        _assert_same_wire(tp, jp)
    # the port decodes the JAX group and its own group to the same bits
    for out_t, out_j in zip(tc.decompress_group(jps), jc.decompress_group(jps)):
        _assert_same_leaves(out_t, out_j)
    for out_t, jp in zip(tc.decompress_group(tps), jps):
        _assert_same_leaves(out_t, jc.decompress(jp))


@pytest.mark.parametrize("mode", MODES)
def test_compress_head_is_byte_identical(mode):
    """compress_head runs the producer and encodes its output: the same bytes
    as the JAX package's fused head->encode on the same inputs."""
    rng = np.random.default_rng(9)
    img = rng.normal(size=(1, 9, 10, 5)).astype(np.float32)

    # an exact producer (a scale and a transpose), so both sides emit the
    # same floats and the test isolates the codec
    def jax_producer(params, x):
        return {"feats": [x * params], "x": jnp.swapaxes(x, 1, 2)[..., :3]}

    def port_producer(params, x):
        return {"feats": [x * params], "x": x.transpose(1, 2)[..., :3]}

    tc, jc = _codecs(mode, "spatial")
    jp, jtree = jc.compress_head(jax.jit(jax_producer), jnp.float32(2.0),
                                 jnp.asarray(img))
    tp, ttree = tc.compress_head(port_producer, torch.tensor(2.0),
                                 torch.from_numpy(img))
    _assert_same_leaves(ttree, jtree)
    _assert_same_wire(tp, jp)
    _cross_decode(tc, jc, tp, jp, jtree)


def test_empty_tree_and_delta_axis():
    tc, jc = _codecs("int8_delta_zlib", "spatial")
    tp, jp = tc.compress({}), jc.compress({})
    _assert_same_wire(tp, jp)
    assert tc.decompress(tp) == {} and tc.decompress(jp) == {}
    assert spatial_delta_axis((1, 8, 8, 4)) == 1
    assert spatial_delta_axis((4, 8, 8, 4)) == 0
    assert spatial_delta_axis((311,)) is None
    assert spatial_delta_axis((0, 8, 8)) is None


def test_legacy_paths_raise_instead_of_encoding_another_way():
    for codec in (ActivationCodec(fused=False, device="cpu"),
                  ActivationCodec(mode="zlib", device="cpu"),
                  ActivationCodec(mode="raw", device="cpu")):
        assert not codec.supports_fused()
        with pytest.raises(NotImplementedError, match="quant.py"):
            codec.compress({"x": torch.ones(3)})
    legacy = JCodec(fused=False).compress({"x": jnp.ones((1, 4, 4, 2))})
    with pytest.raises(NotImplementedError, match="quant.py"):
        ActivationCodec(device="cpu").decompress(legacy)
    with pytest.raises(ValueError, match="multiple of 128"):
        ActivationCodec(quant_block=1000, device="cpu").compress({"x": torch.ones(3)})


def test_decompress_group_rejects_mixed_settings():
    x = {"x": torch.from_numpy(np.random.default_rng(12).normal(
        size=(1, 8, 8, 4)).astype(np.float32))}
    a = ActivationCodec(mode="int8_zlib", quant_block=256, device="cpu").compress(x)
    b = ActivationCodec(mode="int8_delta_zlib", quant_block=256,
                        device="cpu").compress(x)
    with pytest.raises(ValueError, match="mixes codec settings"):
        ActivationCodec(quant_block=256, device="cpu").decompress_group([a, b])


def test_estimate_bytes_matches_reference():
    specs = [((64, 64, 16), "float32"), ((17, 25, 768), "float32")]
    for mode in ("raw", "zlib", "int8", "int8_zlib", "int8_delta_zlib"):
        for ratio in (None, 0.4):
            assert (ActivationCodec(mode=mode, device="cpu").estimate_bytes(
                specs, ratio) == JCodec(mode=mode).estimate_bytes(specs, ratio))
