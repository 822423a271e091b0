"""The port's activation codec against the JAX package's.

For identical numpy leaves the two codecs must put the same bytes on the
wire: the same zlib blobs, the same f32 scale bits and the same per-leaf
metas, across every mode, the fused and the legacy per-tensor encoders, both
delta layouts and the three encode entry points (``compress``,
``compress_group``, ``compress_head``), over float32 and bfloat16 leaves that
need block padding, a scalar, an empty leaf and batches on both sides of the
delta-axis switch.  Each side decodes the other's payloads to the same bits,
and the legacy and fused decodes of one tree are bitwise equal.  The
tolerance is zero throughout: the work is integer-exact.
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
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


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


def _port(tree, dtype="f32"):
    return {k: torch.from_numpy(v.copy()).to(DTYPES[dtype][0])
            for k, v in tree.items()}


def _jax(tree, dtype="f32"):
    return {k: jnp.asarray(v).astype(DTYPES[dtype][1]) for k, v in tree.items()}


def _bits(t: torch.Tensor) -> bytes:
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.contiguous().numpy().tobytes()


def _codecs(mode, layout, fused=True):
    return (ActivationCodec(mode=mode, quant_block=BLOCK, delta_layout=layout,
                            fused=fused, device="cpu"),
            JCodec(mode=mode, quant_block=BLOCK, delta_layout=layout,
                   fused=fused))


def _assert_same_wire(tp, jp):
    assert tp.blobs == jp.blobs
    assert len(tp.scales) == len(jp.scales) == (1 if jp.fused else len(jp.meta))
    for a, b in zip(tp.scales, jp.scales):
        assert a.dtype == np.float32
        assert a.tobytes() == np.asarray(b).tobytes()
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
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and _bits(a) == _bits(b)
            continue
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
        assert _bits(a) == np.asarray(b).tobytes()


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


# every mode x encoder x layout the codec has; raw/zlib never quantise, so
# their fused flag and layout change nothing and they run once per dtype
WIRE_CASES = ([(m, False, "spatial") for m in ("raw", "zlib")]
              + [(m, fused, "spatial") for m in ("int8", "int8_zlib")
                 for fused in (True, False)]
              + [("int8_delta_zlib", False, "spatial")]
              + [("int8_delta_zlib", True, lay) for lay in LAYOUTS])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode,fused,layout", WIRE_CASES)
def test_every_mode_is_byte_identical_and_cross_decodes(mode, fused, layout,
                                                        dtype):
    tree = _tree()
    tc, jc = _codecs(mode, layout, fused)
    tp = tc.compress(_port(tree, dtype))
    jp = jc.compress(_jax(tree, dtype))
    assert tp.fused == (fused and mode in MODES)
    _assert_same_wire(tp, jp)
    _cross_decode(tc, jc, tp, jp, _jax(tree, dtype))
    if mode in ("raw", "zlib"):                 # lossless: the input bits
        _assert_same_leaves(tc.decompress(tp), _jax(tree, dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", MODES)
def test_legacy_and_fused_decode_to_the_same_bits(mode, dtype):
    """The reference's claim (core/compression.py, module note): whichever
    encoder wrote the payload, the decoded tensors are bit-identical."""
    tree = _port(_tree(), dtype)
    legacy = ActivationCodec(mode=mode, quant_block=BLOCK, fused=False,
                             device="cpu")
    out_l = legacy.decompress(legacy.compress(tree))
    for layout in LAYOUTS:
        fused = ActivationCodec(mode=mode, quant_block=BLOCK,
                                delta_layout=layout, device="cpu")
        out_f = fused.decompress(fused.compress(tree))
        # either codec decodes either payload: decode follows the payload
        out_x = legacy.decompress(fused.compress(tree))
        for key in tree:
            assert out_l[key].dtype == out_f[key].dtype == tree[key].dtype
            assert _bits(out_l[key]) == _bits(out_f[key]) == _bits(out_x[key])


@pytest.mark.parametrize("mode", ["raw", "zlib"] + MODES)
def test_mode_none_payloads_take_the_decoders_mode(mode):
    """A payload with ``mode=None`` (and, in delta mode, no recorded delta
    axis: the old rule picks it) decodes with the receiving codec's mode,
    to the same bits as the JAX package's decoder."""
    tree = _jax(_tree())
    jp = JCodec(mode=mode, quant_block=BLOCK, fused=False).compress(tree)
    old = dataclasses.replace(
        jp, mode=None,
        meta=[dataclasses.replace(m, delta_axis=None) for m in jp.meta])
    tc, jc = _codecs(mode, "spatial", fused=False)
    _assert_same_leaves(tc.decompress(old), jc.decompress(old))
    _assert_same_leaves(tc.decompress(old), jc.decompress(jp))


@pytest.mark.parametrize("mode", ["zlib", "int8_zlib", "int8_delta_zlib"])
def test_legacy_entry_points_fall_back_per_payload(mode):
    """compress_head, compress_group and decompress_group fall back to the
    per-payload path where the codec does not fuse, byte-identical to the
    JAX package's fallbacks; decompress_group decodes a group that mixes
    fused and legacy payloads one by one."""
    trees = [_tree(seed) for seed in (3, 4)]
    tc, jc = _codecs(mode, "spatial", fused=False)
    assert not tc.supports_fused() and not jc.supports_fused()
    tps = tc.compress_group([_port(t) for t in trees])
    jps = jc.compress_group([_jax(t) for t in trees])
    for tp, jp in zip(tps, jps):
        assert not tp.fused
        _assert_same_wire(tp, jp)

    img = np.random.default_rng(9).normal(size=(1, 9, 10, 5)).astype(np.float32)
    tp, ttree = tc.compress_head(lambda p, x: {"x": x * p}, torch.tensor(2.0),
                                 torch.from_numpy(img))
    jp, jtree = jc.compress_head(jax.jit(lambda p, x: {"x": x * p}),
                                 jnp.float32(2.0), jnp.asarray(img))
    _assert_same_leaves(ttree, jtree)
    _assert_same_wire(tp, jp)

    mixed = [tps[0], ActivationCodec(quant_block=BLOCK, device="cpu").compress(
        _port(trees[1])), jps[1]]
    for out, p in zip(tc.decompress_group(mixed), mixed):
        _assert_same_leaves(out, tc.decompress(p))
    for out, jp in zip(tc.decompress_group(jps), jps):
        _assert_same_leaves(out, jc.decompress(jp))
    with pytest.raises(ValueError, match="multiple of 128"):
        ActivationCodec(quant_block=1000, fused=False,
                        device="cpu").compress({"x": torch.ones(3)})


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
