"""The port's Swin-T in bf16 against the JAX package's bf16 Swin-T.

The JAX package draws a reduced Swin-T with ``dtype="bfloat16"``;
``repro_torch.bridge`` carries its bf16 weights across bit for bit
(``rel_bias`` randomised, and float32, as the JAX package keeps it).

(a) Module by module, each on one shared bf16 input, the port is held to
the JAX module run op by op (eagerly), where every operation rounds where
its source says.  There the two agree bit for bit on most elements; the
rest differ by a rounding flip that f32 sums in another order (oneDNN
against XLA:CPU) cause somewhere upstream.  A flip of one bf16 value moves
what is computed from it, and after a residual add whose terms cancel the
difference can be many ulps of the small result (24 were seen), so each
element is held to one bf16 ulp of its row's max |x| (a row: one pixel's
channels, the scale of the products and of the residual stream that made
it).  That bound alone would pass a wrong rounding point, so the share of
elements that differ at all (by more than 2^-8 of a bf16 ulp of their own
magnitude, above f32 sum-order noise) is bounded by SHARE.  Seen on four
seeds: at most 0.75%.  A GELU taken after rounding its input to bf16 moves
31-38% of a block's elements, and ``cls``, ``box`` or ``ctr`` rounded to
bf16 45-100% of theirs; SHARE = 3% fails both.

(b) The whole model is held to the JAX package's jitted functions
(``head_apply_jit``, ``tail_apply_jit``, ``forward_full_jit``).  XLA:CPU
fuses elementwise chains there and keeps their intermediates in f32 where
the source rounds to bf16 (excess precision), so the jitted model differs
from its own op-by-op run by bf16 noise that grows over the blocks: about
a third of the elements after one block, up to 1.2% of a leaf's max |x| at
the detections.  Each leaf is held within MODEL_TOL = 5e-2 of its max |x|;
a gather or layout error moves a leaf by the order of that max.

(c) Dtypes and byte accounting, (d) the codec on the JAX head's bf16
leaves (zero tolerance: the work is integer-exact), (e) B1's plain version
on bf16 qkv against the JAX op (one rounding of an f32 result on each side:
one bf16 ulp of the element), (f) the bridge.

This file runs in about 70 s alone on the CPU (the eager JAX modules and the
JAX package's interpret-mode legacy codec take most of it); each JAX head
and tail is traced once per split.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.swin_t_detection import reduced as jreduced
from repro.core.compression import ActivationCodec as JCodec
from repro.core.splitting import SwinSplitPlan as JPlan
from repro.kernels import ops as jops
from repro.models import swin as JSW
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.swin_t_detection import reduced
from repro_torch.core.compression import ActivationCodec
from repro_torch.core.splitting import SwinSplitPlan, split_option
from repro_torch.kernels import ops
from repro_torch.kernels import window_attention as wa
from repro_torch.models import swin as SW
from repro_torch.tree import tree_flatten

BF16 = "bfloat16"
SHARE = 0.03
MODEL_TOL = 5e-2
SPLITS = (1, 2, 3, 4)
QUANT_BLOCK = 8192          # the codec's default; every leaf pads its last block
CODEC_CASES = ([(m, False, "spatial") for m in ("raw", "zlib")]
               + [(m, fused, "spatial") for m in ("int8", "int8_zlib")
                  for fused in (True, False)]
               + [("int8_delta_zlib", False, "spatial")]
               + [("int8_delta_zlib", True, lay) for lay in ("spatial", "block")])


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(a):
    """A numpy leaf (float32 or ml_dtypes bfloat16) as a torch tensor."""
    a = np.asarray(a)
    if a.dtype.name == BF16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(x):
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy().tobytes()
    return np.asarray(x).tobytes()


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(reduced(), dtype=BF16)
    jcfg = dataclasses.replace(jreduced(), dtype=BF16)
    jparams = _np_tree(jax.jit(lambda key: JSW.init(jcfg, key))(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    for stage in jparams["stages"]:
        for bp in stage["blocks"]:
            bp["rel_bias"] = rng.normal(size=bp["rel_bias"].shape).astype(np.float32)
    img = rng.uniform(size=(2, cfg.img_h, cfg.img_w, 3)).astype(np.float32)
    return cfg, jcfg, jparams, params_from_numpy(jparams, "cpu"), img, {}


def _jax_head(model, split, ship_merged=True):
    """The JAX head's payload, traced once per split (ship_merged=False is
    the same payload without its "x")."""
    _, jcfg, jparams, _, img, cache = model
    if split not in cache:
        cache[split] = _np_tree(JSW.head_apply_jit(jcfg, split, True)(
            jparams, jnp.asarray(img)))
    payload = dict(cache[split])
    if not ship_merged and 0 < split < jcfg.n_stages:
        del payload["x"]
    return payload


def _ulp(m):
    """The bf16 spacing at magnitude m (8 significant bits)."""
    m = np.maximum(np.abs(m), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(m)) - 7)


def _module_gap(got, want):
    """(worst |got - want| in bf16 ulps of its row's max |x|, the share of
    elements more than 2^-8 of a bf16 ulp of their own magnitude apart)."""
    a = got.double().numpy()
    b = np.asarray(want).astype(np.float64)
    assert a.shape == b.shape
    d = np.abs(a - b)
    m = np.maximum(np.abs(a), np.abs(b))
    row = _ulp(m.max(-1, keepdims=True))
    return float((d / row).max()), float((d / _ulp(m) > 2.0 ** -8).mean())


def _assert_module_close(got, want, dtype=torch.bfloat16):
    assert got.dtype == dtype
    ulps, share = _module_gap(got, want)
    assert ulps <= 1.0, ulps
    assert share <= SHARE, share


def _bf16_input(shape, seed):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return (torch.from_numpy(x).to(torch.bfloat16),
            jnp.asarray(x).astype(jnp.bfloat16))


def _assert_model_close(port_tree, jax_tree):
    pl, _ = tree_flatten(port_tree)
    jl = jax.tree.leaves(jax_tree)
    assert len(pl) == len(jl)
    for a, b in zip(pl, jl):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).removeprefix("torch.") == b.dtype.name
        a, b = a.double().numpy(), b.astype(np.float64)
        assert np.isfinite(a).all()
        assert np.abs(a - b).max() <= MODEL_TOL * np.abs(b).max()


# -- (a) module by module -----------------------------------------------------

def test_patch_embed_matches_reference(model):
    cfg, jcfg, jparams, params, img, _ = model
    got = SW.patch_embed(cfg, params["patch_embed"], torch.from_numpy(img))
    want = JSW.patch_embed(jcfg, _jtree(jparams["patch_embed"]),
                           jnp.asarray(img))
    assert want.dtype == jnp.bfloat16
    _assert_module_close(got, want)


# (stage, H = W, shift): unshifted, shifted, and unshifted at a size the
# window does not divide (the pad-strip mask)
BLOCK_CASES = [(0, 14, 0), (0, 14, 3), (0, 12, 0), (2, 4, 3)]


@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
@pytest.mark.parametrize("stage,H,shift", BLOCK_CASES)
def test_swin_block_matches_reference(model, stage, H, shift, attn_impl):
    cfg, jcfg, jparams, params, _, _ = model
    cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    jcfg = dataclasses.replace(jcfg, attn_impl=attn_impl)
    nh, C = cfg.num_heads[stage], cfg.stage_dim(stage)
    x, jx = _bf16_input((2, H, H, C), 10 * stage + H + shift)
    want = JSW.swin_block(jcfg, _jtree(jparams["stages"][stage]["blocks"][0]),
                          jx, H, H, nh, shift)
    got = SW.swin_block(cfg, params["stages"][stage]["blocks"][0], x, H, H,
                        nh, shift)
    _assert_module_close(got, want)


def test_patch_merge_matches_reference(model):
    cfg, jcfg, jparams, params, _, _ = model
    x, jx = _bf16_input((2, 7, 9, cfg.embed_dim), 3)
    want = JSW.patch_merge(jcfg, _jtree(jparams["stages"][0]["merge"]), jx)
    got = SW.patch_merge(cfg, params["stages"][0]["merge"], x)
    assert tuple(got.shape) == (2, 4, 5, 2 * cfg.embed_dim)
    _assert_module_close(got, want)


def test_detection_head_matches_reference(model):
    """The FPN and the head's convs in bf16; cls, box and ctr in f32."""
    cfg, jcfg, jparams, params, _, _ = model
    feats = [_bf16_input((2, *cfg.stage_hw(s), cfg.stage_dim(s)), 20 + s)
             for s in range(cfg.n_stages)]
    got = SW.detection_head(cfg, params, [f[0] for f in feats])
    want = JSW.detection_head(jcfg, _jtree(jparams), [f[1] for f in feats])
    for key in ("cls", "box", "ctr"):
        assert all(lv[key].dtype == jnp.float32 for lv in want)
        _assert_module_close(torch.cat([lv[key].reshape(-1) for lv in got])[None],
                             np.concatenate([np.asarray(lv[key]).reshape(-1)
                                             for lv in want])[None],
                             torch.float32)


# -- (b) the whole model ------------------------------------------------------

@pytest.mark.parametrize("ship_merged", [True, False])
@pytest.mark.parametrize("split", SPLITS)
def test_head_apply_matches_reference(model, split, ship_merged):
    cfg, _, _, params, img, _ = model
    got = SW.head_apply(cfg, params, torch.from_numpy(img), split,
                        ship_merged=ship_merged)
    _assert_model_close(got, _jax_head(model, split, ship_merged))


@pytest.mark.parametrize("ship_merged", [True, False])
@pytest.mark.parametrize("split", SPLITS)
def test_tail_apply_matches_reference(model, split, ship_merged):
    """Both tails take the JAX head's bf16 payload; without the merged
    tensor the port's tail recomputes the merge."""
    cfg, jcfg, jparams, params, _, cache = model
    key = ("tail", split)
    if key not in cache:
        cache[key] = _np_tree(JSW.tail_apply_jit(jcfg, split)(
            jparams, _jax_head(model, split)))
    payload = jax.tree.map(_to_torch, _jax_head(model, split, ship_merged))
    _assert_model_close(SW.tail_apply(cfg, params, payload, split), cache[key])


def test_forward_full_matches_reference(model):
    cfg, jcfg, jparams, params, img, _ = model
    want = JSW.forward_full_jit(jcfg)(jparams, jnp.asarray(img))
    got = SW.forward_full(cfg, params, torch.from_numpy(img))
    _assert_model_close(got, want)


# -- (c) dtypes and accounting -----------------------------------------------

@pytest.mark.parametrize("ship_merged", [True, False])
def test_split_plan_dtypes_and_bytes_match_reference(model, ship_merged):
    """Every payload leaf is bf16, the detections f32 (the zero-padded
    batched tail too); payload specs and raw bytes are the JAX plan's, and
    the server-only image stays f32."""
    cfg, jcfg, jparams, params, img, _ = model
    plan = SwinSplitPlan(cfg, params, ship_merged=ship_merged,
                         include_early_split=True, device="cpu")
    jplan = JPlan(jcfg, jparams, ship_merged=ship_merged,
                  include_early_split=True)
    assert plan.options == jplan.options
    for opt in plan.options:
        assert plan.payload_specs(opt) == jplan.payload_specs(opt)
        assert plan.raw_payload_bytes(opt, 3) == jplan.raw_payload_bytes(opt, 3)
    payload, _ = plan.head(img[:1], split_option(1))
    leaves, _ = tree_flatten(payload)
    assert leaves and all(x.dtype == torch.bfloat16 for x in leaves)
    assert sum(x.numel() * x.element_size() for x in leaves) == \
        plan.raw_payload_bytes(split_option(1))
    outs = plan.tail_batched([payload, payload], split_option(1), pad_to=4)
    assert len(outs) == 2
    for out in outs:
        for lv in out:
            assert all(lv[k].dtype == torch.float32 and lv[k].shape[0] == 1
                       for k in ("cls", "box", "ctr"))
    server, _ = plan.head(img[:1], "server_only")
    assert server["img"].dtype == torch.float32


# -- (d) the codec on the JAX head's bf16 leaves ------------------------------

@pytest.mark.parametrize("mode,fused,layout", CODEC_CASES)
def test_codec_on_bf16_payloads_is_byte_identical(model, mode, fused, layout):
    """At every split, compress_head on the same bf16 leaves puts the same
    blobs, scale bits and metas on the wire on both sides, and each side
    decodes the other's payload to the same bits."""
    tc = ActivationCodec(mode=mode, quant_block=QUANT_BLOCK, fused=fused,
                         delta_layout=layout, device="cpu")
    jc = JCodec(mode=mode, quant_block=QUANT_BLOCK, fused=fused,
                delta_layout=layout)
    cache = model[-1]
    for split in SPLITS:
        key = ("producers", split)
        if key not in cache:       # one stable producer a split on each side
            jtree = _jtree(_jax_head(model, split))
            ttree = jax.tree.map(_to_torch, _jax_head(model, split))
            cache[key] = (jax.jit(lambda p, x, t=jtree: t), jtree,
                          lambda p, x, t=ttree: t)
        jproducer, jtree, tproducer = cache[key]
        jp, _ = jc.compress_head(jproducer, None, None)
        tp, _ = tc.compress_head(tproducer, None, None)
        assert tp.blobs == jp.blobs
        assert [a.tobytes() for a in tp.scales] == [
            np.asarray(b).tobytes() for b in jp.scales]
        assert ([dataclasses.astuple(m) for m in tp.meta]
                == [dataclasses.astuple(m) for m in jp.meta])
        assert all(m.dtype == BF16 for m in tp.meta)
        assert (tp.raw_bytes, tp.fused) == (jp.raw_bytes, jp.fused)
        # the wire is the same, so one decode each way: the port's of the
        # JAX payload, the JAX package's of the port's
        jp_of_port = dataclasses.replace(tp, treedef=jax.tree.structure(jtree))
        ol, _ = tree_flatten(tc.decompress(jp))
        tl = jax.tree.leaves(jc.decompress(jp_of_port))
        assert len(ol) == len(tl)
        for a, b in zip(ol, tl):
            assert a.dtype == torch.bfloat16 and _bits(a) == _bits(b)


# -- (e) B1's plain version on bf16 qkv ---------------------------------------

@pytest.mark.parametrize("Hp,Wp,shift,masked,nh,hd", [
    (14, 21, 0, True, 2, 16), (14, 14, 3, True, 2, 32)])
def test_fused_window_attention_plain_on_bf16(Hp, Wp, shift, masked, nh, hd):
    """f32 inside and one rounding at the end on both sides: each element
    within one bf16 ulp of its own magnitude of the JAX op's, and the share
    that differ at all under SHARE."""
    rng = np.random.default_rng(Hp + shift + hd)
    window, C = 7, nh * hd
    qkv = rng.normal(size=(2, Hp, Wp, 3 * C)).astype(np.float32)
    bias = rng.normal(size=(nh, 49, 49)).astype(np.float32)
    mask = None
    if shift:
        mask = SW.shift_attn_mask(Hp, Wp, window, shift)
    elif masked:
        mask = SW.pad_region_mask(Hp, Wp, Hp - 3, Wp - 2, window)
    kw = dict(window=window, shift=shift, n_heads=nh)
    tq = torch.from_numpy(qkv).to(torch.bfloat16)
    got = wa.fused_window_attention_plain(
        tq, torch.from_numpy(bias), None if mask is None else torch.from_numpy(mask),
        **kw)
    want = np.asarray(jops.fused_window_attention(
        jnp.asarray(qkv).astype(jnp.bfloat16), jnp.asarray(bias),
        None if mask is None else jnp.asarray(mask), **kw))
    assert got.dtype == torch.bfloat16 and want.dtype.name == BF16
    a, b = got.double().numpy(), want.astype(np.float64)
    d = np.abs(a - b)
    assert (d <= _ulp(np.maximum(np.abs(a), np.abs(b)))).all()
    assert (d > 0).mean() <= SHARE
    # the kernel's route on the meta device gives the same dtype
    meta = ops.fused_window_attention(tq.to("meta"), torch.from_numpy(bias).to("meta"),
                                      None, **kw)
    assert meta.dtype == torch.bfloat16 and meta.shape == got.shape


# -- (f) the bridge -----------------------------------------------------------

def test_bridge_keeps_bf16_and_f32_trees_bitwise(model):
    """A bf16 tree keeps bf16 (rel_bias f32) bit for bit, conv weights
    turned OIHW; an f32 tree comes out f32 and bit for bit as before."""
    _, _, jparams, params, _, _ = model
    flat, _ = tree_flatten(params)
    jflat = jax.tree.leaves(jparams)
    for a, b in zip(flat, jflat):
        want = _to_torch(b)
        if want.dim() == 4:
            want = want.permute(3, 2, 0, 1)
        assert a.dtype == want.dtype and _bits(a) == _bits(want.contiguous())
    assert params["stages"][0]["blocks"][0]["rel_bias"].dtype == torch.float32
    assert params["stages"][0]["blocks"][0]["qkv_w"].dtype == torch.bfloat16
    f32 = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    for a, b in zip(tree_flatten(params_from_numpy(f32, "cpu"))[0],
                    jax.tree.leaves(f32)):
        want = torch.from_numpy(np.array(b, dtype=np.float32))
        if want.dim() == 4:
            want = want.permute(3, 2, 0, 1).contiguous()
        assert a.dtype == torch.float32 and torch.equal(a, want)


def test_port_init_follows_the_config_dtype():
    """The port's own init draws in f32 and casts to bf16, rel_bias kept
    f32: the same values as the f32 draw, rounded once."""
    cfg = dataclasses.replace(reduced(), dtype=BF16)
    p16 = SW.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    p32 = SW.init(reduced(), torch.Generator().manual_seed(0), device="cpu")
    for stage in p16["stages"]:
        for bp in stage["blocks"]:
            assert bp["rel_bias"].dtype == torch.float32
    l16, t16 = tree_flatten(p16)
    l32, t32 = tree_flatten(p32)
    assert t16 == t32
    for a, b in zip(l16, l32):
        assert torch.equal(a, b if a.dtype == torch.float32
                           else b.to(torch.bfloat16))
    assert sum(a.dtype == torch.bfloat16 for a in l16) == len(l16) - sum(
        cfg.depths)
