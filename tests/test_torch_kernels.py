"""The port's kernel modules against the JAX package's TPU kernels.

On the CPU the port's ops run the plain PyTorch versions of its CUDA kernels;
here they are held against the Pallas kernels run in interpret mode and
against the JAX package's oracles (``repro.kernels.ref``), on the same numpy
inputs.  Window attention is float work: both sides are fp32 and sum in
different orders, so it is held at 2e-5 (the tolerance the JAX package's own
kernel-vs-oracle tests use); bf16 outputs within one bf16 step of it.  The codec pair is integer-exact and is held
bitwise: stream bytes and scale bits.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import codec as jcodec
from repro.kernels import ops as jops
from repro.kernels import ref
from repro.kernels import window_attention as jwa
from repro.models.swin import pad_region_mask, shift_attn_mask
from repro_torch.kernels import _build
from repro_torch.kernels import codec as tcodec
from repro_torch.kernels import window_attention as twa
from repro_torch.kernels import ops
from test_torch_window_tc import _b1_mirror, _b7_mirror, _tf32

ATOL = RTOL = 2e-5

# the oracle jitted once per geometry: eager dispatch op by op is slower
# than the interpret-mode kernel
_oracle = jax.jit(ref.fused_window_attention_ref,
                  static_argnames=("window", "shift", "n_heads"))

# the shapes of tests/test_kernels.py::FUSED_CASES
FUSED_CASES = [
    # B, Hp, Wp, window, shift, nh, hd
    (1, 14, 14, 7, 0, 3, 16),    # two bands, no shift
    (2, 14, 14, 7, 3, 3, 16),    # shifted: windows wrap across the map edge
    (1, 14, 21, 7, 3, 2, 32),    # non-square, w2 = 49
    (1, 7, 14, 7, 3, 2, 16),     # nwh = 1: the rolled band wraps onto itself
    (2, 8, 12, 4, 2, 2, 16),     # small window
    (1, 16, 16, 8, 4, 2, 16),    # w2 = 64
    (1, 18, 18, 9, 4, 2, 16),    # w2 = 81
]


def _case(B, Hp, Wp, window, shift, nh, hd, seed=10):
    rng = np.random.default_rng(seed)
    C = nh * hd
    w2 = window * window
    qkv = rng.normal(size=(B, Hp, Wp, 3 * C)).astype(np.float32)
    bias = rng.normal(size=(nh, w2, w2)).astype(np.float32)
    mask = shift_attn_mask(Hp, Wp, window, shift) if shift else None
    return qkv, bias, mask


def _jax_kernel(qkv, bias, mask, *, window, shift, nh):
    Hp, Wp = qkv.shape[1:3]
    bias_p, mask_p = jops._pad_fused_inputs(
        jnp.asarray(bias), None if mask is None else jnp.asarray(mask),
        window=window, nwh=Hp // window, nww=Wp // window)
    return np.asarray(jwa.fused_window_attention_pallas(
        jnp.asarray(qkv), bias_p, mask_p, window=window, shift=shift,
        n_heads=nh, interpret=True))


def _port(qkv, bias, mask, *, window, shift, nh):
    out = ops.fused_window_attention(
        torch.from_numpy(qkv), torch.from_numpy(bias),
        None if mask is None else torch.from_numpy(mask),
        window=window, shift=shift, n_heads=nh)
    return out.numpy()


@pytest.mark.parametrize("B,Hp,Wp,window,shift,nh,hd", FUSED_CASES)
def test_window_attention_plain_matches_pallas_kernel(B, Hp, Wp, window,
                                                      shift, nh, hd):
    qkv, bias, mask = _case(B, Hp, Wp, window, shift, nh, hd)
    out = _port(qkv, bias, mask, window=window, shift=shift, nh=nh)
    assert out.shape == (B, Hp, Wp, nh * hd)
    kern = _jax_kernel(qkv, bias, mask, window=window, shift=shift, nh=nh)
    np.testing.assert_allclose(out, kern, rtol=RTOL, atol=ATOL)
    oracle = np.asarray(_oracle(
        jnp.asarray(qkv), jnp.asarray(bias),
        None if mask is None else jnp.asarray(mask),
        window=window, shift=shift, n_heads=nh))
    np.testing.assert_allclose(out, oracle, rtol=RTOL, atol=ATOL)


def test_window_attention_plain_pad_region_mask():
    """The pad-strip mask of a map that is not a window multiple: the mask is
    indexed by plain window and padded tokens stay isolated."""
    H, W, window, nh, hd = 10, 12, 7, 2, 16
    Hp, Wp = 14, 14
    qkv, bias, _ = _case(1, Hp, Wp, window, 0, nh, hd, seed=11)
    qkv[:, H:] = 0.0                      # swin_block zero-pads the strip
    qkv[:, :, W:] = 0.0
    mask = pad_region_mask(Hp, Wp, H, W, window)
    out = _port(qkv, bias, mask, window=window, shift=0, nh=nh)
    kern = _jax_kernel(qkv, bias, mask, window=window, shift=0, nh=nh)
    np.testing.assert_allclose(out[:, :H, :W], kern[:, :H, :W],
                               rtol=RTOL, atol=ATOL)
    oracle = np.asarray(_oracle(
        jnp.asarray(qkv), jnp.asarray(bias), jnp.asarray(mask), window=window,
        shift=0, n_heads=nh))
    np.testing.assert_allclose(out[:, :H, :W], oracle[:, :H, :W],
                               rtol=RTOL, atol=ATOL)


def _codec_input(block, seed=7):
    """Five blocks: scaled normals, an all-zero block (scale 1.0), a block
    holding exact half-steps of its own grid (round half to even), and a
    block with a single nonzero value."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(5, block)) * 9).astype(np.float32)
    x[1] = 0.0
    x[2] = (np.arange(block) % 9 - 4).astype(np.float32) * 0.5 + 0.25
    x[2, 0] = 127.0
    x[3] = 0.0
    x[3, block // 2] = -3.0
    return x.reshape(-1)


@pytest.mark.parametrize("block", [256, 1024, 8192])
@pytest.mark.parametrize("delta", [False, True])
def test_codec_plain_matches_pallas_bitwise(block, delta):
    x = _codec_input(block)
    js, jsc = jcodec.codec_encode_pallas(jnp.asarray(x), block=block,
                                         delta=delta, interpret=True)
    ts, tsc = ops.codec_encode(torch.from_numpy(x), block=block, delta=delta)
    assert ts.dtype == (torch.uint8 if delta else torch.int8)
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    assert tsc.numpy().tobytes() == np.asarray(jsc).tobytes()
    jo = jcodec.codec_decode_pallas(js, jsc, block=block, delta=delta,
                                    interpret=True)
    to = ops.codec_decode(ts, tsc, block=block, delta=delta)
    assert to.numpy().tobytes() == np.asarray(jo).tobytes()
    # and the JAX package's oracles agree with both
    rs, rsc = ref.codec_encode_ref(jnp.asarray(x), block, delta)
    assert ts.numpy().tobytes() == np.asarray(rs).tobytes()
    assert tsc.numpy().tobytes() == np.asarray(rsc).tobytes()


def test_codec_plain_rejects_unaligned_streams():
    with pytest.raises(ValueError, match="128-lane"):
        ops.codec_encode(torch.zeros(1000), block=1000)
    with pytest.raises(ValueError, match="block-aligned"):
        ops.codec_encode(torch.zeros(300), block=256)


def test_dispatch_goes_by_device_and_raises_off_cpu_and_cuda():
    """The wrapper picks the plain version because the tensor lies on the
    CPU; on the meta device it returns empty outputs of the kernel's shapes
    and dtypes and runs nothing (no launch, no plain version); a tensor on
    any other device is refused, never run on the CPU."""
    before = dict(ops.LAUNCHES)
    stream, scales = ops.codec_encode(torch.zeros(256, device="meta"),
                                      block=256, delta=True)
    assert (stream.device.type, stream.dtype, tuple(stream.shape)) == (
        "meta", torch.uint8, (256,))
    assert scales.device.type == "meta" and tuple(scales.shape) == (1,)
    out = ops.fused_window_attention(torch.zeros((1, 7, 7, 48), device="meta"),
                                     torch.zeros((1, 49, 49)), window=7,
                                     shift=0, n_heads=1)
    assert out.device.type == "meta" and tuple(out.shape) == (1, 7, 7, 16)
    assert dict(ops.LAUNCHES) == before
    elsewhere = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="no kernel"):
        _build.route(elsewhere)


def test_cuda_wrappers_refuse_cpu_tensors():
    """A CUDA wrapper never takes a CPU tensor (and so never runs the plain
    version in the kernel's place)."""
    with pytest.raises(ValueError, match="CUDA device"):
        tcodec.codec_encode_cuda(torch.zeros(256), 256, False)
    with pytest.raises(ValueError, match="CUDA device"):
        tcodec.codec_decode_cuda(torch.zeros(256, dtype=torch.int8),
                                 torch.ones(1), 256, False)


# -- per-window attention on pre-partitioned windows (B7) ---------------------

def _windows(nB, w2, nh, hd, masked, seed=5):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(nB, w2, nh, hd)).astype(np.float32)
               for _ in range(3))
    bias = rng.normal(size=(nh, w2, w2)).astype(np.float32)
    mask = None
    if masked:
        mask = (rng.random((nB, w2, w2)) < 0.7) | np.eye(w2, dtype=bool)[None]
    return q, k, v, bias, mask


def _windows_port(q, k, v, bias, mask, dtype=torch.float32):
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    return ops.window_attention(*t, torch.from_numpy(bias),
                                None if mask is None else torch.from_numpy(mask))


def _windows_jax(q, k, v, bias, mask, dtype=jnp.float32):
    """The JAX package's op: pads w2 to a multiple of 64 and runs the Pallas
    kernel in interpret mode on the CPU."""
    return np.asarray(jops.window_attention(
        *(jnp.asarray(x, dtype) for x in (q, k, v)), jnp.asarray(bias),
        None if mask is None else jnp.asarray(mask)).astype(jnp.float32))


# the shapes of tests/test_kernels.py's window-attention cases
@pytest.mark.parametrize("w2,nh,hd,masked", [
    (49, 3, 32, True), (49, 6, 32, True), (64, 4, 64, True),
    (49, 3, 32, False), (81, 2, 32, False)])
def test_windows_plain_matches_pallas_kernel(w2, nh, hd, masked):
    q, k, v, bias, mask = _windows(5 if masked else 2, w2, nh, hd, masked)
    out = _windows_port(q, k, v, bias, mask)
    assert out.shape == q.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), _windows_jax(q, k, v, bias, mask),
                               rtol=RTOL, atol=ATOL)
    # every row may attend to something, so the padded keys weigh nothing
    # and the unpadded oracle agrees too
    oracle = ref.window_attention_ref(
        *(jnp.asarray(x) for x in (q, k, v, bias)),
        None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(oracle), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("w2", [49, 81])
def test_window_attention_fully_masked_row_averages_over_padded_keys(w2):
    """A query row with no allowed key: the TPU op scores all W2P padded
    keys at -1e9 and returns sum(v) / W2P; the port reproduces it without
    padding.  The unpadded oracle gives sum(v) / w2 there."""
    q, k, v, bias, mask = _windows(3, w2, 2, 32, True, seed=6)
    mask[1, 4] = False
    mask[2, w2 - 1] = False
    out = _windows_port(q, k, v, bias, mask).numpy()
    np.testing.assert_allclose(out, _windows_jax(q, k, v, bias, mask),
                               rtol=RTOL, atol=ATOL)
    w2p = -(-w2 // 64) * 64
    for n, row in ((1, 4), (2, w2 - 1)):
        np.testing.assert_allclose(out[n, row], v[n].sum(0) / w2p,
                                   rtol=RTOL, atol=ATOL)
    oracle = np.asarray(ref.window_attention_ref(
        *(jnp.asarray(x) for x in (q, k, v, bias)), jnp.asarray(mask)))
    np.testing.assert_allclose(oracle[1, 4], v[1].sum(0) / w2, rtol=RTOL,
                               atol=ATOL)
    assert np.abs(out[1, 4] - oracle[1, 4]).max() > 1e-3


def test_window_attention_bf16_runs_in_f32_and_rounds_once():
    """bf16 q, k, v: f32 inside and one rounding of the output, so the bf16
    result is the f32 result on the upcast inputs, rounded; against the
    JAX op (the same sums in another order) within one bf16 step, up to
    2^-7 of the value at the bottom of a binade."""
    q, k, v, bias, mask = _windows(4, 49, 3, 32, True, seed=7)
    out = _windows_port(q, k, v, bias, mask, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    up = [torch.from_numpy(x).to(torch.bfloat16).float().numpy()
          for x in (q, k, v)]
    f32 = _windows_port(*up, bias, mask)
    assert torch.equal(out, f32.to(torch.bfloat16))
    np.testing.assert_allclose(out.float().numpy(),
                               _windows_jax(q, k, v, bias, mask, jnp.bfloat16),
                               rtol=2.0 ** -7, atol=ATOL)


def test_window_attention_refuses_what_the_kernel_does_not_take():
    q, k, v, bias, _ = _windows(1, 49, 2, 32, False)
    t = [torch.from_numpy(x) for x in (q, k, v, bias)]
    with pytest.raises(ValueError, match="CUDA device"):
        twa.window_attention_cuda(*t)
    out = ops.window_attention(*(x.to("meta") for x in t[:3]), t[3])
    assert out.device.type == "meta" and out.shape == t[0].shape
    for shape in ((1, 145, 2, 32), (1, 49, 2, 48)):
        x = torch.zeros(shape)
        with pytest.raises(ValueError, match="w2"):
            ops.window_attention(x, x, x, torch.zeros(shape[2], shape[1],
                                                      shape[1]))
    with pytest.raises(TypeError, match="dtype"):
        ops.window_attention(t[0].half(), t[1].half(), t[2].half(), t[3])


# -- the tensor-core body of B1 and B7, mirrored on the CPU --------------------
#
# tests/test_torch_window_tc.py holds a mirror of csrc/window_attention.cu's
# body (mma.sync m16n8k8 TF32 as 3xTF32: cvt.rna hi/lo splits, the three
# products of each k8 step in the kernel's order, the padding rules, B7's
# pad_keys term).  The mirror documents the arithmetic and checks nothing of
# the kernel here; its card-only cases hold the kernel against it.  Below it
# is held against the Pallas kernels at the file's 2e-5, and one TF32 product
# instead misses by more than 1e-4, which is why the kernel pays for three.

TF32_MISS = 1e-4


def test_tf32_rounding_is_to_nearest_ties_away():
    """The mirror's cvt.rna: 10 mantissa bits kept, halfway cases away from
    zero in both signs, and hi + lo within 2^-22 of x."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 3.0], dtype=torch.float32)
    assert _tf32(x).tolist() == [one + ulp, -(one + ulp), one, one + ulp, 3.0]
    r = torch.from_numpy(np.random.default_rng(0).normal(size=4096)
                         .astype(np.float32))
    hi = _tf32(r)
    lo = _tf32(r - hi)
    assert float(((hi + lo - r).abs() / r.abs()).max()) <= 2.0 ** -22


@pytest.mark.parametrize("B,Hp,Wp,window,shift,nh,hd", FUSED_CASES)
def test_b1_tensor_core_body_matches_pallas_kernel(B, Hp, Wp, window, shift,
                                                   nh, hd):
    qkv, bias, mask = _case(B, Hp, Wp, window, shift, nh, hd)
    out = _b1_mirror(qkv, bias, mask, window=window, shift=shift, nh=nh)
    kern = _jax_kernel(qkv, bias, mask, window=window, shift=shift, nh=nh)
    np.testing.assert_allclose(out, kern, rtol=RTOL, atol=ATOL)


# bf16 B1 (as chip_smoke.py holds it): each head's output row within 1e-2
# of its max |x|
BF16_TOL = 1e-2


@pytest.mark.parametrize("B,Hp,Wp,window,shift,nh,hd", FUSED_CASES)
def test_b1_bf16_tensor_core_body_matches_pallas_kernel(B, Hp, Wp, window,
                                                        shift, nh, hd):
    """B1's bf16 arithmetic as the kernel routes it (the wgmma body's
    unscaled q k^T, its scale afterwards and P_hi.V + P_lo.V for windows up
    to 8; the f32 body rounded once for 9-12) against the Pallas kernel on
    the same bf16 qkv, each head's row within BF16_TOL of its max."""
    qkv, bias, mask = _case(B, Hp, Wp, window, shift, nh, hd)
    out = _b1_mirror(qkv, bias, mask, window=window, shift=shift, nh=nh,
                     dtype="bfloat16")
    kern = _jax_kernel(np.asarray(jnp.asarray(qkv, jnp.bfloat16)), bias, mask,
                       window=window, shift=shift, nh=nh)
    rows = lambda x: np.asarray(x, np.float32).reshape(B, Hp, Wp, nh, hd)
    d = np.abs(rows(out) - rows(kern)).max(-1)
    assert (d <= BF16_TOL * np.abs(rows(kern)).max(-1)).all()


@pytest.mark.parametrize("w2,nh,hd,masked", [
    (49, 3, 32, True), (49, 6, 32, True), (64, 4, 64, True),
    (49, 3, 32, False), (81, 2, 32, False)])
def test_b7_tensor_core_body_matches_pallas_kernel(w2, nh, hd, masked):
    q, k, v, bias, mask = _windows(5 if masked else 2, w2, nh, hd, masked)
    np.testing.assert_allclose(_b7_mirror(q, k, v, bias, mask),
                               _windows_jax(q, k, v, bias, mask),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("w2", [49, 81])
def test_b7_tensor_core_body_fully_masked_rows(w2):
    """Rows with no allowed key: the tile's own padded keys (-inf) add
    nothing, and the op's padded keys give sum(v) / W2P."""
    q, k, v, bias, mask = _windows(3, w2, 2, 32, True, seed=6)
    mask[1, 4] = False
    mask[2, w2 - 1] = False
    mask[2, 0] = False
    out = _b7_mirror(q, k, v, bias, mask)
    np.testing.assert_allclose(out, _windows_jax(q, k, v, bias, mask),
                               rtol=RTOL, atol=ATOL)
    w2p = -(-w2 // 64) * 64
    for n, row in ((1, 4), (2, w2 - 1), (2, 0)):
        np.testing.assert_allclose(out[n, row], v[n].sum(0) / w2p, rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("kernel", ["B1", "B7"])
def test_one_tf32_product_misses_where_three_do_not(kernel):
    """The witness for the 3x split: the same body with hi.hi alone misses
    the Pallas kernel by more than 1e-4."""
    if kernel == "B1":
        args = _case(*FUSED_CASES[2])
        kw = dict(window=7, shift=3, nh=2)
        exp = _jax_kernel(*args, **kw)
        three = _b1_mirror(*args, **kw)
        one = _b1_mirror(*args, **kw, products=1)
    else:
        args = _windows(5, 49, 3, 32, True)
        exp = _windows_jax(*args)
        three, one = _b7_mirror(*args), _b7_mirror(*args, products=1)
    np.testing.assert_allclose(three, exp, rtol=RTOL, atol=ATOL)
    assert np.abs(one - exp).max() > TF32_MISS
