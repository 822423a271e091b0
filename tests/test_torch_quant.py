"""The port's per-tensor int8 quant pair against the JAX package's TPU kernel.

On the CPU ``repro_torch.kernels.ops.quantize`` / ``dequantize`` run the
plain PyTorch versions of the CUDA kernels in ``csrc/quant.cu``.  Here they
are held against ``repro.kernels.quant.quant_pallas`` / ``dequant_pallas``
in interpret mode and against ``repro.kernels.ops.quantize`` /
``dequantize``, on the same numpy inputs, over the leaves of
``tests/test_codec_fused.py`` (block padding, a scalar, an empty leaf) in
float32 and bfloat16 at three block sizes.  The work is integer-exact, so
the tolerance is zero: the int8 bytes, the scale bits, ``n`` and the bits of
the decoded values must all be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import quant as jquant
from repro_torch.kernels import ops
from repro_torch.kernels import quant as tquant

SHAPES = [(2, 13, 7, 24), (311,), (), (0, 4), (1, 6, 6, 3)]
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]
BLOCKS = [128, 256, 8192]


def _leaf(shape, seed=3):
    rng = np.random.default_rng(seed + len(shape))
    x = np.asarray(rng.normal(size=shape) * 5, np.float32)
    if x.size > 40:
        x.reshape(-1)[7:19] = 0.0        # a run of zeros inside a block
    return x


def _pair(shape, dtypes):
    tdt, jdt = dtypes
    x = _leaf(shape)
    t, j = torch.from_numpy(x.copy()).to(tdt), jnp.asarray(x).astype(jdt)
    assert _bits(t) == np.asarray(j).tobytes()         # the same input bits
    return t, j


def _bits(t: torch.Tensor) -> bytes:
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.contiguous().numpy().tobytes()


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_quant_pair_is_bitwise_the_reference(shape, dtypes, block):
    t, j = _pair(shape, dtypes)
    q, s, n = ops.quantize(t, block=block)
    jq, js, jn = jquant.quant_pallas(j, block=block, interpret=True)
    oq, os_, on = jops.quantize(j, block=block)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(q.shape) == jq.shape == oq.shape
    assert n == jn == on == int(np.prod(shape))
    assert q.numpy().tobytes() == np.asarray(jq).tobytes() == np.asarray(oq).tobytes()
    assert s.numpy().tobytes() == np.asarray(js).tobytes() == np.asarray(os_).tobytes()

    y = ops.dequantize(q, s, n, shape, t.dtype)
    jy = jquant.dequant_pallas(jq, js, jn, shape, j.dtype, interpret=True)
    oy = jops.dequantize(oq, os_, on, shape, j.dtype)
    assert y.dtype == t.dtype and tuple(y.shape) == shape == jy.shape
    assert _bits(y) == np.asarray(jy).tobytes() == np.asarray(oy).tobytes()


def test_quant_geometry_and_device_checks():
    x = torch.ones(5)
    with pytest.raises(ValueError, match="128-lane"):
        ops.quantize(x, block=200)
    q, s, n = ops.quantize(torch.zeros((0, 3)), block=128)
    assert tuple(q.shape) == (0, 128) and tuple(s.shape) == (0,) and n == 0
    assert tuple(ops.dequantize(q, s, n, (0, 3)).shape) == (0, 3)
    # an all-zero block gets scale 1.0, as the reference
    q, s, _ = ops.quantize(torch.zeros(300), block=128)
    assert s.tolist() == [1.0, 1.0, 1.0] and not q.any()
    # the CUDA wrappers refuse host tensors instead of falling back
    with pytest.raises(ValueError, match="CUDA device"):
        tquant.quant_cuda(x, 128)
    q, s, n = tquant.quant_plain(x, 128)
    with pytest.raises(ValueError, match="CUDA device"):
        tquant.dequant_cuda(q, s, n, (5,))
