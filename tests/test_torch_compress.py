"""``repro_torch.optim.compress`` against the JAX package's
``repro/optim/compress.py``.

Two gloo ranks (``torch.multiprocessing``, a ``FileStore`` in tmp_path)
run the port's ``compressed_psum``; one subprocess runs the JAX package's
under ``shard_map`` on two host devices (the device-count flag set in the
child only), on the same per-rank gradients and error buffers, drawn with
numpy from a seed, leaves of sizes below, at and above a block, one not a
multiple of 8192.  The int8 payloads and the shared scales (recomputed in
the child with the JAX package's arithmetic, inside ``shard_map``) must be
bitwise equal, and so must the mean and the new error buffers: XLA on the
CPU divides as the port does (no reciprocal rewrite), and it fuses the
residual ``blocks - q * scale`` into one multiply-add, rounded once, which
the port reproduces in float64, so no ulp is allowed.  The two properties
of ``tests/test_optim.py`` follow on one rank: one worker's
reconstruction, and the bias over 30 steps.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_ranks import compress_rank, one_rank_group, spawn_ranks
from repro_torch.optim import compress as C

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"a": (3, 5000), "b": (8192,), "c": (2, 3, 7), "d": (40000,)}
SUBPROCESS_TIMEOUT = 240

_JAX_CHILD = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.optim import compress as GC
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    data = np.load(sys.argv[1])
    keys = sorted({k.split("/")[1] for k in data.files})
    g = {k: jnp.asarray(np.stack([data[f"g/{k}/{r}"] for r in range(2)]))
         for k in keys}
    e = {k: jnp.asarray(np.stack([data[f"e/{k}/{r}"] for r in range(2)]))
         for k in keys}
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("dp",))

    def body(gg, ee):
        gg = {k: v[0] for k, v in gg.items()}
        ee = {k: v[0] for k, v in ee.items()}
        mean, err = GC.compressed_psum(gg, "dp", ee)
        # the payload and scales, by compressed_psum's own lines
        qs, ss = [], []
        for k in keys:
            flat = gg[k].astype(jnp.float32).reshape(-1) + ee[k]
            pad = (-flat.shape[0]) % GC.BLOCK
            blocks = jnp.pad(flat, (0, pad)).reshape(-1, GC.BLOCK)
            absmax = jax.lax.pmax(jnp.max(jnp.abs(blocks), axis=1), "dp")
            scale = jnp.where(absmax > 0, absmax / GC.INT8_MAX, 1.0)
            q = jnp.clip(jnp.round(blocks / scale[:, None]),
                         -GC.INT8_MAX, GC.INT8_MAX).astype(jnp.int8)
            qs.append(q)
            ss.append(scale)
        out = (mean, err, jnp.concatenate(qs), jnp.concatenate(ss))
        return jax.tree.map(lambda a: a[None], out)

    fm = shard_map(body, mesh=mesh, in_specs=(P("dp"), P("dp")),
                   out_specs=P("dp"))
    mean, err, q, s = jax.jit(fm)(g, e)
    out = {}
    for r in range(2):
        for k in keys:
            out[f"mean/{k}/{r}"] = np.asarray(mean[k][r])
            out[f"err/{k}/{r}"] = np.asarray(err[k][r])
        out[f"q/{r}"] = np.asarray(q[r])
        out[f"scale/{r}"] = np.asarray(s[r])
    np.savez(sys.argv[2], **out)
""")


def _inputs():
    rng = np.random.default_rng(7)
    grads, errs = [], []
    for r in range(2):
        grads.append({k: (rng.normal(size=s) * 10.0 ** rng.integers(-4, 1))
                      .astype(np.float32) for k, s in SHAPES.items()})
        errs.append({k: (rng.normal(size=int(np.prod(s))) * 1e-4)
                     .astype(np.float32) for k, s in SHAPES.items()})
    grads[1]["c"][:] = 0.0              # a leaf of zeros on one rank
    return grads, errs


def test_two_ranks_equal_the_jax_package_bitwise(tmp_path):
    grads, errs = _inputs()
    ranks = spawn_ranks(compress_rank, 2, tmp_path, grads, errs)

    arrays = {f"g/{k}/{r}": grads[r][k] for r in range(2) for k in SHAPES}
    arrays.update({f"e/{k}/{r}": errs[r][k] for r in range(2) for k in SHAPES})
    np.savez(tmp_path / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", _JAX_CHILD,
                          str(tmp_path / "in.npz"), str(tmp_path / "jax.npz")],
                         env=env, capture_output=True, text=True,
                         timeout=SUBPROCESS_TIMEOUT)
    assert res.returncode == 0, res.stderr[-3000:]
    want = np.load(tmp_path / "jax.npz")
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["q"], want[f"q/{r}"])
        np.testing.assert_array_equal(got["scale"], want[f"scale/{r}"])
        for k in SHAPES:
            np.testing.assert_array_equal(got["mean"][k], want[f"mean/{k}/{r}"])
            np.testing.assert_array_equal(got["err"][k], want[f"err/{k}/{r}"])
    # every rank holds the same mean
    for k in SHAPES:
        np.testing.assert_array_equal(ranks[0]["mean"][k], ranks[1]["mean"][k])


@pytest.fixture
def one_rank(tmp_path):
    with one_rank_group(tmp_path):
        yield


def test_single_worker_exact_after_feedback(one_rank):
    """With one worker the mean is the dequantized local gradient and the
    error buffer holds exactly the quantization residual."""
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(size=(1000,))
                               .astype(np.float32))}
    mean, err = C.compressed_psum(g, C.init_error_state(g))
    np.testing.assert_allclose((mean["w"] + err["w"]).numpy(), g["w"].numpy(),
                               rtol=1e-5, atol=1e-6)


def test_error_feedback_reduces_bias_over_steps(one_rank):
    """Accumulated compressed gradients converge to the true sum: without
    feedback the bias would grow with the steps, with it it stays below a
    few quantization steps."""
    true = torch.from_numpy((np.random.default_rng(1).normal(size=(4096,))
                             * 0.001).astype(np.float32))
    err = {"w": torch.zeros(4096)}
    acc = torch.zeros(4096, dtype=torch.float64)
    steps = 30
    for _ in range(steps):
        out, err = C.compressed_psum({"w": true}, err)
        acc += out["w"].double()
    resid = (acc - steps * true.double()).abs().max().item()
    assert resid < 4 * true.abs().max().item() / 127


def test_wire_bytes():
    assert C.wire_bytes_per_element() == pytest.approx(1.0 + 4.0 / 8192)
