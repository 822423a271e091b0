"""The port's recurrent blocks (``repro_torch/models/ssm.py``) against the
JAX package's ``repro/models/ssm.py`` on the CPU.

The same numpy inputs (seeded) and the JAX package's weights (its ``*_init``
carried across by ``bridge.lm_params_from_numpy``) go through both; every
output and state must agree within SSM_TOL of its max |x|, float32 with
sums in other orders (the chunk einsums, and the mamba scan, which the port
takes in doubling steps where XLA takes ``associative_scan``'s tree).  The
mLSTM state C is compared through its action on a probe vector, as
``tests/test_ssm.py`` compares it, and the stabiliser m first.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jget_reduced
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.configs import get_reduced_config
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.tree import tree_flatten, tree_leaves

SSM_TOL = 2e-5
CPU = torch.device("cpu")


def _close(port, ref, tol=SSM_TOL):
    port = port.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= tol, err


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a.copy()) for a in arrays])


@pytest.mark.parametrize("K", [1, 2, 4])
@pytest.mark.parametrize("with_cache", [False, True])
def test_causal_conv1d_matches_the_reference(K, with_cache):
    x, w, cache = _normal(K, (2, 7, 5), (K, 5), (2, K - 1, 5))
    (jx, jw, jc), (tx, tw, tc) = _both(x, w, cache)
    jy, jnew = JS.causal_conv1d(jx, jw, jc if with_cache else None)
    ty, tnew = S.causal_conv1d(tx, tw, tc if with_cache else None)
    _close(ty, jy)
    assert tuple(tnew.shape) == jnew.shape == (2, K - 1, 5)
    if K > 1:
        _close(tnew, jnew)


def test_group_norm_matches_the_reference():
    x, scale = _normal(3, (2, 6, 3, 8), (3, 8))
    (jx, js), (tx, ts) = _both(x, scale)
    _close(S.group_norm(tx, ts), JS.group_norm(jx, js))


def _mlstm_inputs(seed, B=2, Sq=33, nh=2, hd=16):
    q, k, v, i_raw, f_raw = _normal(seed, (B, Sq, nh, hd), (B, Sq, nh, hd),
                                    (B, Sq, nh, hd), (B, Sq, nh), (B, Sq, nh))
    return q, k / np.sqrt(hd), v, i_raw, f_raw + 3.0


def _mlstm_state(seed, B=2, nh=2, hd=16):
    C, n, m = _normal(seed, (B, nh, hd, hd), (B, nh, hd), (B, nh))
    return {"C": C, "n": n, "m": m - 2.0}


def _close_mlstm_state(port, ref, seed=9):
    _close(port["m"], ref["m"])
    _close(port["n"], ref["n"])
    probe, = _normal(seed, port["n"].shape)
    _close(torch.einsum("bnij,bni->bnj", port["C"], torch.from_numpy(probe)),
           jnp.einsum("bnij,bni->bnj", ref["C"], jnp.asarray(probe)))


def test_mlstm_cell_step_matches_the_reference():
    q, k, v, i_raw, f_raw = _mlstm_inputs(4, Sq=1)
    st = _mlstm_state(5)
    jin, tin = _both(q[:, 0], k[:, 0], v[:, 0], i_raw[:, 0], f_raw[:, 0])
    jst = {n: jnp.asarray(a) for n, a in st.items()}
    tst = {n: torch.from_numpy(a) for n, a in st.items()}
    jh, jnew = JS.mlstm_cell_step(*jin, jst)
    th, tnew = S.mlstm_cell_step(*tin, tst)
    _close(th, jh)
    _close_mlstm_state(tnew, jnew)


@pytest.mark.parametrize("chunk", [8, 16, 64])
@pytest.mark.parametrize("Sq", [33, 64, 70])
@pytest.mark.parametrize("carried", [False, True])
def test_mlstm_sequence_matches_the_reference(chunk, Sq, carried):
    """The chunkwise form at S not a multiple of the chunk (the padded
    steps' gates), with and without a carried state."""
    q, k, v, i_raw, f_raw = _mlstm_inputs(Sq + chunk, Sq=Sq)
    jin, tin = _both(q, k, v, i_raw, f_raw)
    jst = tst = None
    if carried:
        st = _mlstm_state(chunk)
        jst = {n: jnp.asarray(a) for n, a in st.items()}
        tst = {n: torch.from_numpy(a) for n, a in st.items()}
    jh, jnew = JS.mlstm_sequence(*jin, jst, chunk=chunk)
    th, tnew = S.mlstm_sequence(*tin, tst, chunk=chunk)
    _close(th, jh)
    _close_mlstm_state(tnew, jnew)


def test_mlstm_sequence_matches_its_own_step_form():
    """Chunkwise over 33 steps against 33 cell steps in the port alone, at
    the JAX package's own test tolerance for the same pair (2e-4,
    ``tests/test_ssm.py``)."""
    q, k, v, i_raw, f_raw = (torch.from_numpy(a) for a in _mlstm_inputs(0))
    h_seq, st_seq = S.mlstm_sequence(q, k, v, i_raw, f_raw, chunk=8)
    state = S.mlstm_state_init(2, 2, 16, CPU)
    hs = []
    for t in range(q.shape[1]):
        h_t, state = S.mlstm_cell_step(q[:, t], k[:, t], v[:, t],
                                       i_raw[:, t], f_raw[:, t], state)
        hs.append(h_t)
    torch.testing.assert_close(h_seq, torch.stack(hs, 1), rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(st_seq["m"], state["m"], rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(st_seq["n"], state["n"], rtol=2e-4, atol=2e-4)


def _block_params(arch, block, seed):
    """(JAX config, port config, JAX params, port params) of one block."""
    jcfg, tcfg = jget_reduced(arch), get_reduced_config(arch)
    init = {"mlstm": JS.mlstm_block_init, "slstm": JS.slstm_block_init,
            "mamba": JS.mamba_init}[block]
    jp = jax.tree.map(np.asarray, init(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, tcfg, jp, lm_params_from_numpy(jp, CPU)


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_xlstm_block_with_a_continuation_matches_the_reference(block):
    """Prefill 11 steps, then continue with 6 more (the sequence form on the
    carried state) and 2 single steps (the mLSTM step form; sLSTM runs its
    loop either way), each output and state against the JAX block."""
    jcfg, tcfg, jp, tp = _block_params("xlstm-350m", block, 11)
    apply_j = {"mlstm": JS.mlstm_block_apply, "slstm": JS.slstm_block_apply}[block]
    apply_t = {"mlstm": S.mlstm_block_apply, "slstm": S.slstm_block_apply}[block]
    x, = _normal(12, (2, 19, tcfg.d_model))
    jc = tc = None
    for lo, hi in ((0, 11), (11, 17), (17, 18), (18, 19)):
        jy, jc = apply_j(jcfg, jp, jnp.asarray(x[:, lo:hi]), cache=jc)
        with torch.no_grad():
            ty, tc = apply_t(tcfg, tp, torch.from_numpy(x[:, lo:hi]), cache=tc)
        _close(ty, jy)
        if block == "mlstm":
            _close(tc["conv"], jc["conv"])
            _close_mlstm_state(tc["state"], jc["state"])
        else:
            for name in ("h", "c", "n", "m"):
                _close(tc["state"][name], jc["state"][name])


@pytest.mark.parametrize("Sq", [1, 9, 16])
@pytest.mark.parametrize("carried", [False, True])
def test_mamba_sequence_matches_the_reference(Sq, carried):
    """The sequence form (the port's doubling scan against XLA's
    associative scan), from zeros and from a carried state and conv."""
    jcfg, tcfg, jp, tp = _block_params("hymba-1.5b", "mamba", Sq)
    di = tp["w_in"].shape[1] // 2
    x, conv, state = _normal(Sq + 1, (2, Sq, tcfg.d_model),
                             (2, tcfg.ssm_conv - 1, di),
                             (2, di, tcfg.ssm_state))
    jc = tc = None
    if carried:
        jc = {"conv": jnp.asarray(conv), "state": jnp.asarray(state)}
        tc = {"conv": torch.from_numpy(conv), "state": torch.from_numpy(state)}
    jy, jnew = JS.mamba_apply(jcfg, jp, jnp.asarray(x), cache=jc)
    with torch.no_grad():
        ty, tnew = S.mamba_apply(tcfg, tp, torch.from_numpy(x), cache=tc)
    _close(ty, jy)
    _close(tnew["conv"], jnew["conv"])
    _close(tnew["state"], jnew["state"])


def test_mamba_step_form_matches_the_reference_and_its_sequence_form():
    """Nine single steps against the JAX step form, and the port's own steps
    against its sequence form over the same nine tokens (the JAX package's
    test holds that pair to 2e-4, ``tests/test_ssm.py``)."""
    jcfg, tcfg, jp, tp = _block_params("hymba-1.5b", "mamba", 2)
    x, = _normal(2, (2, 9, tcfg.d_model))
    jc = JS.mamba_cache_init(jcfg, 2)
    tc = S.mamba_cache_init(tcfg, 2, CPU)
    ys = []
    with torch.no_grad():
        for t in range(9):
            jy, jc = JS.mamba_apply(jcfg, jp, jnp.asarray(x[:, t:t + 1]), cache=jc)
            ty, tc = S.mamba_apply(tcfg, tp, torch.from_numpy(x[:, t:t + 1]),
                                   cache=tc)
            _close(ty, jy)
            _close(tc["state"], jc["state"])
            ys.append(ty)
        y_seq, c_seq = S.mamba_apply(tcfg, tp, torch.from_numpy(x))
    torch.testing.assert_close(y_seq, torch.cat(ys, 1), rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(c_seq["state"], tc["state"], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("S_len", [1, 2, 5, 8, 37])
def test_affine_scan_is_the_recurrence(S_len):
    """The doubling scan against the plain recurrence in float64."""
    a, b = (torch.from_numpy(t.astype(np.float64))
            for t in _normal(S_len, (2, S_len, 3, 4), (2, S_len, 3, 4)))
    a = a.abs()
    want, h = [], torch.zeros_like(b[:, 0])
    for t in range(S_len):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    got = S._affine_scan(a.clone(), b.clone())
    torch.testing.assert_close(got, torch.stack(want, 1), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("arch", ["xlstm-350m", "hymba-1.5b"])
def test_port_init_keeps_the_reference_tree(arch):
    """The port's own random weights (``transformer.init``, the path with no
    JAX) in the JAX tree: the same leaves at the same paths, shapes and
    dtypes, in bf16 and float32."""
    for dtype in ("bfloat16", "float32"):
        jcfg = jget_reduced(arch).replace(dtype=dtype)
        tcfg = get_reduced_config(arch).replace(dtype=dtype)
        jp = jax.eval_shape(lambda k: JT.init(jcfg, k), jax.random.PRNGKey(0))
        tp = T.init(tcfg, torch.Generator().manual_seed(0), CPU)
        jl, _ = jax.tree.flatten_with_path(jp)
        tl, _ = tree_flatten(tp)
        assert len(jl) == len(tl)
        for (path, a), b in zip(jl, tl):
            assert tuple(b.shape) == a.shape, path
            assert str(b.dtype).removeprefix("torch.") == str(a.dtype), path
        assert all(torch.isfinite(t.float()).all() for t in tree_leaves(tp))
