"""The port's sharding rules (``repro_torch.launch.sharding``) against the
JAX package's, on abstract meshes (no devices, no process group: JAX's
``AbstractMesh``, which its ``NamedSharding`` takes, and the port's rules
read only ``axis_names`` and ``shape``).

For every LM arch's full config, at the production meshes (pod 2, data
16, model 16) and (data 16, model 16), with FSDP on and off, each spec the
port gives equals the JAX package's ``PartitionSpec`` entry for entry:
every parameter leaf, AdamW's m and v, every decode-cache leaf, every
train, prefill and decode batch leaf, the logits, the MAC's cell axis and
the residual stream.  The leaves are paired by their key paths, and the
parameter and cache shapes come from both packages' abstract trees
(``jax.eval_shape`` there, the meta device here), which must agree.
"""
import jax
import pytest
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS, get_config as jconfig
from repro.configs.base import SHAPES_BY_NAME as JSHAPES
from repro.launch import sharding as JS
from repro.launch.steps import logits_pspec as jlogits
from repro.models.registry import get_model as jmodel
from repro.optim.adamw import AdamW as JAdamW
from repro_torch.configs import SHAPES_BY_NAME, get_config
from repro_torch.launch import sharding as S
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.steps import logits_pspec
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import AdamW
from repro_torch.tree import tree_flatten, tree_leaves


PodMesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
MESHES = {"2x16x16": PodMesh,
          "16x16": AbstractMesh((16, 16), ("data", "model"))}


def _jax_specs(tree):
    """Key path -> the spec of each NamedSharding leaf, as a tuple."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(k): tuple(v.spec) for k, v in flat}


def _port_specs(tree, like):
    """Key path -> spec, the paths taken from ``like`` (the tensors the
    specs place): a spec is a tuple, which the port's trees flatten."""
    leaves, treedef = tree_flatten(like)
    specs = []
    _collect(tree, specs)
    assert len(specs) == len(leaves)
    return dict(zip(treedef.paths(), specs))


def _collect(node, out):
    """A spec tree's leaves in the port's leaf order: a tuple that is not
    a NamedTuple is a spec."""
    if isinstance(node, tuple) and not hasattr(node, "_fields"):
        out.append(node)
    elif isinstance(node, dict):
        for k in sorted(node):
            _collect(node[k], out)
    else:
        for c in node:
            _collect(c, out)


def _same(jtree, ttree, like):
    want, got = _jax_specs(jtree), _port_specs(ttree, like)
    assert sorted(want) == sorted(got)
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, bad


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_the_jax_package(arch, fsdp, mesh):
    m = MESHES[mesh]
    jcfg, cfg = jconfig(arch), get_config(arch)
    jm, tm = jmodel(jcfg), get_model(cfg, "cpu")
    jrules, rules = JS.ShardingRules(fsdp=fsdp), S.ShardingRules(fsdp=fsdp)

    jparams, params = jm.abstract_params(), tm.abstract_params()
    jshapes = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
               jax.tree_util.tree_flatten_with_path(jparams)[0]}
    tshapes = dict(zip(tree_flatten(params)[1].paths(),
                       (tuple(x.shape) for x in tree_leaves(params))))
    assert jshapes == tshapes

    jp = JS.param_shardings(jrules, jm.spec(), jparams, m)
    tp = S.param_shardings(rules, tm.spec(), params, m)
    _same(jp, tp, params)

    jopt = jax.eval_shape(JAdamW().init, jparams)
    topt = AdamW().init(params)
    jo = JS.opt_state_shardings(jrules, jm.spec(), jopt, m)
    to = S.opt_state_shardings(rules, tm.spec(), topt, m)
    assert tuple(jo.step.spec) == to.step == ()
    _same(jo.m, to.m, topt.m)
    _same(jo.v, to.v, topt.v)

    for name in ("decode_32k", "long_500k"):
        jshape, shape = JSHAPES[name], SHAPES_BY_NAME[name]
        jc = jm.abstract_cache(jshape.global_batch, jshape.seq_len)
        tc = tm.abstract_cache(shape.global_batch, shape.seq_len)
        _same(JS.cache_shardings(m, jc), S.cache_shardings(m, tc), tc)

    for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        jshape, shape = JSHAPES[name], SHAPES_BY_NAME[name]
        for jf, tf in ((jm.train_inputs, tm.train_inputs),
                       (jm.prefill_inputs, tm.prefill_inputs),
                       (jm.decode_inputs, tm.decode_inputs)):
            jb, tb = jf(jshape), tf(shape)
            want = {k: tuple(v.spec) for k, v in
                    JS.batch_shardings(m, jb).items()}
            assert want == S.batch_shardings(m, tb)
        for seq in (1, min(cfg.loss_chunk, shape.seq_len)):
            assert tuple(jlogits(m, jcfg, shape.global_batch, seq).spec) == \
                logits_pspec(m, cfg, shape.global_batch, seq)
        for kw in (dict(), dict(seq_shard=False), dict(decode=True)):
            want = JS.ActivationShardings.for_mesh(
                m, shape.global_batch, shape.seq_len, cfg.d_model, **kw)
            got = S.ActivationShardings.for_mesh(
                m, shape.global_batch, shape.seq_len, cfg.d_model, **kw)
            assert tuple(want.residual.spec) == got.residual
    for n_cells in (1, 8, 16, 32, 64):
        assert tuple(JS.cell_axis_sharding(m, n_cells).spec) == \
            S.cell_axis_sharding(m, n_cells)


def test_fit_pspec_and_rules_match_the_jax_package():
    m = PodMesh
    for spec, shape in (((("pod", "data"), None, "model"), (1, 1, 32001)),
                        ((("pod", "data"), None, "model"), (64, 1, 32000)),
                        ((("pod", "data"), "model"), (2, 48))):
        assert tuple(JS.fit_pspec(m, jax.sharding.PartitionSpec(*spec),
                                  shape)) == S.fit_pspec(m, spec, shape)
    for fsdp in (True, False):
        for logical, shape in (((("vocab", "embed")), (49155, 1536)),
                               (("vocab", "embed"), (49152, 1536)),
                               (("mlp", "inner"), (64, 64))):
            assert tuple(JS.ShardingRules(fsdp=fsdp).pspec(
                logical, shape, m)) == S.ShardingRules(fsdp=fsdp).pspec(
                logical, shape, m)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    m = Mesh(None, ("pod", "data", "model"), {"pod": 2, "data": 2, "model": 1})
    assert S.placements((("pod", "data"), None, "model"), m) == [
        Shard(0), Shard(0), Shard(2)]
    assert S.placements((None, "data"), m) == [Replicate(), Shard(1),
                                               Replicate()]
    assert S.placements((), m) == [Replicate()] * 3


def test_swin_weights_are_replicated():
    """Swin's spec, as the JAX package's says, replicates every weight."""
    import torch
    from repro_torch.configs.swin_t_detection import reduced
    from repro_torch.models import swin as SW
    cfg = reduced()
    params = SW.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    specs = S.param_shardings(S.ShardingRules(), SW.spec(cfg)(params),
                              params, PodMesh)
    leaves = tree_leaves(params)
    flat = []
    _collect(specs, flat)
    assert len(flat) == len(leaves)
    assert all(s == (None,) * x.dim() for s, x in zip(flat, leaves))
