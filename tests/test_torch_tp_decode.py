"""The port's decode over a (data, model) mesh with "model" over one: the
prefill and the decode step hand over their caches placed as
``sharding.cache_shardings`` places them, and attention on a cache cut on
its rows runs B6's partial mode on a rank's rows and combines the ranks'
partials (flash decode across ranks).

Gloo ranks (``tests/_torch_ranks.py``, two spawns with a timeout: two
ranks for (1, 2), four for (2, 2)) run ``build_prefill(mesh=)`` of a
prompt of PROMPT positions into caches of MAX_LEN rows, then STEPS
``build_decode_step(mesh=)`` steps on fixed (teacher-forced) inputs, so
that the steps cross the chunks' boundaries and the chunks past the live
rows stay empty for a while (at batch 1 over (2, 2) the rows are cut four
ways, and the last rank's quarter holds no live row in any step).  For the
reduced models of six families (qwen3-1.7b, deepseek-v2-lite-16b with MLA,
hymba-1.5b with a ring and mamba, xlstm-350m, musicgen-medium,
internvl2-26b), weights from the port's init in the JAX package's layout,
at (1, 2) and (2, 2) with batch 4 and at (2, 2) with batch 1 (the rows then
cut over ("data", "model")):

* each step's gathered logits within LM_TOL of max |logit| of the
  one-process prefill and decode on the same weights and inputs, and of
  the JAX package's ``prefill`` and ``decode_step`` (jitted, one device);
* each rank's chunk of every cache leaf, after the prefill and after the
  last step, its chunk of the one-process cache within LM_TOL of the
  leaf's max;
* CUT_DIMS: which dim of each leaf the placement cuts.  At MAX_LEN 48 the
  reduced hymba's caches (its ring of 16 rows, its global cache) are cut
  on head_dim (64), not on their rows, and so are musicgen's and
  internvl's: they take the route that gathers the cache for the step.
  qwen3's and MLA's caches are cut on their rows.

``hymba-1.5b`` once more with its window widened to WIDE_WINDOW, a prompt
of WIDE_PROMPT (past the window, so the ring has wrapped) and WIDE_MAX_LEN
rows: its ring and its global cache are then longer than head_dim and cut
on their rows, so the ring takes the partial route too, with its slots
written in wrapped order.  ``deepseek-v2-lite-16b`` once more with a
prompt of NARROW_PROMPT and NARROW_MAX_LEN rows, fewer than its latent's
rank (32): the latent is then cut on its rank and the rope key on its
rows, so MLA takes the route that gathers its leaves for the step.

B6's partial mode in plain form: the combine of a cache's parts (halves,
quarters, some with no live row) equals the whole call, and a merge with a
shard of -inf weighs it 0.  A 1 x 1 mesh's prefill and decode steps are
bit for bit the mesh-free ones.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_ranks import one_rank_group, spawn_ranks, tp_decode_rank
from repro.configs import get_reduced_config as jreduced
from repro.models import transformer as JT
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import InputShape
from repro_torch.kernels import decode_attention as da
from repro_torch.launch import collectives as C
from repro_torch.launch.sharding import cache_shardings, shard
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_model
from repro_torch.tree import tree_leaves, tree_map, tree_paths

ARCHS = ("qwen3-1.7b", "deepseek-v2-lite-16b", "hymba-1.5b", "xlstm-350m",
         "musicgen-medium", "internvl2-26b")
WIDE = "hymba-wide"                   # hymba-1.5b, window WIDE_WINDOW
NARROW = "deepseek-narrow"            # deepseek, NARROW_MAX_LEN rows
CASES = ARCHS + (WIDE, NARROW)
MESHES = {"1x2-b4": ((1, 2), 4), "2x2-b4": ((2, 2), 4),
          "2x2-b1": ((2, 2), 1)}
LM_TOL = 2e-5
PROMPT, MAX_LEN, STEPS = 20, 48, 16
WIDE_WINDOW, WIDE_PROMPT, WIDE_MAX_LEN = 80, 90, 128
NARROW_PROMPT, NARROW_MAX_LEN = 12, 28
CPU = torch.device("cpu")

# the dim of each stacked leaf (layers, B, ...) that the placement cuts
# beside the batch rows, the same at all three meshes
SEQ, HD, INNER, HEADS = "seq", "head_dim", "inner", "heads"
HD_V = "head_dim_v"                   # mLSTM's C (heads, hd_k, hd_v)
_GQA = {"['attn']['k']": HD, "['attn']['v']": HD}
CUT_DIMS = {
    "qwen3-1.7b": {"[0]['attn']['k']": SEQ, "[0]['attn']['v']": SEQ},
    "deepseek-v2-lite-16b": {f"[{r}]['attn']['{n}']": SEQ
                             for r in (0, 1) for n in ("k_rope", "latent")},
    "hymba-1.5b": {**{f"[{r}]{k}": v for r in range(3)
                      for k, v in _GQA.items()},
                   **{f"[{r}]['mamba']['{n}']": INNER for r in range(3)
                      for n in ("conv", "state")}},
    "xlstm-350m": {"[0]['conv']": INNER, "[0]['state']['C']": HD_V,
                   "[0]['state']['m']": HEADS, "[0]['state']['n']": HD,
                   **{f"[1]['state']['{n}']": HD for n in "chmn"},
                   "[2]['conv']": INNER, "[2]['state']['C']": HD_V,
                   "[2]['state']['m']": HEADS, "[2]['state']['n']": HD},
    "musicgen-medium": {"[0]" + k: v for k, v in _GQA.items()},
    "internvl2-26b": {"[0]" + k: v for k, v in _GQA.items()},
    WIDE: {**{f"[{r}]['attn']['{n}']": SEQ for r in range(3)
              for n in "kv"},
           **{f"[{r}]['mamba']['{n}']": INNER for r in range(3)
              for n in ("conv", "state")}},
    NARROW: {**{f"[{r}]['attn']['latent']": "rank" for r in (0, 1)},
             **{f"[{r}]['attn']['k_rope']": SEQ for r in (0, 1)}},
}
# each leaf kind's dims after (layers, B), by name
_NAMED = {"k": (HEADS, SEQ, HD), "v": (HEADS, SEQ, HD),
          "latent": (SEQ, "rank"), "k_rope": (SEQ, "rope"),
          "conv": ("taps", INNER), "state": None, "C": (HEADS, HD, HD_V),
          "n": (HEADS, HD), "m": (HEADS, HD), "h": (HEADS, HD),
          "c": (HEADS, HD)}


def _arch(case):
    return {WIDE: "hymba-1.5b", NARROW: "deepseek-v2-lite-16b"}.get(case,
                                                                    case)


def _cfg(case):
    if case == WIDE:
        return get_reduced_config("hymba-1.5b").replace(
            sliding_window=WIDE_WINDOW)
    return get_reduced_config(_arch(case))


def _jcfg(case):
    if case == WIDE:
        return jreduced("hymba-1.5b").replace(sliding_window=WIDE_WINDOW)
    return jreduced(_arch(case))


def _sizes(case):
    return {WIDE: (WIDE_PROMPT, WIDE_MAX_LEN),
            NARROW: (NARROW_PROMPT, NARROW_MAX_LEN)}.get(case, (PROMPT, MAX_LEN))


def _inputs(cfg, specs, rng):
    out = {}
    for name, s in specs.items():
        if s.dtype.is_floating_point:
            out[name] = rng.standard_normal(s.shape).astype(np.float32)
        else:
            out[name] = rng.integers(0, cfg.vocab_size, s.shape,
                                     dtype=np.int32)
    return out


class _StandIn:
    """A mesh's axes, sizes and one rank's coordinate, for the rules."""
    axis_names = ("data", "model")

    def __init__(self, grid, coord):
        self.shape = dict(zip(self.axis_names, grid))
        self._coord = coord

    def coordinate(self):
        return self._coord


@pytest.fixture(scope="module")
def cases():
    """Per case: the weights (numpy) and, per batch size, the prompt and
    the decode inputs."""
    out = {}
    for i, case in enumerate(CASES):
        cfg = _cfg(case)
        model = get_model(cfg, CPU)
        params = tree_map(lambda x: x.numpy(), model.init(
            torch.Generator().manual_seed(11 + i)))
        prompt_len, _ = _sizes(case)
        rng = np.random.default_rng(100 + i)
        by_b = {}
        for B in (4, 1):
            prompt = _inputs(cfg, model.prefill_inputs(
                InputShape("p", prompt_len, B, "prefill")), rng)
            steps = [_inputs(cfg, model.decode_inputs(
                InputShape("d", 1, B, "decode")), rng) for _ in range(STEPS)]
            by_b[B] = (prompt, steps)
        out[case] = dict(params=params, by_b=by_b)
    return out


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def one_process(cases):
    """The mesh-free prefill and decode steps: the logits of each (the
    prefill's first) and the caches after the prefill and after the last
    step."""
    out = {}
    for case in CASES:
        cfg, c = _cfg(case), cases[case]
        prompt_len, max_len = _sizes(case)
        params = lm_params_from_numpy(c["params"], CPU)
        for B, (prompt, steps) in c["by_b"].items():
            logits, caches = T.prefill(cfg, params, _torch(prompt), max_len)
            first = tree_map(lambda a: a.clone(), caches)
            got = [logits.numpy()]
            for i, b in enumerate(steps):
                logits, caches = T.decode_step(cfg, params, caches, _torch(b),
                                               prompt_len + i)
                got.append(logits.numpy())
            out[(case, B)] = dict(logits=got, caches0=first, caches=caches)
    return out


@pytest.fixture(scope="module")
def jax_side(cases):
    """The JAX package's prefill and decode steps (jitted) on the same
    weights and inputs: the logits of each."""
    out = {}
    for case in CASES:
        jcfg, c = _jcfg(case), cases[case]
        prompt_len, max_len = _sizes(case)
        pre = jax.jit(lambda p, b: JT.prefill(jcfg, p, b, max_len))
        step = jax.jit(lambda p, ca, b, i: JT.decode_step(jcfg, p, ca, b, i))
        for B, (prompt, steps) in c["by_b"].items():
            logits, caches = pre(c["params"], prompt)
            got = [np.asarray(logits)]
            for i, b in enumerate(steps):
                logits, caches = step(c["params"], caches, b,
                                      np.int32(prompt_len + i))
                got.append(np.asarray(logits))
            out[(case, B)] = got
    return out


@pytest.fixture(scope="module")
def ranks(cases, tmp_path_factory):
    """Each mesh's ranks' results, per (case, mesh name), rank order."""
    out = {}
    for world, names in ((2, ("1x2-b4",)), (4, ("2x2-b4", "2x2-b1"))):
        todo, keys = [], []
        for name in names:
            grid, B = MESHES[name]
            for case in CASES:
                c = cases[case]
                prompt, steps = c["by_b"][B]
                over = ({"sliding_window": WIDE_WINDOW} if case == WIDE
                        else {})
                todo.append((_arch(case), over, grid, c["params"], prompt, steps,
                             _sizes(case)[1]))
                keys.append((case, name))
        got = spawn_ranks(tp_decode_rank, world,
                          tmp_path_factory.mktemp(f"tpdec{world}"), todo,
                          timeout=240)
        for j, key in enumerate(keys):
            out[key] = [r[j] for r in got]
    return out


GRID = [(case, name) for name in MESHES for case in CASES]
IDS = [f"{case}-{name}" for case, name in GRID]


def _rel(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1.0)


@pytest.mark.parametrize("case,mesh", GRID, ids=IDS)
def test_decode_over_a_model_axis_matches_one_process(case, mesh, ranks,
                                                      one_process):
    want = one_process[(case, MESHES[mesh][1])]["logits"]
    for got in ranks[(case, mesh)]:
        steps = [got["prefill"]] + got["logits"]
        assert len(steps) == STEPS + 1
        for i, (a, b) in enumerate(zip(steps, want)):
            assert a.shape == b.shape, i
            assert _rel(a, b) <= LM_TOL, i


@pytest.mark.parametrize("case,mesh", GRID, ids=IDS)
def test_decode_over_a_model_axis_matches_the_jax_package(case, mesh, ranks,
                                                          jax_side):
    want = jax_side[(case, MESHES[mesh][1])]
    for got in ranks[(case, mesh)]:
        for i, (a, b) in enumerate(zip([got["prefill"]] + got["logits"],
                                       want)):
            assert a.shape == b.shape, i
            assert _rel(a, b) <= LM_TOL, i


@pytest.mark.parametrize("case,mesh", GRID, ids=IDS)
def test_each_rank_holds_its_chunk_of_the_caches(case, mesh, ranks,
                                                 one_process):
    grid, B = MESHES[mesh]
    ref = one_process[(case, B)]
    for got in ranks[(case, mesh)]:
        stand_in = _StandIn(grid, got["coord"])
        specs = cache_shardings(stand_in, ref["caches"])
        for what, mine in (("caches0", got["chunks0"]),
                           ("caches", got["chunks"])):
            want = shard(ref[what], specs, stand_in)
            for path, a, b in zip(tree_paths(want), tree_leaves(mine),
                                  tree_leaves(want)):
                b = b.numpy()
                lim = LM_TOL * max(float(np.abs(b).max()), 1e-30)
                assert a.shape == b.shape, (what, path)
                assert float(np.abs(a - b).max()) <= lim, (what, path)


@pytest.mark.parametrize("case,mesh", GRID, ids=IDS)
def test_which_dim_each_cache_leaf_is_cut_on(case, mesh):
    """CUT_DIMS names the cut dim of every leaf: both GQA routes (rows and
    head_dim) are covered; at batch 1 over (2, 2) the cut spans ("data",
    "model") where its dim divides by 4 (mLSTM's two heads do not)."""
    grid, B = MESHES[mesh]
    cfg = _cfg(case)
    abstract = get_model(cfg, CPU).abstract_cache(B, _sizes(case)[1])
    specs = cache_shardings(_StandIn(grid, {"data": 0, "model": 0}),
                            abstract)
    seen = {}
    for path, leaf in zip(tree_paths(abstract), tree_leaves(abstract)):
        spec = specs[int(path[1])]
        for key in path[5:-2].split("']['"):
            spec = spec[key]
        cut = [(d, e) for d, e in enumerate(spec) if d >= 2 and e]
        assert len(cut) == 1, (path, spec)
        d, entry = cut[0]
        assert spec[1] == ("data" if B == 4 else None), (path, spec)
        names = _NAMED[path.rsplit("'", 2)[-2]] or (INNER, "state")
        seen[path] = names[d - 2]
        wide = B == 1 and leaf.shape[d] % 4 == 0
        assert entry == (("data", "model") if wide else "model"), (path, spec)
    assert seen == CUT_DIMS[case]


def _parts(rows, n_parts, kv_len):
    """Each part's (start, its live rows) of ``rows`` cut into
    ``n_parts``."""
    size = rows // n_parts
    return [(r * size, (kv_len - r * size).clamp(0, size))
            for r in range(n_parts)]


@pytest.mark.parametrize("n_parts,dtype,cap", [
    (2, torch.float32, 0.0), (2, torch.bfloat16, 0.0), (4, torch.float32, 0.0),
    (4, torch.float32, 1.0), (3, torch.bfloat16, 50.0)])
def test_partial_mode_combines_into_the_whole_call(n_parts, dtype, cap):
    """B6's plain partial mode on a cache cut on its rows: each part's (out
    float32, lse), a part past every live row -inf and zeros, merged in
    part order, equals the whole call (one rounding to q's dtype, so
    within two units of it in bf16), and its lse the whole logsumexp."""
    g = torch.Generator().manual_seed(n_parts)
    B, H, KV, hd, S = 5, 8, 2, 32, 96
    q = torch.randn((B, 1, H, hd), generator=g).to(dtype)
    ck, cv = (torch.randn((B, KV, S, hd), generator=g).to(dtype)
              for _ in range(2))
    kv_len = torch.tensor([0, 1, 40, 95, 96], dtype=torch.int32)
    whole = da.decode_attention_plain(q, ck, cv, kv_len, cap)
    whole32, lse = da.decode_attention_plain(q, ck, cv, kv_len, cap,
                                             return_lse=True)
    assert whole32.dtype == lse.dtype == torch.float32
    assert torch.equal(whole32.to(dtype), whole)
    assert torch.isinf(lse[0]).all() and (lse[0] < 0).all()
    assert not whole32[0].any()
    outs, lses = [], []
    for start, live in _parts(S, n_parts, kv_len):
        size = S // n_parts
        o, l = da.decode_attention_plain(
            q, ck[:, :, start:start + size], cv[:, :, start:start + size],
            live.to(torch.int32), cap, return_lse=True)
        assert torch.isinf(l[live == 0]).all()
        assert not o[live == 0].any()
        outs.append(o)
        lses.append(l[:, None])
    got = C.merge_partials(torch.stack(outs), torch.stack(lses), dtype)
    tol = 1e-6 if dtype == torch.float32 else 2 ** -7
    assert got.dtype == dtype
    assert float((got.float() - whole.float()).abs().max()) <= tol * max(
        float(whole.float().abs().max()), 1.0)
    lse_all = torch.logsumexp(torch.stack(lses)[:, :, 0], dim=0)
    live = kv_len > 0
    torch.testing.assert_close(lse_all[live], lse[live], rtol=1e-6,
                               atol=1e-6)


def test_partial_mode_wrapper_passes_its_outputs_and_counts_apart(
        monkeypatch):
    """The partial mode's launch: the C entry point gets the float32 out
    and the (B, H) lse in that order after kv_len, and no scratch, the same
    grid arguments whatever kv_len holds, and the launch counts as
    ``decode_attention_lse``, the default mode's count untouched.  The C
    function is replaced by a recorder, so this runs on the CPU."""
    calls = []
    monkeypatch.setattr(da._build, "check_operands", lambda *a: None)
    monkeypatch.setattr(da._build, "LAUNCHES", type(da._build.LAUNCHES)())
    monkeypatch.setattr(da._build, "current_stream", lambda device: 0)
    monkeypatch.setattr(da, "_fn_lse", lambda: lambda *a: calls.append(a)
                        or 0)
    B, H, KV, S, hd = 3, 8, 2, 1040, 128
    q = torch.zeros((B, 1, H, hd), dtype=torch.bfloat16)
    ck, cv = (torch.zeros((B, KV, S, hd), dtype=torch.bfloat16)
              for _ in range(2))
    for lens in ((0, 0, 0), (1040, 460, 0)):
        out, lse = da.decode_attention_cuda(
            q, ck, cv, torch.tensor(lens, dtype=torch.int32), 0.0, True)
        assert out.dtype == lse.dtype == torch.float32
        assert out.shape == q.shape and lse.shape == (B, H)
        assert calls[-1][4:6] == (out.data_ptr(), lse.data_ptr())
        assert len(calls[-1]) == 16
    C, _ = da.cluster_plan(B, KV, S, hd, 2)
    assert {a[6:13] for a in calls} == {(B, S, H, KV, hd, C, 1)}
    assert dict(da._build.LAUNCHES) == {"decode_attention_lse": 2}


def test_a_shard_of_minus_inf_weighs_nothing():
    """``merge_partials``: a part with lse -inf (whatever its out) adds
    nothing, all parts -inf give zeros, and the sum runs in part order."""
    g = torch.Generator().manual_seed(0)
    outs = torch.randn((3, 2, 4, 6), generator=g)
    lses = torch.randn((3, 2, 4), generator=g)
    lses[1] = -torch.inf
    got = C.merge_partials(outs, lses)
    want = C.merge_partials(outs[[0, 2]], lses[[0, 2]])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    w = torch.softmax(lses[[0, 2]], dim=0)
    torch.testing.assert_close(got, (w[..., None] * outs[[0, 2]]).sum(0),
                               rtol=1e-5, atol=1e-6)
    assert not C.merge_partials(outs, torch.full_like(lses, -torch.inf)).any()
    one = C.merge_partials(outs[:1], lses[:1], torch.bfloat16)
    assert torch.equal(one, outs[0].to(torch.bfloat16))


@pytest.mark.parametrize("arch", ("qwen3-1.7b", "deepseek-v2-lite-16b",
                                  "hymba-1.5b", "xlstm-350m"))
def test_one_by_one_mesh_decode_is_the_mesh_free_decode(arch, cases,
                                                        tmp_path):
    """On a one-rank group every placement is whole and no collective
    runs: the prefill's and each decode step's logits and caches bitwise
    the mesh-free ones."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import gather
    from repro_torch.launch.steps import build_decode_step, build_prefill
    cfg, c = _cfg(arch), cases[arch]
    prompt, steps = c["by_b"][4]
    params = lm_params_from_numpy(c["params"], CPU)
    logits, caches = T.prefill(cfg, params, _torch(prompt), MAX_LEN)
    with one_rank_group(tmp_path):
        mesh = make_host_mesh(device="cpu")
        pre = build_prefill(cfg, InputShape("p", PROMPT, 4, "prefill"),
                            mesh=mesh, max_len=MAX_LEN)
        dec = build_decode_step(cfg, InputShape("d", MAX_LEN, 4, "decode"),
                                mesh=mesh)
        placed = pre.place(params)
        got, placed_caches = pre(placed, _torch(prompt))
        assert torch.equal(got, logits)
        for i, b in enumerate(steps[:4]):
            logits, caches = T.decode_step(cfg, params, caches, _torch(b),
                                           PROMPT + i)
            got, placed_caches = dec(placed, placed_caches, _torch(b),
                                     PROMPT + i)
            assert torch.equal(got, logits), i
        for a, b in zip(tree_leaves(gather(placed_caches)),
                        tree_leaves(caches)):
            assert torch.equal(a, b)
