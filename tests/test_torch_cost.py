"""``launch/cost.py``, the kernels' cost counts and the dry-run
(``launch/dryrun.py``), on the meta device.

* A reduced dense prefill's matrix-product FLOPs, as ``FlopCounterMode``
  counts them, equal the analytic count of its projections and its
  last-position unembedding exactly, as integers (B5 runs no aten product:
  its work is counted by its own cost function).
* B5's and B6's counted work equals the bound formulas of ``PERF.md``
  section 6 at two shapes each: B5 4 hd flop a live (query, key) pair and
  head (the live pairs counted here from the dense mask) and its operands'
  bytes; B6 4 hd flop a live cache row and head and the live rows' bytes.
* The meta route returns empty meta outputs and reaches neither a kernel
  nor a plain version.
* The port's matrix-product FLOPs of a reduced prefill beside the JAX
  package's ``hlo_cost.analyze(...)["dot_flops"]`` of its compiled prefill:
  the JAX count is higher, because its blockwise attention
  (``models/attention_flash.py``) multiplies whole query and key blocks,
  the ones past the causal band included (at this size the full square of
  pairs: its dot FLOPs are the projections' plus twice B5's live-pair
  count less the diagonal, 1.306 times the port's here), where B5's count
  takes the live pairs only; the gap is held at most at the full square,
  S^2 against S (S + 1) / 2 pairs.
* Every reduced config's dry-run cells, at cut shapes, are OK or SKIP on
  meta, and the skipped cells are the JAX dry-run's: ``long_500k`` for the
  families that are not sub-quadratic.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_reduced_config as jreduced
from repro.configs.base import InputShape as JShape
from repro.launch.hlo_cost import analyze
from repro.launch.mesh import make_host_mesh as jmesh
from repro.launch.steps import build_prefill as jprefill
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import InputShape
from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as _fa
from repro_torch.launch import cost
from repro_torch.launch.dryrun import cells, run_cell
from repro_torch.launch.steps import build_prefill
from repro_torch.models.registry import META, MetaGenerator, get_model



def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device=META)


def _prefill_count(arch, B, S):
    cfg = get_reduced_config(arch)
    model = get_model(cfg, META)
    params = model.abstract_params()
    batch = model.concrete(model.prefill_inputs(InputShape("p", S, B,
                                                           "prefill")),
                           MetaGenerator())
    with torch.device(META):
        return cfg, cost.count(build_prefill(cfg, InputShape("p", S, B,
                                                             "prefill")),
                               params, batch)


def test_dense_prefill_matmul_flops_are_the_analytic_count():
    B, S = 2, 48
    cfg, got = _prefill_count("qwen3-1.7b", B, S)
    d, H, KV, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    per_layer = 2 * B * S * (d * H * hd + 2 * d * KV * hd + H * hd * d
                             + 3 * d * f)
    want = cfg.n_layers * per_layer + 2 * B * 1 * d * cfg.vocab_size
    assert got["matmul_flops"] == want
    pairs = S * (S + 1) // 2
    assert got["kernels"]["flash_attention"]["flop"] == \
        cfg.n_layers * 4 * hd * B * H * pairs
    assert got["peak_bytes"] > 0


def test_half_products_with_f32_output_count_on_meta():
    """On meta the f32-output half products take the card's branch
    (``mm``/``bmm`` with ``out_dtype``, as in a bf16 MoE prefill) and are
    counted as products."""
    from repro_torch.models.layers import bmm32, dense32
    a, b = _meta((3, 5, 7)), _meta((3, 7, 2))
    x, w = _meta((4, 6, 7)), _meta((7, 9))
    got = cost.count(lambda: (bmm32(a, b), dense32(x, w)))
    y, z = got["out"]
    assert y.dtype == z.dtype == torch.float32
    assert got["matmul_flops"] == 2 * 3 * 5 * 7 * 2 + 2 * 24 * 7 * 9


def _live_pairs_dense(Sq, Skv, w):
    q = np.arange(Sq)[:, None] + (Skv - Sq)
    k = np.arange(Skv)[None, :]
    live = k <= q
    if w:
        live &= k > q - w
    return int(live.sum())


@pytest.mark.parametrize("B,S,H,KV,hd,w", [
    (4, 2048, 16, 8, 128, 0),      # qwen3-1.7b's prefill (PERF.md B5 row)
    (4, 2048, 25, 5, 64, 1024),    # hymba-1.5b's windowed prefill
    (2, 100, 4, 2, 32, 7)])
def test_b5_counts_are_the_bound_formulas(B, S, H, KV, hd, w):
    q, k = _meta((B, S, H, hd)), _meta((B, S, KV, hd))
    before = dict(_build.COSTS)
    ops.flash_attention(q, k, k, causal=True, sliding_window=w)
    flop = _build.COSTS[("flash_attention", "flop")] - before.get(
        ("flash_attention", "flop"), 0)
    nbytes = _build.COSTS[("flash_attention", "bytes")] - before.get(
        ("flash_attention", "bytes"), 0)
    assert flop == B * H * _live_pairs_dense(S, S, w) * 4 * hd
    assert nbytes == 2 * (2 * q.numel() + 2 * k.numel())
    # its backward, through autograd on meta tensors: 10 hd a live pair
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, k))
    before = dict(_build.COSTS)
    out = ops.flash_attention(qg, kg, vg, causal=True, sliding_window=w)
    torch.autograd.grad(out, (qg, kg, vg), torch.empty_like(out))
    got = _build.COSTS[("flash_attention_bwd", "flop")] - before.get(
        ("flash_attention_bwd", "flop"), 0)
    assert got == B * H * _live_pairs_dense(S, S, w) * 10 * hd


@pytest.mark.parametrize("B,H,KV,hd,cache,rows", [
    (4, 16, 8, 128, 2080, 2048),   # qwen3-1.7b's decode (PERF.md B6 row)
    (3, 24, 24, 64, 300, 129)])
def test_b6_counts_are_the_bound_formulas(B, H, KV, hd, cache, rows):
    q, ck = _meta((B, 1, H, hd)), _meta((B, KV, cache, hd))
    kv_len = torch.full((B,), rows, dtype=torch.int32, device=META)
    before = dict(_build.COSTS)
    ops.decode_attention_kv_major(q, ck, ck, kv_len, kv_rows=rows)
    d = {w: _build.COSTS[("decode_attention", w)] - before.get(
        ("decode_attention", w), 0) for w in ("flop", "bytes")}
    assert d["flop"] == 4 * B * H * rows * hd
    assert d["bytes"] == 2 * (2 * B * KV * rows * hd + 2 * q.numel()) + 4 * B


def test_the_meta_route_reaches_no_kernel_and_no_plain_version(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("reached a kernel or a plain version")
    for table in (_fa.FORWARD, _fa.BACKWARD, ops.DECODE, ops.ENCODE,
                  ops.QUANT):
        for route in ("cpu", "cuda"):
            monkeypatch.setitem(table, route, refuse)
    launches = dict(ops.LAUNCHES)
    q = _meta((2, 64, 4, 32)).requires_grad_(True)
    out = ops.flash_attention(q, _meta((2, 64, 2, 32)), _meta((2, 64, 2, 32)))
    (dq,) = torch.autograd.grad(out, (q,), torch.empty_like(out))
    dec = ops.decode_attention_kv_major(
        _meta((2, 1, 4, 32)), _meta((2, 2, 80, 32)), _meta((2, 2, 80, 32)),
        torch.zeros(2, dtype=torch.int32, device=META))
    stream, scales = ops.codec_encode(_meta((8192,), torch.float32))
    qv, s, n = ops.quantize(_meta((3, 5000), torch.float32))
    for t, shape in ((out, (2, 64, 4, 32)), (dq, (2, 64, 4, 32)),
                     (dec, (2, 1, 4, 32)), (stream, (8192,)),
                     (qv, (2, 8192)), (s, (2,))):
        assert t.device.type == "meta" and tuple(t.shape) == shape
    assert n == 15000 and dict(ops.LAUNCHES) == launches


def test_matmul_flops_beside_the_jax_package_hlo_count():
    arch, B, S = "qwen3-1.7b", 2, 256
    _, got = _prefill_count(arch, B, S)
    jcfg = jreduced(arch)
    shape = JShape("p", S, B, "prefill")
    hlo = jprefill(jcfg, jmesh(), shape).lower().compile().as_text()
    dot = analyze(hlo)["dot_flops"]
    attn = got["kernels"]["flash_attention"]["flop"]
    square = attn * 2 * S // (S + 1)
    assert got["matmul_flops"] + attn <= dot <= got["matmul_flops"] + square, (
        got["matmul_flops"], attn, dot)


def test_dry_run_cells_are_ok_or_the_jax_skips():
    for arch, name in cells(ARCH_IDS, reduced=True):
        from repro_torch.configs import SHAPES_BY_NAME
        full = SHAPES_BY_NAME[name]
        cut = InputShape(name, min(full.seq_len, 40), min(full.global_batch, 2),
                         full.kind)
        cell = run_cell(arch, cut, reduced=True)
        jskip = name == "long_500k" and not jreduced(arch).sub_quadratic()
        assert cell["status"] == ("SKIP" if jskip else "OK"), cell
        if cell["status"] == "OK":
            assert cell["flops"] > 0 and cell["memory"]["peak_bytes"] > 0
