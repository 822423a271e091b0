"""Recurrent and state-space blocks (``repro/models/ssm.py``): xLSTM's mLSTM
and sLSTM, and the Mamba-style selective SSM of Hymba's SSM heads.

What runs where: every function here is plain PyTorch on the device of its
tensors, on the card or on the CPU alike.  The JAX package computes these
blocks as XLA code (``lax.scan``, ``lax.associative_scan``, einsums) outside
any ``pallas_call``, so they hold no kernel; none of them calls
``scaled_dot_product_attention`` or ``torch.compile``.

The conventions are those of ``layers.py``: functional ``*_init`` /
``*_apply``, parameter dicts in the JAX package's tree, shapes, scales and
dtypes (the gate weights, ``w_dt``, ``b_dt``, ``A_log`` and ``D`` float32,
the rest in the config's dtype); gate and state arithmetic in float32.
Every block has two forms:

  - sequence form (prefill): mLSTM chunkwise-parallel, a Python loop over
    chunks of L = min(64, S) steps that carries (C, n, m), as the JAX
    package's ``lax.scan`` over chunks; sLSTM a Python loop over time; mamba
    an inclusive scan of the affine maps h -> da h + db over time, taken
    as log2(S) doubling steps (Hillis-Steele) on the (B, S, d_inner, N)
    float32 tensors.  It computes what ``jax.lax.associative_scan`` does,
    with the sums in another order.
  - step form (decode, one token against a carried state): O(1) in the
    sequence length.

A block returns its new state, which the decoder writes back into the
stacked decode caches (``transformer._run_layers``).

Tensor parallelism (inside ``collectives.model_parallel``): where the rules
split the inner dim over the model group, each block takes its input
through f and runs its channels.  The packed projections (mamba's and
mLSTM's [x | z], sLSTM's [i | f | z | o]) keep the rules' column chunks
of the packed weight, which do not hold matching slices of the parts, so
the projected activation is gathered whole over the group (an all-gather)
and each rank takes its channels of each part.  A product that contracts
over the inner dim (mamba's ``w_x``, mLSTM's q/k/v and gates) is partial
and summed over the group in float32 (an all-reduce each way, as the rank
then uses it for its own channels again), then rounded once.  mLSTM and sLSTM run the recurrence on
the rank's heads where the rules split the heads, else on every head; the
block's output is reduced (g) or, for sLSTM's heads, gathered.

Sequence parallelism (the train step's default over a mesh): a block gets
the residual stream as the rank's chunk of the sequence.  Its norm (the
weight through ``C.seq_weight``) and residual adds run on the chunk; the
normed input comes whole through ``C.layer_in`` (an all-gather), so the
scans and convolutions take the whole sequence, and the output goes back
through ``C.layer_out`` (a reduce-scatter of the partial sums, or the
rank's chunk of a whole output).

Decode over a mesh (``cuts``, a mesh step's ``collectives.Cut`` of each
state leaf): the states come in, and go back out, placed as
``sharding.cache_shardings`` places them, on their widest inner dim.  Where
that chunk is the layer's own model shard it is computed on as it is:
mamba's conv and state on its inner channels (contiguous in rank order),
and mLSTM's conv on its channels and ``m`` on its heads where the rules
split the heads.  Every other leaf is resharded around the step
(``collectives.to_local`` / ``to_placed``: all-gathered over the placed
group, stepped on the layer's shard or whole, its placed chunk kept):
mLSTM's ``C`` and ``n`` (cut on their last dim), sLSTM's ``h``, ``c``,
``n`` and ``m`` (cut on head_dim), mLSTM's ``m`` where the heads stay
whole, and any leaf cut over the batch axes and "model" together (a batch
of one), which no layer splits that way.  A prefill returns its states so
placed.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.launch import collectives as C
from repro_torch.models.layers import (dtype_of, einsum32, init_dense,
                                       reduced_dense, rms_norm)

LOG_EPS = -30.0


def _logsigmoid(x: torch.Tensor) -> torch.Tensor:
    return -F.softplus(-x)


def _div_weak(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` with the Python scalar first rounded to x's dtype, as JAX
    takes a weakly typed scalar (rounded on the host, whatever the default
    device)."""
    return x / float(torch.tensor(c, dtype=x.dtype, device="cpu"))


def group_norm(x: torch.Tensor, scale: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Per-head group norm over the last dim.  x: (..., nh, hd)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  cache: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  x: (B, S, D); w: (K, D).  ``cache``: None or
    the (B, K-1, D) trailing inputs of the previous call.  Returns (y, the
    new (B, K-1, D) cache in x's dtype; (B, 0, D) for K = 1)."""
    K, S = w.shape[0], x.shape[1]
    if cache is None:
        ctx = F.pad(x, (0, 0, K - 1, 0))
    else:
        ctx = torch.cat([cache.to(x.dtype), x], dim=1)
    y = 0
    for i in range(K):
        y = y + ctx[:, i:i + S] * w[i]
    new_cache = (ctx[:, ctx.shape[1] - (K - 1):].clone() if K > 1
                 else x.new_zeros((x.shape[0], 0, x.shape[2])))
    return y.to(x.dtype), new_cache


def _states(tree, cuts, dims, move):
    """``move`` (``C.to_local`` or ``C.to_placed``) on each leaf of a state
    tree (nested dicts) with its cut and the dim the layer splits over the
    model group (None: whole); the tree as it is without ``cuts``."""
    if tree is None or cuts is None:
        return tree
    return {k: (_states(v, cuts[k], dims[k], move) if isinstance(v, dict)
                else move(v, cuts[k], dims[k])) for k, v in tree.items()}


def _packed_parts(up: torch.Tensor, n_parts: int, tp: bool):
    """The parts of a packed projection ``up`` (..., n_parts * width): on a
    model group that splits it, ``up`` holds the rank's column chunk of the
    packed layout, so it is gathered whole and the rank takes its chunk of
    every part; else the parts as they lie."""
    if not tp:
        return up.chunk(n_parts, dim=-1)
    whole = C.gather_mid(up, -1)
    n, r = C.model_size(), C.model_rank()
    return tuple(p.chunk(n, dim=-1)[r] for p in whole.chunk(n_parts, dim=-1))


# ===========================================================================
# mLSTM (matrix-memory xLSTM cell)
# ===========================================================================
#
# Per head, stabiliser m in log space (the JAX package's notation):
#   m_t = max(logsigmoid(f_t) + m_{t-1}, i_t)
#   C_t = e^{logsig f_t + m_{t-1} - m_t} C_{t-1} + e^{i_t - m_t} k_t v_t^T
#   n_t = e^{logsig f_t + m_{t-1} - m_t} n_{t-1} + e^{i_t - m_t} k_t
#   h_t = C_t^T q_t / max(|n_t . q_t|, e^{-m_t}),   q scaled by hd^-1/2

def mlstm_cell_step(q, k, v, i_raw, f_raw, state):
    """One decode step.  q, k, v: (B, nh, hd); i_raw, f_raw: (B, nh).
    state: dict(C (B, nh, hd, hd), n (B, nh, hd), m (B, nh)), float32."""
    hd = q.shape[-1]
    q = q.float() / math.sqrt(hd)
    k, v = k.float(), v.float()
    logf = _logsigmoid(f_raw.float())
    logi = i_raw.float()
    m_prev, C_prev, n_prev = state["m"], state["C"], state["n"]
    m_new = torch.maximum(logf + m_prev, logi)
    decay = torch.exp(logf + m_prev - m_new)[..., None]
    inp = torch.exp(logi - m_new)[..., None]
    C_new = C_prev * decay[..., None] + (inp[..., None] * k[..., :, None]
                                         * v[..., None, :])
    n_new = n_prev * decay + inp * k
    num = torch.einsum("bnij,bni->bnj", C_new, q)
    den = torch.einsum("bni,bni->bn", n_new, q).abs()
    den = torch.maximum(den, torch.exp(-m_new))[..., None]
    return num / den, {"C": C_new, "n": n_new, "m": m_new}


def mlstm_sequence(q, k, v, i_raw, f_raw, state=None, chunk: int = 64):
    """Chunkwise-parallel mLSTM.  q, k, v: (B, S, nh, hd); gates (B, S, nh).
    Returns (h (B, S, nh, hd) float32, final state)."""
    B, S, nh, hd = q.shape
    L = min(chunk, S)
    pad = (-S) % L
    if pad:
        def zpad(a):
            return F.pad(a, (0, 0) * (a.ndim - 2) + (0, pad))
        q, k, v, i_raw, f_raw = map(zpad, (q, k, v, i_raw, f_raw))
        # padded steps leave the carried state alone: input gate -> no
        # write, forget gate -> logsigmoid ~ 0, no decay
        i_raw[:, S:] = LOG_EPS * 10
        f_raw[:, S:] = 30.0
    nc = (S + pad) // L

    qf = (q.float() / math.sqrt(hd)).reshape(B, nc, L, nh, hd)
    kf = k.float().reshape(B, nc, L, nh, hd)
    vf = v.float().reshape(B, nc, L, nh, hd)
    logi = i_raw.float().reshape(B, nc, L, nh)
    logf = _logsigmoid(f_raw.float()).reshape(B, nc, L, nh)

    if state is None:
        state = mlstm_state_init(B, nh, hd, device=q.device)
    C, n, m = state["C"], state["n"], state["m"]
    above = ~torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    hs = []
    for c in range(nc):
        qc, kc, vc, li, lf = qf[:, c], kf[:, c], vf[:, c], logi[:, c], logf[:, c]
        b = lf.cumsum(dim=1)                          # (B, L, nh) inclusive
        a_t = b + m[:, None]                          # decay applied to C
        # intra-chunk log weights D[t, s] = b_t - b_s + li_s (s <= t)
        D = b[:, :, None] - b[:, None, :] + li[:, None, :]     # (B, L, L, nh)
        D = D.masked_fill(above[None, :, :, None], -math.inf)
        m_t = torch.maximum(a_t, D.amax(dim=2))
        m_t = m_t.clamp_min(-abs(LOG_EPS))            # keep denominators sane
        w_inter = torch.exp(a_t - m_t)
        P = torch.exp(D - m_t[:, :, None])
        qk = torch.einsum("blnd,bsnd->blsn", qc, kc)
        num = torch.einsum("blsn,bsnd->blnd", P * qk, vc)
        num = num + w_inter[..., None] * torch.einsum("bnij,blni->blnj", C, qc)
        den = torch.einsum("blsn,blsn->bln", P, qk)
        den = den + w_inter * torch.einsum("bni,blni->bln", n, qc)
        den = torch.maximum(den.abs(), torch.exp(-m_t))
        hs.append(num / den[..., None])
        # the state at the end of the chunk
        bL = b[:, -1]                                 # (B, nh) total log decay
        m_out = torch.maximum(bL + m, (bL[:, None] - b + li).amax(dim=1))
        w0 = torch.exp(bL + m - m_out)
        wt = torch.exp(bL[:, None] - b + li - m_out[:, None])   # (B, L, nh)
        C = C * w0[..., None, None] + torch.einsum(
            "blnd,blne->bnde", wt[..., None] * kc, vc)
        n = n * w0[..., None] + torch.einsum("blnd,bln->bnd", kc, wt)
        m = m_out
    h = torch.stack(hs, dim=1).reshape(B, nc * L, nh, hd)[:, :S]
    return h, {"C": C, "n": n, "m": m}


def mlstm_state_init(B: int, nh: int, hd: int, device):
    f32 = torch.float32
    return {"C": torch.zeros((B, nh, hd, hd), dtype=f32, device=device),
            "n": torch.zeros((B, nh, hd), dtype=f32, device=device),
            "m": torch.full((B, nh), LOG_EPS, dtype=f32, device=device)}


# --- mLSTM block (up-proj -> conv -> qkv/gates -> cell -> gated down-proj) --

def mlstm_block_init(cfg, generator: torch.Generator) -> dict:
    dt = dtype_of(cfg)
    d, nh = cfg.d_model, cfg.n_heads
    di = cfg.ssm_expand * d
    dev = generator.device
    return {
        "norm": torch.ones((d,), dtype=dt, device=dev),
        "w_up": init_dense(generator, (d, 2 * di), dtype=dt),
        "conv_w": init_dense(generator, (cfg.ssm_conv, di), scale=0.5,
                             dtype=dt),
        "wq": init_dense(generator, (di, di), dtype=dt),
        "wk": init_dense(generator, (di, di), dtype=dt),
        "wv": init_dense(generator, (di, di), dtype=dt),
        "w_if": init_dense(generator, (di, 2 * nh)),
        "b_if": torch.cat([                          # input, forget biases
            torch.zeros((nh,), dtype=torch.float32, device=dev),
            torch.linspace(3.0, 6.0, nh, dtype=torch.float32, device=dev)]),
        "gn": torch.ones((nh, di // nh), dtype=dt, device=dev),
        "w_down": init_dense(generator, (di, d),
                             scale=1.0 / math.sqrt(di * 2 * cfg.n_layers),
                             dtype=dt),
    }


def mlstm_block_spec(cfg) -> dict:
    """The logical axes of ``mlstm_block_init``'s leaves."""
    return {"norm": ("embed",), "w_up": ("embed", "inner"),
            "conv_w": ("conv", "inner"), "wq": ("inner", "inner_out"),
            "wk": ("inner", "inner_out"), "wv": ("inner", "inner_out"),
            "w_if": ("inner", None), "b_if": (None,),
            "gn": ("heads", "head_dim"), "w_down": ("inner", "embed")}


def mlstm_block_apply(cfg, p: dict, x: torch.Tensor, *, cache=None,
                      cuts=None):
    """x: (B, S, d).  cache: None or dict(conv, state).  The step form runs
    for one token against a cache, the chunkwise form otherwise.  Returns
    (x + y, the new dict(conv, state)); with ``cuts`` the states placed
    (module docstring)."""
    d = x.shape[-1]
    nh = cfg.n_heads
    di = cfg.ssm_expand * d
    hd = di // nh
    tp = C.split(p["conv_w"].shape[1], di)
    heads = tp and C.split(p["gn"].shape[0], nh)
    dims = {"conv": 2 if tp else None,
            "state": {k: 1 if heads else None for k in ("C", "n", "m")}}
    cache = _states(cache, cuts, dims, C.to_local)
    h_in = C.layer_in(rms_norm(x, C.seq_weight(p["norm"]), cfg.norm_eps), tp)
    B, S = h_in.shape[:2]
    up = einsum32("bsd,de->bse", h_in, p["w_up"], out_dtype=x.dtype)
    xm, z = _packed_parts(up, 2, tp)
    xc, new_conv = causal_conv1d(xm, p["conv_w"],
                                 None if cache is None else cache["conv"])
    xc = F.silu(xc.float()).to(x.dtype)
    def proj(a, w):
        if tp:
            return reduced_dense(a, w, x.dtype, mid=True)
        return einsum32("bsd,de->bse", a, w, out_dtype=x.dtype)
    q = proj(xc, p["wq"]).reshape(B, S, nh, hd)
    k = proj(xc, p["wk"]).reshape(B, S, nh, hd)
    k = _div_weak(k, math.sqrt(hd))        # and q / sqrt(hd) in the cell, as there
    v = proj(xm, p["wv"]).reshape(B, S, nh, hd)
    gates = einsum32("bsd,dg->bsg", xm, p["w_if"])
    gates = (C.reduce_mid(gates) if tp else gates) + (
        C.copy_to_model(p["b_if"]) if tp else p["b_if"])
    i_raw, f_raw = gates.chunk(2, dim=-1)            # (B, S, nh) each
    gn = p["gn"]
    if heads:
        # the rank's heads: its channels of the inner dim
        h0 = C.model_rank() * gn.shape[0]
        q, k, v, i_raw, f_raw = (t[:, :, h0:h0 + gn.shape[0]]
                                 for t in (q, k, v, i_raw, f_raw))
    elif tp:
        gn = C.copy_to_model(gn)

    if cache is not None and S == 1:
        h, new_state = mlstm_cell_step(q[:, 0], k[:, 0], v[:, 0], i_raw[:, 0],
                                       f_raw[:, 0], cache["state"])
        h = h[:, None]
    else:
        h, new_state = mlstm_sequence(q, k, v, i_raw, f_raw,
                                      None if cache is None else cache["state"])
    h = group_norm(h.to(x.dtype), gn, cfg.norm_eps).reshape(B, S, -1)
    if tp and h.shape[-1] == di:
        # every head on every rank: the rank's channels of them
        h = h.chunk(C.model_size(), dim=-1)[C.model_rank()]
    h = h * F.silu(z.float()).to(x.dtype)
    y = (reduced_dense(h, p["w_down"], x.dtype) if tp else C.layer_out(
        einsum32("bsd,de->bse", h, p["w_down"], out_dtype=x.dtype), False))
    return x + y, _states({"conv": new_conv, "state": new_state}, cuts, dims,
                          C.to_placed)


def mlstm_cache_init(cfg, B: int, device) -> dict:
    di = cfg.ssm_expand * cfg.d_model
    return {"conv": torch.zeros((B, cfg.ssm_conv - 1, di), dtype=torch.float32,
                                device=device),
            "state": mlstm_state_init(B, cfg.n_heads, di // cfg.n_heads,
                                      device=device)}


# ===========================================================================
# sLSTM (scalar-memory xLSTM cell, block-diagonal recurrence)
# ===========================================================================

def slstm_block_init(cfg, generator: torch.Generator) -> dict:
    dt = dtype_of(cfg)
    d, nh = cfg.d_model, cfg.n_heads
    hd = d // nh
    f_up = int(d * 4 / 3)
    dev = generator.device
    zeros = lambda n: torch.zeros((n,), dtype=torch.float32, device=dev)
    forget = torch.linspace(3.0, 6.0, nh, dtype=torch.float32, device=dev)
    return {
        "norm": torch.ones((d,), dtype=dt, device=dev),
        "w_gates": init_dense(generator, (d, 4 * d), dtype=dt),     # i,f,z,o
        "r_gates": init_dense(generator, (nh, hd, 4 * hd),          # per head
                              scale=1.0 / math.sqrt(hd), dtype=dt),
        "b_gates": torch.cat([zeros(d),
                              forget[:, None].expand(nh, hd).reshape(-1),
                              zeros(2 * d)]),
        "gn": torch.ones((nh, hd), dtype=dt, device=dev),
        "w_up1": init_dense(generator, (d, f_up), dtype=dt),
        "w_up2": init_dense(generator, (d, f_up), dtype=dt),
        "w_down": init_dense(generator, (f_up, d),
                             scale=1.0 / math.sqrt(f_up * 2 * cfg.n_layers),
                             dtype=dt),
    }


def slstm_block_spec(cfg) -> dict:
    """The logical axes of ``slstm_block_init``'s leaves."""
    return {"norm": ("embed",), "w_gates": ("embed", "inner"),
            "r_gates": ("heads", "head_dim", None), "b_gates": (None,),
            "gn": ("heads", "head_dim"), "w_up1": ("embed", "mlp"),
            "w_up2": ("embed", "mlp"), "w_down": ("mlp", "embed")}


def _slstm_step(r_gates: torch.Tensor, b_h: torch.Tensor, carry, wx_t):
    """carry: (h, c, n, m) each (B, nh, hd) float32; wx_t: (B, nh, 4 hd), the
    input preactivation regrouped per head; r_gates (nh, hd, 4 hd) and b_h
    (nh, 4 hd) float32.  Returns (new carry, h)."""
    h, c, n, m = carry
    rec = torch.einsum("bnh,nhg->bng", h, r_gates)              # (B, nh, 4hd)
    pre = wx_t + rec + b_h
    ii, ff, zz, oo = pre.chunk(4, dim=-1)                       # (B, nh, hd)
    logf = _logsigmoid(ff)
    m_new = torch.maximum(logf + m, ii)
    i_act = torch.exp(ii - m_new)
    f_act = torch.exp(logf + m - m_new)
    c_new = f_act * c + i_act * torch.tanh(zz)
    n_new = (f_act * n + i_act).clamp_min(1e-6)
    h_new = torch.sigmoid(oo) * (c_new / n_new)
    return (h_new, c_new, n_new, m_new), h_new


def slstm_block_apply(cfg, p: dict, x: torch.Tensor, *, cache=None,
                      cuts=None):
    """x: (B, S, d); a Python loop over time (sLSTM is serial), then the
    post-FFN, a GELU GLU of width 4/3 d (GELU's tanh form, ``jax.nn.gelu``'s
    default).  Returns (x, dict(state)); with ``cuts`` the state placed
    (module docstring)."""
    d = x.shape[-1]
    nh = cfg.n_heads
    hd = d // nh
    tp = C.split(p["w_gates"].shape[1], 4 * d)
    heads = C.split(p["r_gates"].shape[0], nh)     # the rank's heads only
    if heads and not tp:
        raise ValueError("sLSTM heads split over a model group whose size "
                         "does not divide the gate width")
    dims = {"state": {k: 1 if heads else None for k in ("h", "c", "n", "m")}}
    cache = _states(cache, cuts, dims, C.to_local)
    norm = C.seq_weight(p["norm"])
    h_in = C.layer_in(rms_norm(x, norm, cfg.norm_eps), tp)
    B, S = h_in.shape[:2]
    wx = einsum32("bsd,dg->bsg", h_in, p["w_gates"])            # (B, S, 4d) f32
    if tp:
        # the rules' column chunk of the packed [i | f | z | o], made whole
        wx = (C.gather_mid if heads else C.gather_from_model)(wx, -1)
    # [i(d), f(d), z(d), o(d)] -> per head [i, f, z, o] (hd each)
    wx = wx.reshape(B, S, 4, nh, hd).transpose(2, 3).reshape(B, S, nh, 4 * hd)
    b_gates = C.copy_to_model(p["b_gates"]) if heads else p["b_gates"]
    b_h = b_gates.reshape(4, nh, hd).transpose(0, 1).reshape(nh, 4 * hd)
    if heads:
        h0 = C.model_rank() * p["r_gates"].shape[0]
        wx = wx[:, :, h0:h0 + p["r_gates"].shape[0]]
        b_h = b_h[h0:h0 + p["r_gates"].shape[0]]
    r = p["r_gates"].float()
    state = (slstm_state_init(cfg, B, x.device, r.shape[0]) if cache is None
             else cache)["state"]
    carry = tuple(state[k] for k in ("h", "c", "n", "m"))
    hs = []
    for t in range(S):
        carry, h_t = _slstm_step(r, b_h, carry, wx[:, t])
        hs.append(h_t)
    y = group_norm(torch.stack(hs, dim=1).to(x.dtype), p["gn"],
                   cfg.norm_eps).reshape(B, S, -1)
    if heads:
        y = C.gather_from_model(y, -1)
    x = x + C.layer_out(y, False)
    f_up = int(d * 4 / 3)
    ffn_tp = C.split(p["w_up1"].shape[1], f_up)
    hf = C.layer_in(rms_norm(x, norm, cfg.norm_eps), ffn_tp)
    up = F.gelu(einsum32("bsd,df->bsf", hf, p["w_up1"]),
                approximate="tanh").to(x.dtype)
    up = up * einsum32("bsd,df->bsf", hf, p["w_up2"], out_dtype=x.dtype)
    x = x + (reduced_dense(up, p["w_down"], x.dtype) if ffn_tp else
             C.layer_out(einsum32("bsf,fd->bsd", up, p["w_down"],
                                  out_dtype=x.dtype), False))
    return x, _states({"state": dict(zip(("h", "c", "n", "m"), carry))},
                      cuts, dims, C.to_placed)


def slstm_state_init(cfg, B: int, device, heads: Optional[int] = None
                     ) -> dict:
    """The zero state of ``heads`` heads (the config's by default)."""
    nh = cfg.n_heads
    shape = (B, heads or nh, cfg.d_model // nh)
    z = lambda: torch.zeros(shape, dtype=torch.float32, device=device)
    return {"state": {"h": z(), "c": z(), "n": z(),
                      "m": torch.full(shape, LOG_EPS, dtype=torch.float32,
                                      device=device)}}


# ===========================================================================
# Mamba-style selective SSM (Hymba's SSM heads)
# ===========================================================================

def mamba_init(cfg, generator: torch.Generator) -> dict:
    dt = dtype_of(cfg)
    d = cfg.d_model
    di = cfg.ssm_expand * d
    N = cfg.ssm_state
    dt_rank = max(d // 16, 1)
    dev = generator.device
    # S4D-real initialisation of A; dt in [1e-3, 1e-1], log-uniform, and
    # b_dt its inverse softplus
    A = torch.arange(1, N + 1, dtype=torch.float32, device=dev).expand(di, N)
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand((di,), generator=generator, dtype=torch.float32,
                   device=dev) * (hi - lo) + lo
    return {
        "w_in": init_dense(generator, (d, 2 * di), dtype=dt),
        "conv_w": init_dense(generator, (cfg.ssm_conv, di), scale=0.5,
                             dtype=dt),
        "w_x": init_dense(generator, (di, dt_rank + 2 * N), dtype=dt),
        "w_dt": init_dense(generator, (dt_rank, di)),
        "b_dt": torch.log(torch.expm1(torch.exp(u))),
        "A_log": torch.log(A),
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "w_out": init_dense(generator, (di, d),
                            scale=1.0 / math.sqrt(di * 2 * cfg.n_layers),
                            dtype=dt),
    }


def mamba_spec(cfg) -> dict:
    """The logical axes of ``mamba_init``'s leaves."""
    return {"w_in": ("embed", "inner"), "conv_w": ("conv", "inner"),
            "w_x": ("inner", None), "w_dt": (None, "inner_out"),
            "b_dt": ("inner_out",), "A_log": ("inner_out", "state"),
            "D": ("inner_out",), "w_out": ("inner", "embed")}


def _affine_scan(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """h_t = da_t h_{t-1} + db_t along axis 1 from h_{-1} = 0, for every t:
    the inclusive scan of the maps (a, b) under (a1, b1) then (a2, b2) ->
    (a1 a2, a2 b1 + b2), the combine of the JAX package's
    ``associative_scan``, in log2(S) doubling steps.  Step s combines each
    t >= s with t - s; two buffers a side alternate, so no step reads what
    it writes.  Consumes ``da`` and ``db`` (their storage is reused).
    Where a gradient is wanted the same steps run out of place, as autograd
    needs (``out=`` is not differentiable), with the same arithmetic."""
    S = da.shape[1]
    if torch.is_grad_enabled() and (da.requires_grad or db.requires_grad):
        a, b, s = da, db, 1
        while s < S:
            b = torch.cat([b[:, :s], torch.addcmul(b[:, s:], a[:, s:],
                                                   b[:, :S - s])], dim=1)
            if 2 * s < S:
                a = torch.cat([a[:, :s], a[:, :S - s] * a[:, s:]], dim=1)
            s *= 2
        return b
    a, b = da, db
    a2, b2 = torch.empty_like(a), torch.empty_like(b)
    s = 1
    while s < S:
        b2[:, :s] = b[:, :s]
        torch.addcmul(b[:, s:], a[:, s:], b[:, :S - s], out=b2[:, s:])
        b, b2 = b2, b
        if 2 * s < S:                     # the last step needs no new a
            a2[:, :s] = a[:, :s]
            torch.mul(a[:, :S - s], a[:, s:], out=a2[:, s:])
            a, a2 = a2, a
        s *= 2
    return b


def mamba_apply(cfg, p: dict, x: torch.Tensor, *, cache=None, cuts=None):
    """Selective SSM.  x: (B, S, d) -> (B, S, d).  cache: dict(conv, state)
    or None.  Returns (out, dict(conv, state (B, d_inner, N) float32)); with
    ``cuts`` the states placed (module docstring)."""
    N = cfg.ssm_state
    dt_rank = p["w_x"].shape[1] - 2 * N
    tp = C.split(p["conv_w"].shape[1], cfg.ssm_expand * x.shape[-1])
    dims = {"conv": 2 if tp else None, "state": 1 if tp else None}
    cache = _states(cache, cuts, dims, C.to_local)
    x = C.layer_in(x, tp)
    S = x.shape[1]

    up = einsum32("bsd,de->bse", x, p["w_in"], out_dtype=x.dtype)
    xm, z = _packed_parts(up, 2, tp)
    u, new_conv = causal_conv1d(xm, p["conv_w"],
                                None if cache is None else cache["conv"])
    u = F.silu(u.float())                                         # (B, S, di)
    xproj = einsum32("bsd,dr->bsr", u.to(x.dtype), p["w_x"])      # float32
    if tp:
        xproj = C.reduce_mid(xproj)
    dt_in, Bc, Cc = xproj.split([dt_rank, N, N], dim=-1)
    dt = F.softplus(dt_in @ p["w_dt"] + p["b_dt"])                # (B, S, di)
    A = -torch.exp(p["A_log"])                                    # (di, N)
    da = torch.exp(dt[..., None] * A)                             # (B, S, di, N)
    db = (dt * u)[..., None] * Bc[:, :, None, :]

    if cache is not None and S == 1:
        h = da[:, 0] * cache["state"] + db[:, 0]                  # (B, di, N)
        y = torch.einsum("bdn,bn->bd", h, Cc[:, 0])[:, None]
        new_state = h
    else:
        if cache is not None:
            db[:, 0] += da[:, 0] * cache["state"]
        hs = _affine_scan(da, db)
        del da, db
        y = torch.einsum("bsdn,bsn->bsd", hs, Cc)
        new_state = hs[:, -1].clone()             # not a view of the scan
        del hs
    y = y + p["D"] * u
    y = y * F.silu(z.float())
    if tp:
        out = reduced_dense(y.to(x.dtype), p["w_out"], x.dtype)
    else:
        out = C.layer_out(einsum32("bsd,de->bse", y.to(x.dtype), p["w_out"],
                                   out_dtype=x.dtype), False)
    return out, _states({"conv": new_conv, "state": new_state}, cuts, dims,
                        C.to_placed)


def mamba_cache_init(cfg, B: int, device) -> dict:
    di = cfg.ssm_expand * cfg.d_model
    return {"conv": torch.zeros((B, cfg.ssm_conv - 1, di), dtype=torch.float32,
                                device=device),
            "state": torch.zeros((B, di, cfg.ssm_state), dtype=torch.float32,
                                 device=device)}
