"""The vectorized RAN MAC on PyTorch: the counterpart of
``repro/core/ran_vec.py``, with the TTI loop as a branch-free step function
over tensors on ``device``.

``core/ran.py`` stays the bitwise ORACLE: every grant, HARQ outcome,
finish timestamp, PF EWMA value and counter this module produces equals
the Python engine's (and the JAX package's vectorized engine's) exactly,
on the card and on the CPU.  The shape of the work is the JAX package's:

  * One step per TTI over the flow axis.  The per-TTI scheduler state
    (byte queues, HARQ ledgers, PRB grants, EWMA rates, finish times)
    rides in a carry of float64/int64 tensors.  The JAX package runs the
    steps as a ``lax.scan``; here each step is a run of eager PyTorch ops
    on the device, and the host reads the latched stop code after every
    step (the JAX host reads it once per chunk of 64-4096 steps), so no
    step runs after the loop stops.  The HARQ tape is filled per chunk of
    the same schedule (``_chunk_schedule``), so the draws taken from the
    caller's Generator are the JAX package's, call for call.
  * RR / PF / EDF grants are the closed forms of ``_grant_kernel``: PF
    and EDF a stable lexsort plus an int64 cumulative-sum greedy fill,
    RR a water level by integer bisection plus a rotated rank.
  * HARQ uniforms are PRE-DRAWN from the caller's numpy Generator into a
    flat tape (``_UniformTape``) and consumed through a moving pointer;
    values not consumed stay on the tape for the next call.

The JAX package's ``_grant_fast`` has no counterpart.  It picks between a
top-K candidate path and the exact full-lane sort through ``lax.cond``,
and exists because an f64 sort is slow on XLA:CPU; both give the same
allocation.  In eager PyTorch a per-TTI choice would cost a host sync per
TTI, so every grant here takes the exact path, and the stream's granted
lanes (``granted_of``) come from a stable argsort, cut to KD rows.  The
``lax.cond``s of the stream step become ``torch.where`` selections: both
branches are computed and one is kept.

Exactness discipline (why the odd-looking bits exist):

  * Every tensor has an explicit dtype, float64 or int64 (bool masks
    aside): PyTorch's factories default to float32.
  * No fused multiply-add: eager elementwise ops round each product on
    its own.  ``_seal`` still pipes ``k * tti`` and both PF EWMA terms
    through an int64 view xor a runtime zero, where the JAX package does,
    so that a later graph or fused kernel cannot contract them either.
    No fused op (``addcmul``, ``lerp``, ``add(alpha=)``) touches a value
    the oracle can observe.
  * Sorting is stable (``torch.sort(stable=True)``) only, with float keys
    passed through ``+ 0.0`` so -0.0 and +0.0 tie as in ``np.lexsort``
    (the card sorts by radix, which would order them).
  * Every divisor is a tensor.  PyTorch on CUDA divides a tensor by a
    Python scalar as a product with the scalar's reciprocal, which is not
    correctly rounded (PF's served rate came out an ulp off on the card);
    so ``tti`` rides into the step as a 0-d float64 tensor on the device,
    and every ``/`` rounds as numpy's does.
  * No host sync inside a step: a 0-d index tensor is used as a 1-element
    index (``x[i]`` with a 0-d ``i`` reads it on the host), and no value
    is written from the host.
  * No float ``cumsum`` and no float ``sum`` in the step: the only
    prefix sums are int64.  The float scatter-add of PF's served rate
    adds one value and +0.0s per UE, exact in any order.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.ran import (DeadlineEDFScheduler, GrantReport,
                                  ProportionalFairScheduler, RanCell,
                                  RanConfig, RoundRobinScheduler,
                                  SchedulerPolicy, StreamFlow, UplinkRequest,
                                  MCS_SE, RE_PER_PRB)

F64, I64 = torch.float64, torch.int64

# policy codes
_RR, _PF, _EDF = 0, 1, 2
_POLICY_CODE = {RoundRobinScheduler: _RR, ProportionalFairScheduler: _PF,
                DeadlineEDFScheduler: _EDF}
_PF_ALPHA = ProportionalFairScheduler.alpha
_PF_EPS = ProportionalFairScheduler.eps_bps

# stop codes latched by the step, read by the host loop
_RUNNING, _DONE, _TIME_UP, _TAPE_OUT, _SLOT_GUARD = 0, 1, 2, 3, 4

# tape chunk budget: at most this many pre-drawn uniforms in flight
_MAX_BUF = 1 << 22


def policy_code(policy: SchedulerPolicy) -> int:
    """Code of an oracle policy instance; rejects subclasses (their
    overridden ``grant`` could not be replicated)."""
    code = _POLICY_CODE.get(type(policy))
    if code is None:
        raise ValueError(
            f"engine='vectorized' supports exactly the stock rr/pf/edf "
            f"schedulers; got {type(policy).__name__} (run the Python "
            f"engine for custom policies)")
    return code


def _pad_len(n: int, floor: int = 8) -> int:
    """Next power of two, at least ``floor`` (bucketing for growing axes)."""
    p = floor
    while p < n:
        p <<= 1
    return p


def mcs_index_vec(bits_per_prb: np.ndarray) -> np.ndarray:
    """Vector form of ``ran.mcs_index``: last MCS with SE <= payload."""
    se = np.asarray(bits_per_prb, float) / RE_PER_PRB
    return np.maximum(
        np.searchsorted(np.asarray(MCS_SE), se, side="right") - 1, 0)


# ---------------------------------------------------------------------------
# step building blocks (f64/i64 throughout; a leading cell axis where noted)
# ---------------------------------------------------------------------------

def _seal(v: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Round-trip a float64 product through its int64 bits xor a RUNTIME
    zero ``z``: no compiler can contract the following add into an FMA or
    cancel the xor.  Bitwise identity on the value itself."""
    return (v.view(I64) ^ z).view(F64)


def _lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """``np.lexsort`` along the last axis: the LAST key is the primary
    one, ties keep index order.  One stable sort per key, from the first
    (least significant) to the last.  Float keys go through ``+ 0.0``,
    which maps -0.0 to +0.0 and leaves every other value (inf, NaN)
    as it is, so the two zeros tie as they do in numpy's comparison sort."""
    perm = None
    for key in keys:
        k = key if perm is None else key.gather(-1, perm)
        if k.is_floating_point():
            k = k + 0.0
        idx = torch.sort(k, dim=-1, stable=True).indices
        perm = idx if perm is None else perm.gather(-1, idx)
    return perm


def _greedy_alloc(order, need, n_prbs: int):
    """Closed form of ``ran._greedy_fill`` on a full permutation (per row
    of ``order``): each request sees the grid minus everything granted
    before it."""
    no = need.gather(-1, order)
    cum = no.cumsum(-1)
    fill = torch.minimum((n_prbs - (cum - no)).clamp_min(0), no)
    return torch.zeros_like(need).scatter(-1, order, fill)


def _divisor(x: float, device) -> torch.Tensor:
    """``x`` as a 0-d float64 tensor on ``device``, for use as a divisor:
    on CUDA, ``t / python_float`` multiplies by the reciprocal instead."""
    return torch.tensor(x, dtype=F64, device=device)


def _need_prbs(active, rem, bpp):
    """Twin of ``SlotView.need_prbs``."""
    return torch.where(active, torch.ceil(rem / bpp), 0.0).to(I64)


def _grant_kernel(policy: int, n_prbs: int, active, need, dead, ue, bpp,
                  tti: torch.Tensor, rr_ptr, pf_avg):
    """One TTI's PRB allocation for every row (cell) of ``active`` (C, n)
    -- the vectorized twin of ``policy.grant(view)``.  Inactive lanes
    carry zero need and +inf sort keys, so their presence never changes an
    active lane's grant.  ``rr_ptr`` is (C,), ``pf_avg`` (C, n_ues), ``tti``
    a 0-d float64 tensor (a divisor)."""
    inf = math.inf
    if policy == _EDF:
        order = _lexsort((ue, need, torch.where(active, dead, inf)))
        return _greedy_alloc(order, need, n_prbs)
    if policy == _PF:
        inst = bpp * n_prbs / tti
        metric = inst / pf_avg.gather(-1, ue).clamp_min(_PF_EPS)
        order = _lexsort((ue, torch.where(active, -metric, inf)))
        return _greedy_alloc(order, need, n_prbs)
    # RR: water level by integer bisection, remainder by rotated rank
    n = need.shape[-1]
    act = active.to(I64)
    safe = act.sum(-1).clamp_min(1)[:, None]
    arank = act.cumsum(-1) - 1
    start = rr_ptr[:, None] % safe
    rot = torch.where(active, (arank - start) % safe, n)
    lo = torch.zeros_like(rr_ptr)
    hi = torch.full_like(rr_ptr, n_prbs)
    for _ in range(max(int(n_prbs).bit_length() + 1, 1)):
        mid = (lo + hi + 1) // 2
        ok = torch.minimum(need, mid[:, None]).sum(-1) <= n_prbs
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid - 1)
    level = lo[:, None]
    got = torch.minimum(need, level)
    left = n_prbs - got.sum(-1, keepdim=True)
    unsat = need > level
    by_rot = torch.sort(rot, dim=-1, stable=True).indices
    u_sorted = unsat.gather(-1, by_rot)
    bonus_sorted = u_sorted & (u_sorted.to(I64).cumsum(-1) - 1 < left)
    bonus = torch.zeros_like(unsat).scatter(-1, by_rot, bonus_sorted)
    return got + bonus.to(I64)


def _granted_of(alloc, kd: int):
    """The first ``kd`` lanes of a stable argsort of ``alloc == 0``: every
    granted lane (each grant is >= 1 PRB, so at most n_prbs < kd of them),
    in index order, then distinct ungranted lanes."""
    return torch.sort((alloc == 0).to(torch.uint8), stable=True).indices[:kd]


def _pf_observe(pf_avg, active, delivered, ue, tti: torch.Tensor, z):
    """Twin of ``ProportionalFairScheduler.observe`` per row.  The active
    UEs of a row are unique, and every other lane adds +0.0, so the
    scatter-add gives the oracle's fancy-index assignment in any order."""
    served = torch.zeros_like(pf_avg).scatter_add(
        -1, ue, torch.where(active, delivered / tti, 0.0))
    return (_seal((1.0 - _PF_ALPHA) * pf_avg, z)
            + _seal(_PF_ALPHA * served, z))


def _pf_observe_sparse(pf_avg, gidx, gvalid, ue, delivered_g,
                       tti: torch.Tensor, z):
    """``_pf_observe`` scattering only the lanes ``gidx`` (validity mask
    ``gvalid``, pre-gathered deliveries) of one cell.  Active-but-unserved
    lanes add exactly +0.0 in the dense version and the accumulator never
    goes negative (so no -0.0): dropping them is bitwise free."""
    served = torch.zeros_like(pf_avg).index_add(
        0, ue[gidx], torch.where(gvalid, delivered_g / tti, 0.0))
    return (_seal((1.0 - _PF_ALPHA) * pf_avg, z)
            + _seal(_PF_ALPHA * served, z))


# ---------------------------------------------------------------------------
# the lock-step slot: one step per TTI of RanCell.serve_slot, over cells
# ---------------------------------------------------------------------------

class _SlotCarry(NamedTuple):
    """Per-cell state of the slot loop; scalars are (C,), lanes (C, n)."""
    code: torch.Tensor      # i64 stop code
    k: torch.Tensor         # i64 TTI index
    ptr: torch.Tensor       # i64 tape pointer (reset per chunk)
    rr_ptr: torch.Tensor    # i64 RR remainder pointer
    z: torch.Tensor         # i64 runtime zero for _seal
    rem: torch.Tensor       # f64 bits left
    fin: torch.Tensor       # f64 finish time (NaN while undrained)
    grt: torch.Tensor       # i64 PRBs granted
    act: torch.Tensor       # i64 TTIs with data pending
    ntx: torch.Tensor       # i64 transport blocks sent
    nrx: torch.Tensor       # i64 of which failed
    pfa: torch.Tensor       # f64 PF EWMA per UE, (C, n_ues); (C, 0) else


def _slot_carry(k0, rr_ptr, rem, fin, pfa, device) -> _SlotCarry:
    """Initial carry from host arrays: ``k0``, ``rr_ptr`` (C,); ``rem``,
    ``fin`` (C, n) float; ``pfa`` (C, n_ues) float."""
    C, n = rem.shape
    zc = torch.zeros(C, dtype=I64, device=device)
    zl = torch.zeros((C, n), dtype=I64, device=device)
    i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device)
    return _SlotCarry(zc.clone(), i64(k0), zc.clone(), i64(rr_ptr), zc,
                      f64(rem), f64(fin), zl.clone(), zl.clone(), zl.clone(),
                      zl, f64(pfa))


def _slot_step(c: _SlotCarry, enq, dead, bpp, ue, buf, n_draw, lanes, *,
               tti: torch.Tensor, bler: float, max_slots: int, n_prbs: int,
               policy: int):
    """One TTI of ``RanCell.serve_slot`` for every cell at once (the body
    of the JAX package's ``_slot_chunk_impl``).  ``n_draw`` (C,) uniforms
    are consumed per EXECUTED TTI from ``buf`` (C, L) (= each cell's REAL
    request count: padded lanes read past the pointer but are inactive,
    so the rng stream stays paired with the oracle); idle-gap jumps
    consume neither a draw nor a TTI; a stopped cell's state stands.
    Returns the new carry and ``(k, alloc, delivered, fail, exec_t)``."""
    now = _seal(c.k.to(F64) * tti, c.z)
    undrained = c.rem > 0.0
    done_all = ~undrained.any(-1)
    hit_max = c.k >= max_slots
    active = (enq <= now[:, None]) & undrained
    any_act = active.any(-1)
    running = c.code == _RUNNING
    new_code = torch.where(~running, c.code, torch.where(
        done_all, _DONE, torch.where(hit_max, _SLOT_GUARD, _RUNNING)))
    exec_t = running & ~done_all & ~hit_max & any_act
    idle_t = running & ~done_all & ~hit_max & ~any_act

    need = _need_prbs(active, c.rem, bpp)
    alloc = _grant_kernel(policy, n_prbs, active, need, dead, ue, bpp, tti,
                          c.rr_ptr, c.pfa)
    sent = torch.minimum(c.rem, alloc * bpp)
    # the JAX package's dynamic_slice: the start clamps so n lanes fit
    start = c.ptr.clamp(0, buf.shape[-1] - lanes.shape[0])
    u = buf.gather(-1, start[:, None] + lanes)
    fail = (u < bler) & (alloc > 0)
    delivered = torch.where(fail, 0.0, sent)
    rem2 = c.rem - delivered
    newly = (rem2 <= 1e-9) & torch.isnan(c.fin)
    fin2 = torch.where(newly, (now + tti)[:, None], c.fin)
    rem3 = torch.where(rem2 <= 1e-9, 0.0, rem2)

    # idle gap: the next payload's first eligible TTI (finite whenever a
    # queue is undrained, the only case it is kept)
    pend_min = torch.where(undrained, enq, math.inf).amin(-1)
    k_idle = torch.ceil(torch.where(done_all, 0.0, pend_min) / tti).to(I64)

    ex = exec_t[:, None]
    w = lambda a, b: torch.where(ex, a, b)
    c2 = _SlotCarry(
        new_code,
        torch.where(exec_t, c.k + 1, torch.where(idle_t, k_idle, c.k)),
        torch.where(exec_t, c.ptr + n_draw, c.ptr),
        torch.where(exec_t, c.rr_ptr + 1, c.rr_ptr) if policy == _RR
        else c.rr_ptr,
        c.z, w(rem3, c.rem), w(fin2, c.fin), w(c.grt + alloc, c.grt),
        w(c.act + active.to(I64), c.act),
        w(c.ntx + (alloc > 0).to(I64), c.ntx),
        w(c.nrx + fail.to(I64), c.nrx),
        w(_pf_observe(c.pfa, active, delivered, ue, tti, c.z[:, None]),
          c.pfa)
        if policy == _PF else c.pfa)
    return c2, (c.k, alloc, delivered, fail, exec_t)


def _run_slot_chunk(carry: _SlotCarry, args, steps: int, record: bool,
                    **kw) -> Tuple[_SlotCarry, list]:
    """Up to ``steps`` slot steps; stops early once no cell is running
    (the steps left would change nothing: the stop code latches)."""
    ys = []
    for _ in range(steps):
        carry, y = _slot_step(carry, *args, **kw)
        if record:
            ys.append(y)
        if not bool((carry.code == _RUNNING).any()):
            break
    return carry, ys


# ---------------------------------------------------------------------------
# the stream: one step per TTI of RanStream.advance, one cell
# ---------------------------------------------------------------------------

class _StreamCarry(NamedTuple):
    """State of the stream loop; scalars are 0-d, lanes (F,)."""
    code: torch.Tensor       # i64 stop code
    k: torch.Tensor          # i64 TTI index
    ptr: torch.Tensor        # i64 tape pointer (reset per chunk)
    nstep: torch.Tensor      # i64 TTIs executed in this advance
    rr_ptr: torch.Tensor     # i64 RR remainder pointer
    z: torch.Tensor          # i64 runtime zero for _seal
    rem: torch.Tensor        # f64 bits left
    fin: torch.Tensor        # f64 finish time
    grt: torch.Tensor        # i64 PRBs granted
    act: torch.Tensor        # i64 TTIs active
    ntx: torch.Tensor        # i64 transport blocks sent
    nrx: torch.Tensor        # i64 of which failed
    pfa: torch.Tensor        # f64 PF EWMA per UE
    is_hol: torch.Tensor     # bool (F+1,): head-of-line flow of its UE
    open_cnt: torch.Tensor   # i64 open flows per cohort segment
    n_live: torch.Tensor     # i64 undrained flows
    n_drained: torch.Tensor  # i64 flows drained in this advance


def _stream_step(c: _StreamCarry, enq, dead, bpp, ue, seg, seg_size,
                 nxt_flow, enq_sorted, fail_bits, *, valid_len: int,
                 tti: torch.Tensor, max_slots: int, until: float,
                 n_prbs: int,
                 policy: int) -> _StreamCarry:
    """One TTI of ``RanStream.advance`` over ALL tracked flows (the body
    of the JAX package's ``_stream_chunk``; padded rows point at an empty
    cohort segment, so they neither draw nor transmit).  Per executed TTI
    one uniform per flow of every unretired cohort, in admission order,
    arrives as a PRE-COMPARED fail bit (``u < bler`` done on the host).

    Per-TTI derived state is kept INCREMENTALLY in the carry:

      * ``is_hol[F+1]``: a UE's earliest-admitted undrained flow claims
        the queue.  Only HOL flows are granted, so at most one flow per UE
        drains per TTI, and its successor is the static next-same-UE
        index ``nxt_flow``.  Slot F is the target of chain tails and of
        every row that drains nothing: it takes writes in an undefined
        order, and only ``is_hol[:F]`` is ever read as a lane (``hol2[tgt]``
        at F is written back to F alone).
      * ``open_cnt[n_seg]``: the oracle's ``_cohort_open`` counter per
        cohort segment; the per-TTI draw count is the segment-size sum
        over open segments, and the draw list is a contiguous prefix
        while every real segment stays open.
      * ``n_live`` / ``n_drained``: drained flows were granted, hence
        eligible, so the eligible count is ``searchsorted(enq_sorted,
        now) - n_drained`` and the next arrival is ``enq_sorted[cnt]``.

    The two branches of the JAX package's ``lax.cond`` (an executed TTI,
    or the idle jump / stop) are both computed and one is kept."""
    F = enq.shape[0]
    now = _seal(c.k.to(F64) * tti, c.z)
    live_any = c.n_live > 0
    time_up = now >= until - 1e-12
    cnt_enq = torch.searchsorted(enq_sorted, now.reshape(1), right=True)[0]
    any_elig = cnt_enq - c.n_drained > 0
    hit_max = c.nstep >= max_slots
    seg_open = c.open_cnt > 0
    nd = torch.where(seg_open, seg_size, 0).sum()
    can_draw = c.ptr + nd <= valid_len
    exec_t = live_any & ~time_up & any_elig & ~hit_max & can_draw

    # -- an executed TTI ------------------------------------------------------
    # every grant is >= 1 PRB, so at most n_prbs lanes (gdx) change state
    active = (c.rem > 0.0) & (enq <= now) & c.is_hol[:F]
    need = _need_prbs(active, c.rem, bpp)
    alloc = _grant_kernel(policy, n_prbs, active[None], need[None],
                          dead[None], ue[None], bpp[None], tti,
                          c.rr_ptr.reshape(1), c.pfa[None])[0]
    gdx = _granted_of(alloc, min(F, _pad_len(n_prbs + 1, 128)))
    alloc_g = alloc[gdx]
    gvalid = alloc_g > 0
    # real flows sit in lanes [0, n): while every real segment is open
    # the drawn lanes are exactly that prefix and a lane's draw rank is
    # its own index
    contig = (seg_open | (seg_size == 0)).all()
    rank_g = torch.where(
        contig, gdx, (c.open_cnt[seg] > 0).to(I64).cumsum(0)[gdx] - 1)
    u_fail = fail_bits[(c.ptr + rank_g).clamp(0, fail_bits.shape[0] - 1)]
    rem_g = c.rem[gdx]
    sent_g = torch.minimum(rem_g, alloc_g * bpp[gdx])
    fail_g = u_fail & gvalid
    delivered_g = torch.where(fail_g, 0.0, sent_g)
    rem2_g = rem_g - delivered_g
    # unserved live lanes keep rem > 1e-9 (the oracle zeroes on drain),
    # so drains happen only on granted lanes
    newly_g = gvalid & (rem2_g <= 1e-9)
    ndrain = newly_g.to(I64).sum()
    fin2 = c.fin.index_put((gdx,), torch.where(newly_g, now + tti,
                                               c.fin[gdx]))
    rem3 = c.rem.index_put((gdx,), torch.where(newly_g, 0.0, rem2_g))
    open2 = c.open_cnt.index_add(0, seg[gdx], -newly_g.to(I64))
    hol2 = c.is_hol.index_put((gdx,), c.is_hol[gdx] & ~newly_g)
    tgt = torch.where(newly_g, nxt_flow[gdx], F)
    hol3 = hol2.index_put((tgt,), hol2[tgt] | newly_g)
    pfa2 = (_pf_observe_sparse(c.pfa, gdx, gvalid, ue, delivered_g, tti,
                               c.z) if policy == _PF else c.pfa)
    rr2 = (torch.where(active.any(), c.rr_ptr + 1, c.rr_ptr)
           if policy == _RR else c.rr_ptr)

    # -- no TTI: the idle jump, or a stop ------------------------------------
    # pending flows all have enq > now (drained ones were eligible), so
    # the earliest pending arrival is the next entry of the sorted
    # (inf-padded) arrival list; it is finite wherever the jump is kept
    pend_min = enq_sorted[cnt_enq.clamp(0, enq_sorted.shape[0] - 1)
                          .reshape(1)][0]
    nxt_k = torch.ceil(torch.where(torch.isinf(pend_min), 0.0, pend_min)
                       / tti).to(I64)
    jump_stop = nxt_k.to(F64) * tti >= until - 1e-12
    idle_t = live_any & ~time_up & ~any_elig & ~jump_stop
    k_rest = torch.where(idle_t, torch.maximum(c.k, nxt_k), c.k)
    code_rest = torch.where(~live_any, _DONE, torch.where(
        time_up, _TIME_UP, torch.where(
            ~any_elig & jump_stop, _TIME_UP, torch.where(
                any_elig & hit_max, _SLOT_GUARD, torch.where(
                    any_elig & ~can_draw, _TAPE_OUT, _RUNNING)))))

    # an executed TTI leaves the code RUNNING: its guards all passed
    running = c.code == _RUNNING
    go = running & exec_t
    w = lambda a, b: torch.where(go, a, b)
    return _StreamCarry(
        torch.where(running & ~exec_t, code_rest, c.code),
        torch.where(go, c.k + 1, torch.where(running, k_rest, c.k)),
        w(c.ptr + nd, c.ptr), w(c.nstep + 1, c.nstep), w(rr2, c.rr_ptr),
        c.z, w(rem3, c.rem), w(fin2, c.fin),
        w(c.grt.index_add(0, gdx, torch.where(gvalid, alloc_g, 0)), c.grt),
        w(c.act + active.to(I64), c.act),
        w(c.ntx.index_add(0, gdx, gvalid.to(I64)), c.ntx),
        w(c.nrx.index_add(0, gdx, fail_g.to(I64)), c.nrx),
        w(pfa2, c.pfa), w(hol3, c.is_hol), w(open2, c.open_cnt),
        w(c.n_live - ndrain, c.n_live), w(c.n_drained + ndrain, c.n_drained))


# ---------------------------------------------------------------------------
# host-side loop state
# ---------------------------------------------------------------------------

class _UniformTape:
    """The tail of a numpy Generator's uniform stream, pre-drawn.  The
    step consumes values through a pointer; anything drawn but not
    consumed stays here, so across calls the (tape + generator) pair
    yields exactly the oracle's draw sequence."""

    def __init__(self):
        self.buf = np.empty(0, np.float64)

    def fill(self, rng: np.random.Generator, want: int):
        if self.buf.size < want:
            self.buf = np.concatenate(
                [self.buf, rng.random(want - self.buf.size)])

    def consume(self, count: int):
        self.buf = self.buf[count:]


def _chunk_schedule(n_lanes: int):
    """Steps per tape chunk: start small (tiny slots should not pre-draw
    for 4k steps), grow geometrically, respect the tape budget."""
    cap = max(_MAX_BUF // max(n_lanes, 1), 16)
    steps = 64
    while True:
        yield min(steps, cap)
        steps = min(steps * 4, 4096)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _request_arrays(requests: Sequence[UplinkRequest]) -> Dict[str, np.ndarray]:
    """One cell's ``UplinkRequest`` list as the batch arrays of
    ``_serve_cells``."""
    return dict(ue=np.array([r.ue_id for r in requests], int),
                n_bytes=np.array([r.n_bytes for r in requests], int),
                enq=np.array([r.enqueue_s for r in requests], float),
                dead=np.array([r.deadline_s for r in requests], float),
                link_rate_bps=np.array([r.link_rate_bps for r in requests],
                                       float))


def _grant_reports(requests: Sequence[UplinkRequest],
                   a: Dict[str, np.ndarray]) -> Dict[int, GrantReport]:
    """``{ue_id: GrantReport}`` from one cell's report-field arrays."""
    return {int(r.ue_id): GrantReport(
        ue_id=int(r.ue_id), n_bytes=int(r.n_bytes),
        enqueue_s=float(r.enqueue_s), finish_s=float(a["finish_s"][i]),
        tx_s=float(a["tx_s"][i]), granted_prbs=int(a["granted_prbs"][i]),
        active_slots=int(a["active_slots"][i]), n_tx=int(a["n_tx"][i]),
        n_harq_retx=int(a["n_harq_retx"][i]),
        realized_rate_bps=float(a["realized_rate_bps"][i]),
        prb_share=float(a["prb_share"][i]), mcs=int(a["mcs"][i]))
        for i, r in enumerate(requests)}


def _serve_cells(cfg: RanConfig, policy: int, device, batches, tapes, rngs,
                 rr_ptr, pf_avg, width: int, on_chunk=None, *,
                 n_lanes: Optional[int] = None, pf_width: int = 0,
                 all_stopped=None):
    """One frame-slot of ``serve_slot`` for C cells at once: the host loop
    shared by ``VecRanCell`` (C = 1) and ``MultiCellVecMac``.

    ``batches[c]`` holds cell c's requests as arrays (``ue``, ``n_bytes``,
    ``enq``, ``dead``, ``link_rate_bps``; possibly empty), ``tapes[c]`` and
    ``rngs[c]`` its uniform tape and HARQ generator, ``rr_ptr[c]`` and
    ``pf_avg[c]`` its policy state.  Lanes are padded to ``width``; the
    tape schedule follows ``C * width`` lanes, each cell's fill its real
    request count.  ``on_chunk(ys)`` (if given) receives each chunk's
    per-step records.  Returns the new ``rr_ptr`` (C,), the new ``pf_avg``
    (one array per cell) and one report-field dict per cell, floats
    identical to the per-cell oracle's.

    A rank that steps some cells of a larger deployment (``MultiCellVecMac``
    over a mesh) passes the whole deployment's tape lanes (``n_lanes``), its
    PF width (``pf_width``) and ``all_stopped(local)``, true when every
    rank's cells have stopped: its chunks, draws and widths are then the
    one-process run's."""
    C, n, dev = len(batches), width, device
    n_real = np.array([len(b["ue"]) for b in batches], np.int64)
    ue = np.zeros((C, n), np.int64)
    nb = np.zeros((C, n), np.int64)
    enq = np.full((C, n), np.inf)
    dead = np.full((C, n), np.inf)
    bpp = np.ones((C, n))
    k0 = np.zeros(C, np.int64)
    for c, b in enumerate(batches):
        m = int(n_real[c])
        if not m:
            continue
        ue[c, :m] = np.asarray(b["ue"], int)
        nb[c, :m] = np.asarray(b["n_bytes"], int)
        enq[c, :m] = np.asarray(b["enq"], float)
        dead[c, :m] = np.asarray(b["dead"], float)
        bpp[c, :m] = (np.asarray(b["link_rate_bps"], float) * cfg.tti_s
                      / (cfg.n_prbs * (1.0 - cfg.bler_target)))
        k0[c] = int(math.ceil(enq[c, :m].min() / cfg.tti_s))
    rem = nb * 8.0
    finish = np.where(rem > 0, np.nan, enq)

    if policy == _PF:
        want = max([_pad_len(int(ue.max()) + 1), pf_width]
                   + [a.size for a in pf_avg])
        pfa = np.zeros((C, want))
        for c, a in enumerate(pf_avg):
            pfa[c, :a.size] = a
    else:
        pfa = np.zeros((C, 0))

    carry = _slot_carry(k0, rr_ptr, rem, finish, pfa, dev)
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)
    args = [t(enq, F64), t(dead, F64), t(bpp, F64), t(ue, I64), None,
            t(n_real, I64), torch.arange(n, dtype=I64, device=dev)]
    kw = dict(tti=_divisor(cfg.tti_s, dev), bler=cfg.bler_target,
              max_slots=cfg.max_slots, n_prbs=cfg.n_prbs, policy=policy)
    for steps in _chunk_schedule(n_lanes or C * n):
        buf = np.zeros((C, steps * n))
        for c in range(C):
            want = steps * int(n_real[c])
            tapes[c].fill(rngs[c], want)
            buf[c, :want] = tapes[c].buf[:want]
        args[4] = t(buf, F64)
        carry, ys = _run_slot_chunk(carry, args, steps, on_chunk is not None,
                                    **kw)
        codes = _host(carry.code)
        ptrs = _host(carry.ptr)
        for c in range(C):
            tapes[c].consume(int(ptrs[c]))
        carry = carry._replace(ptr=torch.zeros_like(carry.ptr))
        if on_chunk is not None:
            on_chunk(ys)
        stopped = bool((codes != _RUNNING).all())
        if all_stopped(stopped) if all_stopped is not None else stopped:
            break
    if (codes == _SLOT_GUARD).any():
        raise RuntimeError(
            f"RanCell: uplink queues not drained after {cfg.max_slots} TTIs "
            f"({cfg.max_slots * cfg.tti_s:.1f} s simulated); "
            f"raise RanConfig.max_slots or reduce the offered load")
    pfa = _host(carry.pfa)
    fin, grt, act, ntx, nrx = (_host(x) for x in (
        carry.fin, carry.grt, carry.act, carry.ntx, carry.nrx))
    outs: List[Dict[str, np.ndarray]] = []
    for c in range(C):
        m = int(n_real[c])
        if not m:
            outs.append({})
            continue
        f, g, a = fin[c, :m], grt[c, :m], act[c, :m]
        tx_s = f - enq[c, :m]
        outs.append(dict(
            finish_s=f, granted_prbs=g, active_slots=a,
            n_tx=ntx[c, :m], n_harq_retx=nrx[c, :m], tx_s=tx_s,
            realized_rate_bps=np.where(
                tx_s > 0, nb[c, :m] * 8.0 / np.where(tx_s > 0, tx_s, 1.0),
                0.0),
            prb_share=np.where(
                a > 0, g / np.where(a > 0, cfg.n_prbs * a, 1), 0.0),
            mcs=mcs_index_vec(bpp[c, :m]), bpp=bpp[c, :m]))
    return _host(carry.rr_ptr), [pfa[c] for c in range(C)], outs


def _merge_parked(parts):
    """Merge parked-lane parts from either engine: ``StreamFlow`` lists
    (oracle) flatten, ``ParkedFlows`` batches (vectorized) concatenate;
    no part (or only empty ones) gives ``[]``."""
    parts = [p for p in parts if len(p)]
    if not parts:
        return []
    if isinstance(parts[0], list):
        return [f for p in parts for f in p]
    return type(parts[0]).concat(parts)


@dataclass
class VecRanCell:
    """Drop-in ``RanCell`` twin running the slot step on ``device``.
    Construct via ``VecRanCell.from_cell(cell, device=...)``; policy state
    (PF EWMA, RR pointer) lives here as numpy arrays and persists across
    slots exactly like the oracle policy object's."""
    policy: int
    cfg: RanConfig = field(default_factory=RanConfig)
    record_trace: bool = False
    grant_trace: List[Tuple[int, Tuple]] = field(default_factory=list)
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._rr_ptr = 0
        self._pf_avg = np.zeros(0)
        self._tape = _UniformTape()

    @classmethod
    def from_cell(cls, cell: RanCell, device="cuda") -> "VecRanCell":
        vc = cls(policy=policy_code(cell.policy), cfg=cell.cfg,
                 record_trace=cell.record_trace, device=device)
        # adopt live policy state so mid-run conversion stays paired
        if isinstance(cell.policy, ProportionalFairScheduler):
            vc._pf_avg = np.array(cell.policy._avg, float)
        elif isinstance(cell.policy, RoundRobinScheduler):
            vc._rr_ptr = int(cell.policy._ptr)
        return vc

    def reset(self, n_ues: int):
        self._rr_ptr = 0
        self._pf_avg = np.zeros(n_ues if self.policy == _PF else 0)
        self._tape = _UniformTape()
        self.grant_trace = []

    def bits_per_prb(self, link_rate_bps):
        return (np.asarray(link_rate_bps, float) * self.cfg.tti_s
                / (self.cfg.n_prbs * (1.0 - self.cfg.bler_target)))

    def _ensure_pf(self, max_ue: int):
        want = _pad_len(max_ue + 1)
        if self._pf_avg.size < want:
            old = self._pf_avg
            self._pf_avg = np.zeros(want)
            self._pf_avg[:old.size] = old

    # -- one frame-slot ------------------------------------------------------
    def serve_slot_arrays(self, ue, n_bytes, enq, dead, link_rate_bps,
                          harq_rng: np.random.Generator) -> Dict[str, np.ndarray]:
        """Array-in / array-out ``serve_slot``: the report fields as
        vectors (identical floats to the oracle's ``GrantReport``s)."""
        self.grant_trace = []
        if len(ue) == 0:
            return {}
        ue = np.asarray(ue, int)
        batch = dict(ue=ue, n_bytes=n_bytes, enq=enq, dead=dead,
                     link_rate_bps=link_rate_bps)
        on_chunk = ((lambda ys: self._append_trace(ys, ue))
                    if self.record_trace else None)
        rr, pfa, (out,) = _serve_cells(
            self.cfg, self.policy, self.device, [batch], [self._tape],
            [harq_rng], [self._rr_ptr], [self._pf_avg], len(ue), on_chunk)
        self._rr_ptr = int(rr[0])
        if self.policy == _PF:
            self._pf_avg = pfa[0]
        return out

    def _append_trace(self, ys, ue):
        if not ys:
            return
        ks, alloc, delivered, fail, execd = (
            _host(torch.stack([y[j][0] for y in ys])) for j in range(5))
        for t in np.flatnonzero(execd):
            g = np.flatnonzero(alloc[t])
            self.grant_trace.append((int(ks[t]), tuple(
                (int(ue[i]), int(alloc[t, i]), int(delivered[t, i]),
                 bool(fail[t, i])) for i in g)))

    def serve_slot(self, requests: Sequence[UplinkRequest],
                   harq_rng: np.random.Generator) -> Dict[int, GrantReport]:
        """Oracle-identical ``RanCell.serve_slot`` (object API)."""
        self.grant_trace = []
        if not requests:
            return {}
        b = _request_arrays(requests)
        return _grant_reports(requests, self.serve_slot_arrays(
            b["ue"], b["n_bytes"], b["enq"], b["dead"], b["link_rate_bps"],
            harq_rng))


# ---------------------------------------------------------------------------
# continuous-TTI streaming twin
# ---------------------------------------------------------------------------

_PARK_COLS = ("ue", "bpp", "coh", "rem", "grt", "act", "ntx", "nrx", "gaa")
_FLOW_ARRAYS = ("_ue", "_enq", "_dead", "_bpp", "_rem", "_fin", "_grt",
                "_act", "_ntx", "_nrx", "_gaa", "_coh")


class ParkedFlows:
    """Blackout-parked flows in ARRAY form: the rows ``migrate_ues`` pops
    from a ``VecRanStream`` kept as column arrays plus the carried
    request/meta object lists, so a mass park/adopt cycle stays a handful
    of numpy ops instead of per-flow ``StreamFlow`` shuffling.  Columns
    carry exactly what ``adopt_batch`` re-admits -- remaining bits and the
    accumulated grant/HARQ counters (enqueue/deadline/rate re-derive from
    the carried request) -- plus the popped cohort and spectral efficiency
    so ``flows()`` can materialize oracle-identical ``StreamFlow`` views."""

    __slots__ = _PARK_COLS + ("reqs", "meta")

    def __init__(self, ue=None, bpp=None, coh=None, rem=None, grt=None,
                 act=None, ntx=None, nrx=None, gaa=None, reqs=None,
                 meta=None):
        zi, zf = np.zeros(0, np.int64), np.zeros(0, np.float64)
        self.ue = zi if ue is None else ue
        self.bpp = zf if bpp is None else bpp
        self.coh = zi if coh is None else coh
        self.rem = zf if rem is None else rem
        self.grt = zi if grt is None else grt
        self.act = zi if act is None else act
        self.ntx = zi if ntx is None else ntx
        self.nrx = zi if nrx is None else nrx
        self.gaa = zi if gaa is None else gaa
        self.reqs = [] if reqs is None else reqs
        self.meta = [] if meta is None else meta

    def __len__(self) -> int:
        return int(self.ue.size)

    def take(self, idx: np.ndarray) -> "ParkedFlows":
        """Row subset (order-preserving fancy index)."""
        return ParkedFlows(
            **{c: getattr(self, c)[idx] for c in _PARK_COLS},
            reqs=[self.reqs[i] for i in idx],
            meta=[self.meta[i] for i in idx])

    @classmethod
    def concat(cls, batches: Sequence["ParkedFlows"]) -> "ParkedFlows":
        batches = [b for b in batches if len(b)]
        if not batches:
            return cls()
        return cls(
            **{c: np.concatenate([getattr(b, c) for b in batches])
               for c in _PARK_COLS},
            reqs=[r for b in batches for r in b.reqs],
            meta=[m for b in batches for m in b.meta])

    def flush_tb(self):
        """Charge every in-flight HARQ transport block as a loss (the
        park-time rule: the adopting cell cannot soft-combine another
        cell's HARQ process) -- one vectorized compare."""
        self.nrx = self.nrx + (self.grt > self.gaa)

    def flows(self) -> List[StreamFlow]:
        """Materialize ``StreamFlow`` views (tests / python interop)."""
        return [StreamFlow(
            req=self.reqs[i], cohort=int(self.coh[i]), meta=self.meta[i],
            rem_bits=float(self.rem[i]), bpp=float(self.bpp[i]),
            granted=int(self.grt[i]), act_slots=int(self.act[i]),
            n_tx=int(self.ntx[i]), n_retx=int(self.nrx[i]),
            finish_s=float("nan"), granted_at_admit=int(self.gaa[i]))
            for i in range(len(self))]


class VecRanStream:
    """Drop-in ``RanStream`` twin: flow state as growing numpy arrays in
    admission order on the host, TTIs executed by ``_stream_step`` on the
    cell's device.  Finished / migrated flows materialize as real
    ``StreamFlow`` objects, so ``timeline.run_stream`` needs no special
    cases.  ``cell`` is a ``RanCell`` (its twin is built on ``device``)
    or a ``VecRanCell`` (which brings its own device).  ``n_steps`` and
    ``n_ttis`` count the steps run and the TTIs executed over all
    ``advance`` calls."""

    def __init__(self, cell, n_ues: int = 0, device="cuda"):
        self.cell = VecRanCell.from_cell(cell, device=device) \
            if isinstance(cell, RanCell) else cell
        self.cfg = self.cell.cfg
        self._k = 0
        self._n = 0                      # live array length
        self._cap = 16
        # the oracle's cohort -> open-flow counter, mirrored exactly:
        # +1 per enqueue/adopt, -1 when a flow drains in advance or
        # migrates out, key deleted at zero (= cohort retirement)
        self._cohort_open: Dict[int, int] = {}
        self._meta: List[object] = []
        self._reqs: List[UplinkRequest] = []
        f, i = np.float64, np.int64
        self._ue = np.zeros(self._cap, i)
        self._enq = np.zeros(self._cap, f)
        self._dead = np.zeros(self._cap, f)
        self._bpp = np.zeros(self._cap, f)
        self._rem = np.zeros(self._cap, f)
        self._fin = np.zeros(self._cap, f)
        self._grt = np.zeros(self._cap, i)
        self._act = np.zeros(self._cap, i)
        self._ntx = np.zeros(self._cap, i)
        self._nrx = np.zeros(self._cap, i)
        self._gaa = np.zeros(self._cap, i)   # granted_at_admit
        self._coh = np.zeros(self._cap, i)
        self.n_steps = 0
        self.n_ttis = 0
        if n_ues and self.cell.policy == _PF and not self.cell._pf_avg.size:
            self.cell._pf_avg = np.zeros(n_ues)

    def _grow(self):
        self._cap *= 2
        for name in _FLOW_ARRAYS:
            old = getattr(self, name)
            arr = np.zeros(self._cap, old.dtype)
            arr[:self._n] = old[:self._n]
            setattr(self, name, arr)

    def _append(self, req: UplinkRequest, cohort: int, meta, rem_bits,
                granted=0, act_slots=0, n_tx=0, n_retx=0,
                granted_at_admit=0) -> int:
        if self._n == self._cap:
            self._grow()
        i = self._n
        self._n += 1
        self._ue[i] = req.ue_id
        self._enq[i] = req.enqueue_s
        self._dead[i] = req.deadline_s
        self._bpp[i] = float(self.cell.bits_per_prb(req.link_rate_bps))
        self._rem[i] = rem_bits
        self._fin[i] = np.nan
        self._grt[i] = granted
        self._act[i] = act_slots
        self._ntx[i] = n_tx
        self._nrx[i] = n_retx
        self._gaa[i] = granted_at_admit
        self._coh[i] = cohort
        self._meta.append(meta)
        self._reqs.append(req)
        return i

    def enqueue(self, req: UplinkRequest, cohort: int,
                meta: object = None) -> StreamFlow:
        i = self._append(req, cohort, meta, req.n_bytes * 8.0)
        self._cohort_open[cohort] = self._cohort_open.get(cohort, 0) + 1
        return self._flow_view(i)

    def _flow_view(self, i: int) -> StreamFlow:
        return StreamFlow(
            req=self._reqs[i], cohort=int(self._coh[i]), meta=self._meta[i],
            rem_bits=float(self._rem[i]), bpp=float(self._bpp[i]),
            granted=int(self._grt[i]), act_slots=int(self._act[i]),
            n_tx=int(self._ntx[i]), n_retx=int(self._nrx[i]),
            finish_s=float(self._fin[i]) if self._rem[i] <= 0.0
            else float("nan"), granted_at_admit=int(self._gaa[i]))

    # -- the TTI clock -------------------------------------------------------
    def advance(self, until_s: float,
                harq_rng: np.random.Generator) -> List[StreamFlow]:
        cfg, dev = self.cfg, self.cell.device
        n = self._n
        if n == 0:
            return []
        was_live = self._rem[:n] > 0.0
        if not was_live.any():
            return []
        # compact cohort ids -> segment indices (+1 reserved empty pad)
        coh_ids, seg = np.unique(self._coh[:n], return_inverse=True)
        n_seg = _pad_len(coh_ids.size + 1)
        base_open = np.zeros(n_seg, np.int64)
        base_open[:coh_ids.size] = [self._cohort_open.get(int(c), 0)
                                    for c in coh_ids]
        F = _pad_len(n)
        if self.cell.policy == _PF:
            self.cell._ensure_pf(int(self._ue[:n].max()))
        pfa = self.cell._pf_avg
        ue_pad = _pad_len(max(int(self._ue[:n].max()) + 1, pfa.size, 1))

        def pad(a, fill=0):
            out = np.full(F, fill, a.dtype)
            out[:n] = a[:n]
            return out

        seg_p = np.full(F, n_seg - 1, np.int64)
        seg_p[:n] = seg
        # static HOL chain over ENTRY-undrained flows: per UE, admission
        # order; entry-drained flows can neither block nor become HOL
        # during this advance, so the step's one-drain-per-UE-per-TTI
        # successor update walks exactly the oracle's first-undrained
        nxt = np.full(F, F, np.int64)
        is_hol0 = np.zeros(F + 1, np.bool_)
        live_idx = np.flatnonzero(was_live)
        lu = self._ue[:n][live_idx]
        order = np.lexsort((live_idx, lu))
        li, lg = live_idx[order], lu[order]
        if li.size:
            same = lg[1:] == lg[:-1]
            nxt[li[:-1][same]] = li[1:][same]
            head = np.ones(li.size, np.bool_)
            head[1:] = ~same
            is_hol0[li[head]] = True
        seg_size = np.bincount(seg, minlength=n_seg).astype(np.int64)
        es = np.sort(self._enq[:n][was_live])
        enq_sorted = np.full(_pad_len(es.size + 1), np.inf)
        enq_sorted[:es.size] = es
        tape = self.cell._tape

        on_dev = lambda a: torch.as_tensor(a, device=dev)
        scalar = lambda v: torch.tensor(v, dtype=I64, device=dev)
        carry = _StreamCarry(
            scalar(_RUNNING), scalar(self._k), scalar(0), scalar(0),
            scalar(self.cell._rr_ptr), scalar(0), on_dev(pad(self._rem)),
            on_dev(pad(self._fin, np.nan)), on_dev(pad(self._grt)),
            on_dev(pad(self._act)), on_dev(pad(self._ntx)),
            on_dev(pad(self._nrx)),
            on_dev(np.concatenate([pfa, np.zeros(ue_pad - pfa.size)])
                   if pfa.size < ue_pad else pfa[:ue_pad]),
            on_dev(is_hol0), on_dev(base_open), scalar(live_idx.size),
            scalar(0))
        args = (on_dev(pad(self._enq, np.inf)), on_dev(pad(self._dead)),
                on_dev(pad(self._bpp, 1.0)), on_dev(pad(self._ue)),
                on_dev(seg_p), on_dev(seg_size), on_dev(nxt),
                on_dev(enq_sorted))
        kw = dict(tti=_divisor(cfg.tti_s, dev), max_slots=cfg.max_slots,
                  until=until_s,
                  n_prbs=cfg.n_prbs, policy=self.cell.policy)
        oc = base_open
        for steps in _chunk_schedule(n):
            # per-TTI draw count == flows in still-open segments, a bound
            # the step can only shrink; fill exactly that
            nd_bound = int(seg_size[oc > 0].sum())
            tape.fill(harq_rng, steps * max(nd_bound, 1))
            valid = tape.buf.size
            # the step only ever tests u < bler, so pre-compare on the
            # host and ship 1-byte fail bits, not f64 uniforms
            pbuf = np.zeros(_pad_len(max(valid, 1), 1024), np.bool_)
            np.less(tape.buf, cfg.bler_target, out=pbuf[:valid])
            bits = on_dev(pbuf)
            for _ in range(steps):
                carry = _stream_step(carry, *args, bits, valid_len=valid,
                                     **kw)
                self.n_steps += 1
                if int(carry.code) != _RUNNING:
                    break
            code = int(carry.code)
            tape.consume(int(carry.ptr))
            carry = carry._replace(ptr=torch.zeros_like(carry.ptr))
            oc = _host(carry.open_cnt)
            if code == _TAPE_OUT:
                carry = carry._replace(code=torch.zeros_like(carry.code))
                continue
            if code in (_DONE, _TIME_UP):
                break
            if code == _SLOT_GUARD:
                raise RuntimeError(
                    f"RanStream: uplink queues not drained after "
                    f"{cfg.max_slots} TTIs in one advance; raise "
                    f"RanConfig.max_slots or reduce the offered load")
        self.n_ttis += int(carry.nstep)
        self._k = int(carry.k)
        self.cell._rr_ptr = int(carry.rr_ptr)
        rem = _host(carry.rem)[:n]
        fin = _host(carry.fin)[:n]
        self._grt[:n] = _host(carry.grt)[:n]
        self._act[:n] = _host(carry.act)[:n]
        self._ntx[:n] = _host(carry.ntx)[:n]
        self._nrx[:n] = _host(carry.nrx)[:n]
        if self.cell.policy == _PF:
            self.cell._pf_avg = _host(carry.pfa)
        self._rem[:n] = rem
        self._fin[:n] = fin
        done_now = was_live & (rem <= 0.0)
        fidx = np.flatnonzero(done_now)
        # completion order: finish times rise with the TTI index and ties
        # within one TTI resolve in admission order -- the oracle's
        # append order
        fidx = fidx[np.lexsort((fidx, fin[fidx]))]
        finished = [self._flow_view(int(i)) for i in fidx]
        for i in fidx:
            self._close(int(self._coh[i]))
        self._compact()
        return finished

    def _close(self, cohort: int, count: int = 1):
        """A cohort loses ``count`` open flows; it retires at zero."""
        self._cohort_open[cohort] -= count
        if self._cohort_open[cohort] == 0:
            del self._cohort_open[cohort]

    def _keep(self, kidx: np.ndarray):
        """Keep only the flow rows ``kidx`` (ascending), in order."""
        for name in _FLOW_ARRAYS:
            arr = getattr(self, name)
            arr[:kidx.size] = arr[kidx]
        self._meta = [self._meta[i] for i in kidx]
        self._reqs = [self._reqs[i] for i in kidx]
        self._n = kidx.size

    def _compact(self):
        """Twin of ``_retire``'s pruning: drop drained flows whose cohort
        has retired (left ``_cohort_open``)."""
        n = self._n
        if n == 0:
            return
        live = self._rem[:n] > 0.0
        keep = live | np.array([self._cohort_open.get(int(c), 0) > 0
                                for c in self._coh[:n]], bool)
        if not keep.all():
            self._keep(np.flatnonzero(keep))

    # -- handover ------------------------------------------------------------
    def migrate_ue(self, ue_id: int) -> List[StreamFlow]:
        n = self._n
        mine = np.flatnonzero((self._ue[:n] == ue_id)
                              & (self._rem[:n] > 0.0))
        flows = [self._flow_view(int(i)) for i in mine]
        if mine.size:
            for i in mine:
                self._close(int(self._coh[i]))
            keep = np.ones(n, bool)
            keep[mine] = False
            self._keep(np.flatnonzero(keep))
            self._compact()
        return flows

    def adopt(self, flow: StreamFlow, enqueue_s: float,
              cohort: int) -> StreamFlow:
        req = dataclasses.replace(flow.req, enqueue_s=enqueue_s)
        i = self._append(req, cohort, flow.meta, flow.rem_bits,
                         granted=flow.granted, act_slots=flow.act_slots,
                         n_tx=flow.n_tx, n_retx=flow.n_retx,
                         granted_at_admit=flow.granted)
        self._cohort_open[cohort] = self._cohort_open.get(cohort, 0) + 1
        return self._flow_view(i)

    # -- batched park/adopt (mass-blackout hot path) -------------------------
    def migrate_ues(self, ue_ids: Sequence[int],
                    flush_tb: bool = False) -> List["ParkedFlows"]:
        """Pop every live flow belonging to ``ue_ids`` with ONE array
        compaction.  Returns one ``ParkedFlows`` per requested UE, each in
        admission order -- the exact per-UE lists the oracle's
        ``migrate_ues`` produces, in array form.  ``flush_tb`` applies the
        blackout in-flight-TB loss rule vectorized."""
        n = self._n
        ids = np.asarray(list(ue_ids), np.int64)
        sel = (np.isin(self._ue[:n], ids) & (self._rem[:n] > 0.0))
        mine = np.flatnonzero(sel)
        batch = ParkedFlows(
            ue=self._ue[mine].copy(), bpp=self._bpp[mine].copy(),
            coh=self._coh[mine].copy(), rem=self._rem[mine].copy(),
            grt=self._grt[mine].copy(), act=self._act[mine].copy(),
            ntx=self._ntx[mine].copy(), nrx=self._nrx[mine].copy(),
            gaa=self._gaa[mine].copy(),
            reqs=[self._reqs[i] for i in mine],
            meta=[self._meta[i] for i in mine])
        if flush_tb:
            batch.flush_tb()
        if mine.size:
            for c, cnt in zip(*np.unique(batch.coh, return_counts=True)):
                self._close(int(c), int(cnt))
            self._keep(np.flatnonzero(~sel))
            self._compact()
        return [batch.take(np.flatnonzero(batch.ue == u)) for u in ids]

    def adopt_batch(self, parked: "ParkedFlows", enqueue_s: float,
                    cohort: int) -> "ParkedFlows":
        """Re-admit a parked batch at recovery -- the array twin of
        per-flow ``adopt``.  Each flow's enqueue becomes ``max(original,
        enqueue_s)``, counters carry, and ``granted_at_admit`` snapshots
        the accumulated grant, all matching the oracle's ``adopt_batch``
        field for field."""
        k = len(parked)
        if k == 0:
            return parked
        while self._n + k > self._cap:
            self._grow()
        i0 = self._n
        sl = slice(i0, i0 + k)
        reqs = [dataclasses.replace(r, enqueue_s=max(r.enqueue_s, enqueue_s))
                for r in parked.reqs]
        self._ue[sl] = parked.ue
        self._enq[sl] = [r.enqueue_s for r in reqs]
        self._dead[sl] = [r.deadline_s for r in reqs]
        # scalar per-request bits_per_prb, matching _append bit for bit
        self._bpp[sl] = [float(self.cell.bits_per_prb(r.link_rate_bps))
                         for r in reqs]
        self._rem[sl] = parked.rem
        self._fin[sl] = np.nan
        self._grt[sl] = parked.grt
        self._act[sl] = parked.act
        self._ntx[sl] = parked.ntx
        self._nrx[sl] = parked.nrx
        self._gaa[sl] = parked.grt
        self._coh[sl] = cohort
        self._meta.extend(parked.meta)
        self._reqs.extend(reqs)
        self._n = i0 + k
        self._cohort_open[cohort] = self._cohort_open.get(cohort, 0) + k
        return parked

    def report(self, flow: StreamFlow) -> GrantReport:
        cfg = self.cfg
        tx_s = float(flow.finish_s - flow.req.enqueue_s)
        return GrantReport(
            ue_id=flow.req.ue_id, n_bytes=flow.req.n_bytes,
            enqueue_s=flow.req.enqueue_s, finish_s=float(flow.finish_s),
            tx_s=tx_s, granted_prbs=flow.granted,
            active_slots=flow.act_slots, n_tx=flow.n_tx,
            n_harq_retx=flow.n_retx,
            realized_rate_bps=(flow.req.n_bytes * 8.0 / tx_s
                               if tx_s > 0 else 0.0),
            prb_share=(flow.granted / (cfg.n_prbs * flow.act_slots)
                       if flow.act_slots else 0.0),
            mcs=int(mcs_index_vec(flow.bpp)))

    @property
    def backlog_bytes(self) -> float:
        n = self._n
        live = self._rem[:n] > 0.0
        return float(self._rem[:n][live].sum() / 8.0)

    def telemetry_sample(self) -> Dict[str, float]:
        """Twin of ``RanStream.telemetry_sample``, read from the array
        state; values match the oracle's field for field."""
        n = self._n
        live = self._rem[:n] > 0.0
        return {"tti": float(self._k),
                "backlog_bytes": float(self._rem[:n][live].sum() / 8.0),
                "live_flows": float(int(live.sum())),
                "open_cohorts": float(len(self._cohort_open))}
