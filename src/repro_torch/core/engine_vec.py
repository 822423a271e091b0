"""City-scale multi-cell MAC: the slot step over a leading cell axis.

The counterpart of ``repro/core/engine_vec.py``.  ``MultiCellVecMac`` runs
every cell of a homogeneous deployment through ONE batched step per TTI
on one device -- carry and request tensors carry a leading cell axis, so
C cells cost one run of launches per TTI instead of C.  The JAX package's
``jax.vmap`` of its slot kernel is here the slot step's own cell axis
(``ran_vec._slot_step``).  With ``mesh=`` (``launch/mesh.py``) the cell
axis is placed by ``launch.sharding.cell_axis_sharding``: where the cell
count divides the mesh's batch ranks, each rank steps its own cells (the
step is elementwise across cells, so no collective runs inside it; one
flag a chunk keeps the ranks' chunks in step) and the reports and policy
state are gathered to every rank; otherwise every rank steps every
cell.

Exactness discipline is inherited from ``core/ran_vec.py``: each cell
keeps its own uniform tape paired with its own HARQ generator, and the
step advances each cell's tape pointer by that cell's REAL request count
(``n_draw``), so lane padding to the common batch width never
desynchronizes the rng stream.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.ran import (GrantReport, MultiCell, RanConfig,
                                  UplinkRequest)
from repro_torch.core.ran_vec import (_PF, VecRanCell, _UniformTape,
                                      _grant_reports, _merge_parked,
                                      _pad_len, _request_arrays, _serve_cells)


class MultiCellVecMac:
    """Batched ``serve_slot`` over a homogeneous multi-cell deployment.

    Construct from a ``MultiCell`` (or any sequence of ``RanCell`` /
    ``VecRanCell`` sharing one ``RanConfig`` and policy class), then call
    ``serve_slot_arrays`` with one request batch and one HARQ generator
    per cell.  Policy state (RR pointer, PF EWMA) persists per cell,
    exactly like the per-cell oracle objects.  The steps run on
    ``device`` (the card unless the caller asks for the CPU), and with
    ``mesh`` on each rank's own cells (the module's docstring).
    """

    def __init__(self, cells, device="cuda", mesh=None):
        if isinstance(cells, MultiCell):
            cells = cells.cells
        cells = list(cells)
        if not cells:
            raise ValueError("MultiCellVecMac needs at least one cell")
        self.device = resolve_device(device)
        vcells = [c if isinstance(c, VecRanCell)
                  else VecRanCell.from_cell(c, device=self.device)
                  for c in cells]
        cfg0, pol0 = vcells[0].cfg, vcells[0].policy
        for vc in vcells[1:]:
            if vc.cfg != cfg0 or vc.policy != pol0:
                raise ValueError(
                    "MultiCellVecMac: all cells must share one RanConfig "
                    "and scheduler policy (heterogeneous deployments run "
                    "per-cell VecRanCells instead)")
        self.cfg: RanConfig = cfg0
        self.policy: int = pol0
        self.n_cells = len(vcells)
        self._tapes = [_UniformTape() for _ in vcells]
        self._rr_ptr = np.array([vc._rr_ptr for vc in vcells], np.int64)
        self._pf_avg = [np.array(vc._pf_avg, np.float64) for vc in vcells]
        self.mesh = mesh
        self._mine = None            # the cells this rank steps, if split
        if mesh is not None:
            from repro_torch.launch.mesh import batch_index
            from repro_torch.launch.sharding import cell_axis_sharding
            if cell_axis_sharding(mesh, self.n_cells):
                r, n = batch_index(mesh)
                per = self.n_cells // n
                self._mine = range(r * per, (r + 1) * per)

    # -- one frame-slot across all cells -------------------------------------
    def serve_slot_arrays(self, batches: Sequence[Dict[str, np.ndarray]],
                          rngs: Sequence[np.random.Generator],
                          ) -> List[Dict[str, np.ndarray]]:
        """Array-in / array-out ``serve_slot`` for every cell at once.

        ``batches[c]`` holds cell c's requests as arrays (``ue``,
        ``n_bytes``, ``enq``, ``dead``, ``link_rate_bps``; possibly
        empty), ``rngs[c]`` its HARQ generator.  Returns one report-field
        dict per cell, floats identical to the per-cell oracle's.
        """
        C = self.n_cells
        if len(batches) != C or len(rngs) != C:
            raise ValueError("need one request batch and one rng per cell")
        n_real = [len(b["ue"]) for b in batches]
        if not any(n_real):
            return [{} for _ in range(C)]
        width = _pad_len(max(n_real))
        if self._mine is None:
            rr, pfa, outs = _serve_cells(
                self.cfg, self.policy, self.device, batches, self._tapes, rngs,
                self._rr_ptr, self._pf_avg, width)
        else:
            rr, pfa, outs = self._serve_mine(batches, rngs, width)
        self._rr_ptr = rr.copy()
        if self.policy == _PF:
            self._pf_avg = pfa
        return outs

    def _serve_mine(self, batches, rngs, width: int):
        """``_serve_cells`` on this rank's cells with the whole deployment's
        tape lanes, PF width and stopping chunk, then every rank's results
        gathered in cell order."""
        from functools import partial

        import torch.distributed as dist

        from repro_torch.launch.collectives import all_gather_object
        from repro_torch.launch.mesh import all_ranks
        mine = list(self._mine)
        ue_max = max((int(np.max(b["ue"])) for b in batches if len(b["ue"])),
                     default=0)
        pf_width = max([_pad_len(ue_max + 1)]
                       + [a.size for a in self._pf_avg])
        got = _serve_cells(
            self.cfg, self.policy, self.device, [batches[c] for c in mine],
            [self._tapes[c] for c in mine], [rngs[c] for c in mine],
            self._rr_ptr[mine], [self._pf_avg[c] for c in mine], width,
            n_lanes=self.n_cells * width, pf_width=pf_width,
            all_stopped=partial(all_ranks, self.mesh))
        parts = all_gather_object((mine, got), dist.group.WORLD)
        rr = self._rr_ptr.copy()
        pfa, outs = list(self._pf_avg), [None] * self.n_cells
        for cells, (r_part, p_part, o_part) in parts:
            for i, c in enumerate(cells):
                rr[c], pfa[c], outs[c] = r_part[i], p_part[i], o_part[i]
        return rr, pfa, outs

    def serve_slot(self, requests: Sequence[Sequence[UplinkRequest]],
                   rngs: Sequence[np.random.Generator],
                   ) -> List[Dict[int, GrantReport]]:
        """Object API: one ``UplinkRequest`` list per cell in, one
        ``{ue_id: GrantReport}`` per cell out (oracle-identical)."""
        arrs = self.serve_slot_arrays(
            [_request_arrays(reqs) for reqs in requests], rngs)
        return [_grant_reports(reqs, a) for reqs, a in zip(requests, arrs)]


# ---------------------------------------------------------------------------
# synthetic city workloads (scale runs and tests)
# ---------------------------------------------------------------------------

def synthetic_city(n_ues: int, n_cells: int = 1, seed: int = 0, *,
                   mean_bytes: int = 30_000) -> List[Dict[str, np.ndarray]]:
    """Deterministic per-cell uplink request batches for scale runs.

    UEs are assigned to cells round-robin (so every cell gets an equal
    slice and the batch width is balanced); per-cell draws come from
    spawned ``SeedSequence`` streams, so the workload for cell c is
    independent of ``n_cells`` partitioning noise.  Link rates span
    20--200 Mbps log-uniform, payloads 2 KB -- 2x ``mean_bytes``, with
    small enqueue jitter and 50--100 ms deadlines.
    """
    counts = [len(range(c, n_ues, n_cells)) for c in range(n_cells)]
    seeds = np.random.SeedSequence(seed).spawn(n_cells)
    batches = []
    for c in range(n_cells):
        r = np.random.default_rng(seeds[c])
        m = counts[c]
        enq = r.random(m) * 0.01
        batches.append(dict(
            ue=np.arange(m),
            n_bytes=r.integers(2_000, 2 * mean_bytes, m),
            enq=enq,
            dead=enq + 0.05 + r.random(m) * 0.05,
            link_rate_bps=10.0 ** r.uniform(7.3, 8.3, m)))
    return batches


def synthetic_flows(n_flows: int, seed: int = 0, *,
                    n_ues: Optional[int] = None,
                    mean_bytes: int = 30_000) -> Dict[str, np.ndarray]:
    """Deterministic single-cell streaming workload: ``n_flows`` flows
    over ``n_ues`` UEs (default one flow per UE), staggered arrivals.
    Feed the same arrays to ``RanStream.enqueue`` and
    ``VecRanStream.enqueue`` to race the two engines on identical
    input."""
    n_ues = n_ues or n_flows
    r = np.random.default_rng(seed)
    enq = np.sort(r.random(n_flows) * 0.2)
    return dict(
        ue=np.arange(n_flows) % n_ues,
        n_bytes=r.integers(max(mean_bytes // 2, 1), 2 * mean_bytes, n_flows),
        enq=enq,
        dead=enq + 0.1 + r.random(n_flows) * 0.1,
        link_rate_bps=10.0 ** r.uniform(7.3, 8.3, n_flows),
        cohort=np.arange(n_flows) // max(n_ues, 1))


def _request(flows: Dict[str, np.ndarray], i: int) -> UplinkRequest:
    return UplinkRequest(
        ue_id=int(flows["ue"][i]), n_bytes=int(flows["n_bytes"][i]),
        enqueue_s=float(flows["enq"][i]),
        deadline_s=float(flows["dead"][i]),
        link_rate_bps=float(flows["link_rate_bps"][i]))


def chaos_drain(stream, flows: Dict[str, np.ndarray], harq_rng, *,
                blackouts: Sequence = (),
                batch_enqueue: bool = False) -> List:
    """Drive one MAC stream (``RanStream`` OR ``VecRanStream`` -- the
    engines share the batched park/adopt API) through a
    ``synthetic_flows`` workload with scheduled mass blackouts.

    ``blackouts``: ``(t0, t1, ue_ids)`` triples.  At ``t0`` every listed
    UE's live flows leave the MAC in ONE batched ``migrate_ues`` call
    (in-flight TBs flushed as HARQ losses); at ``t1`` they re-enter via
    ONE ``adopt_batch``.  Enqueues and blackout edges merge onto a
    single event clock, blackout edges first at a tie -- the timeline
    engine's ordering.  With ``batch_enqueue`` every request is admitted
    up front (the MAC gates service on each request's own ``enqueue_s``,
    so admission order is irrelevant) and the clock only stops at
    blackout edges.  Returns the finished flow views in completion
    order; running the same schedule on both engines must agree field
    for field."""
    n_flows = int(len(flows["ue"]))
    coh = flows.get("cohort")
    cohort_of = lambda i: int(coh[i]) if coh is not None else 0
    events = [] if batch_enqueue else [
        (float(flows["enq"][i]), 1, "enq", i) for i in range(n_flows)]
    for t0, t1, ues in blackouts:
        ues = [int(u) for u in ues]
        events.append((float(t0), 0, "park", ues))
        events.append((float(t1), 0, "adopt", ues))
    events.sort(key=lambda e: (e[0], e[1]))
    next_cohort = int(np.max(coh)) + 1 if coh is not None else 1
    parked: Dict[int, List] = {}
    done: List = []
    if batch_enqueue:
        for i in range(n_flows):
            stream.enqueue(_request(flows, i), cohort_of(i))
    for t, _rank, kind, arg in events:
        done.extend(stream.advance(t, harq_rng))
        if kind == "enq":
            stream.enqueue(_request(flows, arg), cohort_of(arg))
        elif kind == "park":
            for u, part in zip(arg,
                               stream.migrate_ues(arg, flush_tb=True)):
                if len(part):
                    parked.setdefault(u, []).append(part)
        else:
            batch = _merge_parked([p for u in arg
                                   for p in parked.pop(u, [])])
            if len(batch):
                stream.adopt_batch(batch, t, next_cohort)
                next_cohort += 1
    done.extend(stream.advance(math.inf, harq_rng))
    return done
