"""Multi-UE cell demo: one edge server detecting objects for a whole cell
of video UEs, with adaptive per-UE split selection and deadline-aware
micro-batched tails.  The port of ``examples/cell_video.py``, with its
flags and engines.

Every frame really executes for every UE: Swin head on each "UE", the
INT8+zlib codec on the boundary, simulated 5G uplink, then the edge server
stacks same-split payloads and runs ONE tail per batch (core/cell.py).

``--policy`` shares one PRB grid among the uplinks, scheduled per TTI by
rr, pf or edf with HARQ (core/ran.py); ``--fps`` runs the continuous-time
event engine (core/timeline.py) with ``--jitter`` and ``--inflight``;
``--mobility`` shuttles the UEs between a dUPF and a cUPF site with A3
handover (core/mobility.py); ``--chaos`` injects an edge outage, a dUPF
outage with failover, a link blackout and UE churn (core/chaos.py);
``--trace`` writes the telemetry plane as a Perfetto/Chrome trace and
prints each missed frame's cause.

    PYTHONPATH=src python -m repro_torch.examples.cell_video --reduced \\
        --device cpu --ues 2 --frames 3 --fixed split2
    PYTHONPATH=src python -m repro_torch.examples.cell_video [--ues 6] \\
        [--frames 12] [--policy edf] [--budget 2.5] [--fps 0.5] \\
        [--jitter 0.05] [--inflight 2] [--mobility --speed 8] [--chaos] \\
        [--trace OUT.JSON]
"""
from __future__ import annotations

import argparse
from typing import Any, Dict

import numpy as np

from repro_torch.core.ran import POLICIES
from repro_torch.examples import add_port_flags, frame, swin_model


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ues", type=int, default=6)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--no-batching", action="store_true")
    ap.add_argument("--fixed", default=None,
                    help="fixed split option instead of adaptive (e.g. split2)")
    ap.add_argument("--policy", default=None, choices=sorted(POLICIES),
                    help="share the air interface through the RAN MAC with "
                         "this per-TTI scheduler (default: isolated links)")
    ap.add_argument("--budget", type=float, default=2.5,
                    help="per-frame E2E deadline in seconds (EDF urgency / "
                         "deadline-miss accounting; needs --policy)")
    ap.add_argument("--fps", type=float, default=None,
                    help="per-UE capture rate: run the continuous-time "
                         "event engine instead of the lock-step slots")
    ap.add_argument("--jitter", type=float, default=0.0,
                    help="per-frame capture jitter in seconds (needs --fps)")
    ap.add_argument("--inflight", type=int, default=None,
                    help="max frames a UE may have in flight before it "
                         "skips a capture (needs --fps; default unbounded)")
    ap.add_argument("--mobility", action="store_true",
                    help="shuttle the UEs between an AI-RAN (dUPF) site "
                         "and a macro (cUPF) site 400 m apart with A3 "
                         "handover (core/mobility.py; needs --fps, and "
                         "--policy for a shared MAC per cell)")
    ap.add_argument("--speed", type=float, default=8.0,
                    help="UE speed in m/s for --mobility trajectories")
    ap.add_argument("--chaos", action="store_true",
                    help="inject an edge outage, a dUPF outage with "
                         "failover, a link blackout and UE churn "
                         "(core/chaos.py; needs --fps)")
    ap.add_argument("--trace", default=None, metavar="OUT.JSON",
                    help="record the telemetry plane (core/telemetry.py) "
                         "and write a Perfetto/Chrome trace here: open "
                         "ui.perfetto.dev and drop the file on it; adds a "
                         "per-frame cause-of-miss summary line")
    add_port_flags(ap)
    args = ap.parse_args(argv)
    if args.mobility and args.fps is None:
        ap.error("--mobility needs --fps (handover events live on the "
                 "event engine's absolute clock)")
    if args.chaos and args.fps is None:
        ap.error("--chaos needs --fps (failure injection lives on the "
                 "event engine's absolute clock)")
    return args


def chaos_model(frames: int, fps: float):
    """One of each fault, staggered across the run's horizon."""
    from repro_torch.core.channel import cupf_path
    from repro_torch.core.chaos import (ChaosConfig, ChaosModel, ChurnSpec,
                                        OutageSpec)
    horizon = frames / fps
    return ChaosModel(ChaosConfig(
        edge_outage=OutageSpec(schedule=((0.20 * horizon, 0.10 * horizon),)),
        edge_policy="drop",
        upf_outage=OutageSpec(schedule=((0.45 * horizon, 0.15 * horizon),)),
        failover=True, failover_path=cupf_path(),
        blackout=OutageSpec(schedule=((0.75 * horizon, 0.08 * horizon),)),
        blackout_ues=(0,),
        churn=ChurnSpec(initial_p=1.0, mean_on_s=0.5 * horizon,
                        mean_off_s=0.15 * horizon),
        heartbeat_period_s=0.01 * horizon,
        heartbeat_timeout_s=0.025 * horizon))


def run(args, *, params=None, system=None, estimator_init=None) -> Dict[str, Any]:
    """Build the cell as the JAX example does and run it; returns the
    ``CellResult`` (outputs kept), the simulator and the ``Telemetry``
    (None without ``--trace``, whose file it writes).  ``params``,
    ``system`` and ``estimator_init`` as in ``quickstart.run``."""
    import torch

    from repro_torch.core.adaptive import Objective
    from repro_torch.core.calibration import calibrate
    from repro_torch.core.cell import CellSimulator, cell_interference_traces
    from repro_torch.core.compression import ActivationCodec
    from repro_torch.core.mobility import (MobilityConfig, MobilityModel,
                                           WaypointTrajectory, two_cell_sites)
    from repro_torch.core.pipeline import build_controller
    from repro_torch.core.ran import MultiCell, RanCell, RanConfig, make_policy
    from repro_torch.core.splitting import SwinSplitPlan
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.core.trace_export import write_chrome_trace
    from repro_torch.data.video import SyntheticVideo, VideoConfig

    dev, cfg, params = swin_model(args, params)
    video = SyntheticVideo(VideoConfig(h=cfg.img_h, w=cfg.img_w, seed=0))
    imgs = [frame(video, t, dev) for t in range(args.frames + args.ues)]

    system = system or calibrate(device=dev)
    controller = None
    if args.fixed is None:
        controller = build_controller(
            system, objective=Objective(w_delay=1.0, w_energy=0.15,
                                        w_privacy=0.05),
            device=dev, estimator_init=estimator_init)

    mobility = None
    if args.mobility:
        # stagger starts so the cell's handovers spread over the run
        mobility = MobilityModel(
            two_cell_sites(400.0),
            [WaypointTrajectory(((30.0 + 40.0 * u, 0.0), (370.0, 0.0)),
                                speed_mps=args.speed, loop=True)
             for u in range(args.ues)],
            MobilityConfig(a3_ttt_s=2.0, relocation_gap_s=0.2))
    ran = None
    if args.policy is not None:
        if args.mobility:
            ran = MultiCell([RanCell(policy=make_policy(args.policy),
                                     cfg=RanConfig(tti_s=0.002))
                             for _ in range(2)])
        else:
            ran = RanCell(policy=make_policy(args.policy),
                          cfg=RanConfig(tti_s=0.002))
    chaos = chaos_model(args.frames, args.fps) if args.chaos else None
    telemetry = Telemetry() if args.trace is not None else None
    cell = CellSimulator(
        plan=SwinSplitPlan(cfg, params, device=dev), system=system,
        codec=ActivationCodec(device=dev), controller=controller,
        n_ues=args.ues, seed=0, execute_model=True,
        batching=not args.no_batching, max_wait_s=30.0,
        ran=ran, frame_budget_s=args.budget, mobility=mobility,
        chaos=chaos, telemetry=telemetry, device=dev)

    trace = cell_interference_traces(args.frames, args.ues, seed=1)
    with torch.no_grad():
        if args.fps is not None:
            res = cell.run_stream(trace, imgs=imgs, option=args.fixed,
                                  fps=args.fps, jitter_s=args.jitter,
                                  inflight=args.inflight, keep_outputs=True)
        else:
            res = cell.run(trace, imgs=imgs, option=args.fixed,
                           keep_outputs=True)
    if telemetry is not None:
        write_chrome_trace(telemetry, args.trace)
    return {"res": res, "cell": cell, "telemetry": telemetry}


def report(args, out: Dict[str, Any]) -> None:
    """The JAX example's per-UE table and summary lines."""
    from repro_torch.core.telemetry import miss_cause

    res, telemetry = out["res"], out["telemetry"]
    ran = out["cell"].ran
    streaming = args.fps is not None
    mac_cols = f" {'prb':>5s} {'harq':>4s} {'miss':>4s}" if ran else ""
    drop_col = f" {'drop':>4s} {'age':>7s}" if streaming else ""
    mob_cols = f" {'cells':>5s} {'HOs':>3s}" if args.mobility else ""
    print(f"{'ue':>3s} {'frames':>6s} {'options used':24s} {'delay':>8s} "
          f"{'queue':>7s} {'batch':>5s}{mac_cols}{drop_col}{mob_cols}")
    for u in range(args.ues):
        logs = res.ue_logs(u)
        done = [l for l in logs if not l.dropped]
        opts = ",".join(sorted({l.option for l in done}))
        mac = ""
        if ran:
            # share over frames that actually transmitted (ue_only frames
            # carry the isolated-link default 1.0 and would inflate it)
            shares = [l.prb_share for l in done if l.tx_s > 0]
            mac = (f" {np.mean(shares) if shares else 0.0:5.2f}"
                   f" {sum(l.harq_retx for l in done):4d}"
                   f" {sum(l.deadline_miss for l in logs):4d}")
        stream_cols = ""
        if streaming:
            stream_cols = (f" {sum(l.dropped for l in logs):4d}"
                           f" {np.mean([l.age_s for l in done]) if done else 0.0:6.2f}s")
        mob = ""
        if args.mobility:
            cells_seen = ",".join(str(c) for c in
                                  sorted({l.serving_cell for l in logs}))
            mob = (f" {cells_seen:>5s}"
                   f" {max((l.handover_count for l in logs), default=0):3d}")
        print(f"{u:3d} {len(done):6d} {opts:24s} "
              f"{np.mean([l.delay_s for l in done]) if done else 0.0:7.3f}s "
              f"{np.mean([l.queue_s for l in done]) if done else 0.0:6.3f}s "
              f"{np.mean([l.batch_size for l in done]) if done else 0.0:5.1f}"
              f"{mac}{stream_cols}{mob}")

    st = res.stats
    n_det = sum(lv["cls"].shape[-1] for lv in res.outputs[-1][0]) \
        if res.outputs[-1].get(0) is not None else 0
    print(f"\ncell: {st.n_requests} tail requests in {st.n_batches} batches "
          f"(mean size {st.mean_batch_size:.1f}, occupancy "
          f"{st.mean_batch_occupancy:.2f})")
    print(f"edge: utilization {st.edge_utilization:.2f}, "
          f"mean queueing delay {st.mean_queue_s * 1e3:.1f} ms, "
          f"busy {st.edge_busy_s:.2f} s total")
    print(f"mean E2E delay over the cell: {res.mean_delay_s:.3f} s "
          f"({n_det}-class detection maps per UE per frame)")
    if ran:
        print(f"RAN ({args.policy}): deadline-miss rate "
              f"{res.deadline_miss_rate:.2f} against a {args.budget:.1f}s "
              f"frame budget")
    if streaming:
        print(f"stream ({args.fps:g} fps nominal): effective "
              f"{st.effective_fps:.2f} fps, drop rate {res.drop_rate:.2f}, "
              f"mean frame age at detection {res.mean_age_s:.2f} s")
    if args.mobility:
        print(f"mobility ({args.speed:g} m/s): {st.n_handovers} handovers "
              f"across the cell (dUPF site 0 <-> cUPF site 1, A3 "
              f"hysteresis + TTT, queue migration on the absolute clock)")
    if args.chaos:
        print(f"chaos: {st.n_outages} injected outages, availability "
              f"{st.availability:.3f} ({st.n_lost_edge} lost to the edge, "
              f"{st.n_lost_path} to the dUPF, {st.n_absent} captures "
              f"churned away)")
        for m in res.recovery:
            detect = ("--" if np.isnan(m.detect_s)
                      else f"detected +{m.detect_s - m.start_s:.1f}s"
                           f" ({m.action})")
            reconv = ("" if m.reconverge_frames is None
                      else f", reconverged in {m.reconverge_frames:.1f} "
                           f"frames")
            print(f"  {m.component:5s} outage {m.start_s:6.1f}-"
                  f"{m.end_s:6.1f}s: {detect}, recovered in "
                  f"{m.time_to_recover_s:.1f}s, lost {m.n_lost} "
                  f"(burst {m.burst_len}){reconv}")
    if telemetry is not None:
        causes = telemetry.miss_summary(res.logs)
        total = sum(causes.values())
        detail = ", ".join(f"{k}={v}" for k, v in causes.items()) or "none"
        print(f"\ntrace: {len(telemetry.spans)} spans, "
              f"{len(telemetry.instants)} instants -> {args.trace} "
              f"(load in ui.perfetto.dev)")
        print(f"missed/lost frames: {total} -- causes: {detail}")
        for l in res.logs:
            if l.dropped or l.deadline_miss:
                print(f"  ue {l.ue_id} frame {l.frame_idx:3d} "
                      f"captured {l.capture_s:7.2f}s: {miss_cause(l)}")


def main(argv=None) -> Dict[str, Any]:
    args = parse_args(argv)
    out = run(args)
    report(args, out)
    return out


if __name__ == "__main__":
    main()
