"""Workload-zoo launcher — list the zoo, run one workload, or sweep a
whole benchmarks × configs grid as one lockstep run.

  python -m repro_torch.launch.zoo --list
  python -m repro_torch.launch.zoo --run random_gather --scale 0.05
  python -m repro_torch.launch.zoo --grid 4 4 --check     # W×C lanes vs solo
  python -m repro_torch.launch.zoo --trace tests/data/traces --check
  python -m repro_torch.launch.zoo --trace tests/data/traces --grid 3 2 \\
      --check --device cpu

The port's ``repro.launch.zoo`` in its --list, --run, --grid, --trace and
--check modes, on the CUDA device unless ``--device`` names another.
``--grid W C --mesh A B`` distributes the grid over a 2-D ('cfg', 'sm')
device mesh (core/distribute.py): A config groups × B SM blocks.

``--trace FILE|DIR`` ingests real Accel-sim SASS trace subset files
(sim/traceio.py) and registers them in the zoo as ``trace:<stem>``
workloads.  With ``--grid W C`` the trace workloads fill the grid's
workload rows first (synthetic zoo names top up if W exceeds the trace
count); trace rows keep their real CTA counts (``--scale`` applies to
synthetic generators only).  Without ``--grid``/``--run`` an ingest
summary is printed per trace, and ``--check`` additionally runs an (all
traces × 2 configs) grid verifying every lane bit-exact vs its solo run.

``--grid W C`` takes the first W zoo workloads (registry order) and a
C-point config grid (launch/dse.py:default_grid — L2 latency × scheduler)
and runs the full grid as W·C lanes (core/sweep.py:grid_sweep).
``--check`` reruns every (workload, config) pair solo and asserts the
grid lane is bit-identical, timeouts included.  ``--sample-lat`` /
``--sample-disp`` replace the default config grid with a per-class
timing-table sweep (launch/dse.py:sample_table_grid).  ``--grid`` and
``--run`` write a run manifest under ``experiments/runs/``
(core/telemetry.py) unless ``--no-manifest``, with the lanes' counter
timelines under ``--telemetry S``; ``--profile DIR`` traces the run.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.core import stats as S
from repro_torch.core import telemetry as T
from repro_torch.core.engine import simulate
from repro_torch.core.parallel import make_sm_runner
from repro_torch.core.plan import RunPlan
from repro_torch.core.sweep import grid_sweep
from repro_torch.device import resolve_device
from repro_torch.launch.cli import (add_plan_args, add_sample_args,
                                    plan_from_args, profile_ctx)
from repro_torch.launch.dse import (BASES, default_grid, describe,
                                    lane_signature, sample_table_grid)
from repro_torch.sim.config import static_part
from repro_torch.sim.workloads import (TRACE_INGESTS, register_traces,
                                       zoo_names, zoo_workload)


def run_trace_summary(args, trace_names, device) -> None:
    """Ingest-summary mode (``--trace`` without --grid/--run): report
    fit stats per trace; with --check, verify an (all traces × 2 cfgs)
    grid bit-exact against solo runs."""
    for name in trace_names:
        ing = TRACE_INGESTS[name]
        s = ing.summary()
        print(f"[zoo] ingested {name}: {s['n_kernels']} kernel(s), "
              f"{s['total_ctas']} CTAs, n_instr={s['n_instr']}, "
              f"fit_err mean={s['fit_err_mean']} max={s['fit_err_max']} "
              f"blocks")
    if args.check:
        workloads = [zoo_workload(n) for n in trace_names]
        cfgs = default_grid(BASES[args.base], 2)
        grid = grid_sweep(workloads, cfgs, plan=plan_from_args(args),
                          device=device)
        check_grid_vs_solo(grid, workloads, cfgs, args.max_cycles, device)
        print(f"[zoo] check OK: {len(workloads)}x{len(cfgs)} trace grid "
              "bit-exact vs solo runs")


def check_grid_vs_solo(grid, workloads, cfgs, max_cycles: int,
                       device) -> int:
    """Re-run every (workload, config) pair solo and assert its grid
    lane is bit-identical.  The one --check oracle for both grid modes.
    Returns the verified lane count."""
    runner = make_sm_runner(grid.scfg, "vmap")
    solo_plan = RunPlan(max_cycles=max_cycles)   # the padded solo oracle
    for w, workload in enumerate(workloads):
        for c, cfg in enumerate(cfgs):
            solo = lane_signature(S.finalize(simulate(
                workload, cfg, runner, plan=solo_plan, device=device)))
            lane = lane_signature(grid.stats[w][c])
            if lane != solo:
                raise AssertionError(
                    f"grid lane ({grid.names[w]}, {c}) differs from its "
                    f"solo run: {lane} != {solo}")
    return len(workloads) * len(cfgs)


def _scale_for(name: str, scale: float) -> float:
    """Trace-derived workloads keep their real CTA counts; --scale
    applies to the synthetic generators only."""
    return 1.0 if name.startswith("trace:") else scale


def run_grid(args, trace_names, device) -> None:
    n_w, n_c = args.grid
    names = list(trace_names) + [n for n in zoo_names()
                                 if n not in trace_names]
    if n_w > len(names):
        raise SystemExit(f"--grid {n_w} exceeds zoo size {len(names)}")
    base = BASES[args.base]
    workloads = [zoo_workload(n, scale=_scale_for(n, args.scale))
                 for n in names[:n_w]]
    if args.sample_lat or args.sample_disp:
        cfgs = sample_table_grid(base, n_c, args.sample_lat,
                                 args.sample_disp, seed=args.sample_seed)
    else:
        cfgs = default_grid(base, n_c)
    plan = plan_from_args(args)

    t0 = time.time()
    with profile_ctx(args):
        grid = grid_sweep(workloads, cfgs, plan=plan, device=device)
    wall = time.time() - t0
    print(json.dumps(grid.table(), indent=1))
    where = (f"{args.mesh[0]}x{args.mesh[1]} ('cfg','sm') mesh"
             if args.mesh else device)
    tm = grid.timings
    print(f"[zoo] grid {n_w} workloads × {n_c} configs = {n_w * n_c} lanes "
          f"(bucket_by={plan.bucket_by} layout={plan.layout} "
          f"buckets={tm.get('n_buckets')}) on {where}, wall={wall:.1f}s "
          f"(compile={tm.get('compile_s')}s execute={tm.get('execute_s')}s "
          f"{tm.get('lanes_per_s')} lanes/s)")

    if not args.no_manifest:
        tls = grid.timelines()
        mpath = T.write_manifest(
            "zoo_grid", scfg=grid.scfg, mesh_shape=args.mesh,
            timings=dict(tm, wall_s=round(wall, 4)),
            stats=[dict(grid.stats[w][c], workload=grid.names[w], cfg=c)
                   for w in range(n_w) for c in range(n_c)],
            timelines={k: v.tolist() for k, v in tls.items()} or None,
            lanes=[dict(describe(cfg), workload=grid.names[w], cfg=c)
                   for w in range(n_w) for c, cfg in enumerate(cfgs)],
            extra={"workloads": grid.names, "plan": plan.describe(),
                   "profile_dir": args.profile or None},
            device=device)
        print(f"[zoo] manifest: {mpath}")

    if args.check:
        n = check_grid_vs_solo(grid, workloads, cfgs, args.max_cycles,
                               device)
        print(f"[zoo] check OK: all {n} lanes bit-exact vs solo runs")


def run_one(args, device) -> None:
    w = zoo_workload(args.run, scale=_scale_for(args.run, args.scale))
    plan = plan_from_args(args)
    [cfg] = plan.apply_telemetry([BASES[args.base]])
    t0 = time.time()
    with profile_ctx(args):
        st = simulate(w, cfg, make_sm_runner(cfg, "vmap"), plan=plan,
                      device=device)
    wall = time.time() - t0
    out = S.finalize(st)
    print(json.dumps(dict(S.comparable(out), ipc=out["ipc"],
                          timeouts=out["timeouts"]), indent=1))
    flag = " [TIMEOUT: truncated at max_cycles]" if out["timeout"] else ""
    print(f"[zoo] {w.name}: {out['cycles']} GPU cycles, ipc={out['ipc']}, "
          f"wall={wall:.1f}s{flag}")

    if not args.no_manifest:
        scfg = static_part(cfg)
        tls = ({w.name: T.timeline(st).tolist()}
               if T.enabled(scfg) else None)
        mpath = T.write_manifest(
            "zoo_run", scfg=scfg,
            timings={"wall_s": round(wall, 4), "n_lanes": 1},
            stats=[dict(out, workload=w.name)], timelines=tls,
            lanes=[dict(describe(cfg), workload=w.name)],
            extra={"workloads": [w.name],
                   "profile_dir": args.profile or None},
            device=device)
        print(f"[zoo] manifest: {mpath}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--list", action="store_true",
                    help="list zoo workload names")
    ap.add_argument("--run", default="", help="simulate one zoo workload")
    ap.add_argument("--grid", nargs=2, type=int, metavar=("W", "C"),
                    help="sweep first W workloads × C configs as one run")
    ap.add_argument("--trace", default="", metavar="FILE|DIR",
                    help="ingest Accel-sim SASS trace subset file(s) and "
                         "register them as trace:<stem> zoo workloads")
    ap.add_argument("--base", choices=sorted(BASES), default="tiny")
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--check", action="store_true",
                    help="with --grid: verify every lane vs a solo run")
    add_sample_args(ap, when="--grid")
    add_plan_args(ap)
    args = ap.parse_args(argv)

    if (args.sample_lat or args.sample_disp) and not args.grid:
        raise SystemExit("--sample-lat/--sample-disp shape the config grid "
                         "and need --grid W C")
    trace_names = []
    if args.trace:
        trace_names = register_traces(args.trace)
    if args.list:
        for n in zoo_names():
            print(n)
        return
    if not (args.grid or args.run or trace_names):
        raise SystemExit("pick one of --list / --run NAME / --grid W C / "
                         "--trace FILE|DIR")
    device = resolve_device(args.device)
    if device.type == "cpu":
        # the simulator's tensors are small: extra threads only add overhead
        torch.set_num_threads(1)
    if args.grid:
        run_grid(args, trace_names, device)
    elif args.run:
        run_one(args, device)
    else:
        run_trace_summary(args, trace_names, device)


if __name__ == "__main__":
    main()
