"""Design-space-exploration launcher — N GPU configs as N lanes of one run.

  python -m repro_torch.launch.dse --n 8 --workload hotspot --scale 0.02
  python -m repro_torch.launch.dse --base 3080ti --axis dram_row_penalty \\
      --values 8,16,24,48
  python -m repro_torch.launch.dse --n 8 --sample-lat fp32 2 8 --check
  python -m repro_torch.launch.dse --n 4 --check --device cpu
  python -m repro_torch.launch.dse --base 3080ti --workload nn --scale 0.5 \\
      --search --check

The port's ``repro.launch.dse``: the N configs run as N lanes of one
lockstep sweep (core/sweep.py), on the CUDA device unless ``--device``
names another.  ``--check`` re-runs every lane solo and asserts its
comparable stats and timeouts equal the lane's.  Each run writes a
manifest under ``experiments/runs/`` (core/telemetry.py) unless
``--no-manifest``; ``--telemetry S`` adds the lanes' counter timelines
to it.

``--search`` explores the config space instead of sweeping a fixed grid
(core/search.py): seeded proposals, all scored by the analytical
surrogate, the predicted top-k of each round verified in one sweep;
``--check`` then re-runs every verified lane solo.

``--sample-lat CLASS LO HI`` (repeatable; likewise ``--sample-disp``)
sweeps a PER-CLASS entry of the DynConfig's timing tables: the N lanes
step the result latency (or dispatch interval) of instruction class
CLASS (fp32/int32/sfu/tensor/ldg/stg/bar) evenly from LO to HI.  The ldg
latency entry is inert (load latency is cache-dependent).

Without --axis/--sample-*, a default grid is swept: L2 latency × scheduler
(GTO/LRR).  All lanes share one StaticConfig shape.

``--mesh A B`` splits the config lanes over a 2-D ('cfg', 'sm') device
mesh (core/distribute.py) — A config groups × B SM blocks, on the first
A·B CUDA cards or, with ``--device cpu``, the CPU at every position —
with every lane bit-exact vs its solo run (``--check``):
  python -m repro_torch.launch.dse --n 8 --mesh 2 2 --check --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.core import stats as S
from repro_torch.core import telemetry as T
from repro_torch.core.engine import simulate
from repro_torch.core.parallel import make_sm_runner
from repro_torch.core.plan import RunPlan
from repro_torch.core.sweep import sweep
from repro_torch.device import resolve_device
from repro_torch.launch.cli import (add_plan_args, add_sample_args,
                                    add_search_args, base_config,
                                    plan_from_args, profile_ctx)
from repro_torch.sim.config import (DYNAMIC_FIELDS, SCHEDULERS, GPUConfig,
                                    class_index)
from repro_torch.workloads import make_workload

BASES = {name: base_config(name) for name in ("3080ti", "tiny")}


def default_grid(base: GPUConfig, n: int) -> list:
    """n configs: alternate GTO/LRR while stepping L2 latency."""
    out = []
    for i in range(n):
        out.append(dataclasses.replace(
            base,
            l2_lat=base.l2_lat // 2 + (i // 2) * base.l2_lat // 2,
            scheduler="gto" if i % 2 == 0 else "lrr"))
    return out


def axis_grid(base: GPUConfig, axis: str, values: list) -> list:
    if axis == "scheduler":
        return [dataclasses.replace(base, scheduler=v) for v in values]
    if axis not in DYNAMIC_FIELDS:
        raise SystemExit(f"--axis must be one of {DYNAMIC_FIELDS} or "
                         f"'scheduler', got {axis!r}")
    return [dataclasses.replace(base, **{axis: int(v)}) for v in values]


def sample_table_grid(base: GPUConfig, n: int, sample_lat=(),
                      sample_disp=(), seed: int = None) -> list:
    """n configs sampling per-class table entries over [lo, hi].

    ``sample_lat`` / ``sample_disp``: sequences of (class_name, lo, hi)
    triples; several triples vary jointly across the same n lanes.
    Default: lane i gets entry = round(lo + i/(n-1) * (hi-lo)).  With
    ``seed`` each lane instead draws every sampled entry uniformly from
    [lo, hi] (PCG64: same seed, same lanes)."""
    rng = (np.random.Generator(np.random.PCG64(seed))
           if seed is not None else None)
    out = []
    for i in range(n):
        frac = i / max(n - 1, 1)
        lat = list(base.lat_of_class)
        disp = list(base.disp_of_class)
        for table, samples in ((lat, sample_lat), (disp, sample_disp)):
            for cls, lo, hi in samples:
                lo, hi = int(lo), int(hi)
                table[class_index(str(cls))] = (
                    int(rng.integers(lo, hi + 1)) if rng is not None
                    else round(lo + frac * (hi - lo)))
        out.append(dataclasses.replace(base, lat_of_class=tuple(lat),
                                       disp_of_class=tuple(disp)))
    return out


def describe(cfg: GPUConfig) -> dict:
    d = {k: getattr(cfg, k) for k in DYNAMIC_FIELDS}
    d["scheduler"] = cfg.scheduler
    # always present so every row of a sweep has the same keys
    d["lat"] = list(cfg.lat_of_class)
    d["disp"] = list(cfg.disp_of_class)
    return d


def lane_signature(stats: dict) -> dict:
    """What --check compares: the comparable stats plus the truncation
    counter (a lane must also time out exactly when its solo run does)."""
    return dict(S.comparable(stats), timeouts=stats["timeouts"])


def check_lanes_vs_solo(w, cfgs, stats, max_cycles: int, device) -> int:
    """Re-run every config solo and assert its lane is bit-identical.
    Returns the verified lane count."""
    solo_plan = RunPlan(max_cycles=max_cycles)
    for i, cfg in enumerate(cfgs):
        solo = lane_signature(S.finalize(simulate(
            w, cfg, make_sm_runner(cfg, "vmap"), plan=solo_plan,
            device=device)))
        lane = lane_signature(stats[i])
        if lane != solo:
            raise AssertionError(f"lane {i} differs from its solo run: "
                                 f"{lane} != {solo}")
    return len(cfgs)


def lane_config(scfg, flat: dict) -> GPUConfig:
    """The GPUConfig of a ``(StaticConfig, flat overrides)`` lane — how
    ``--check`` replays a search lane solo."""
    sched = {v: k for k, v in SCHEDULERS.items()}[int(flat["sched"])]
    return GPUConfig(**dataclasses.asdict(scfg),
                     **{k: int(flat[k]) for k in DYNAMIC_FIELDS},
                     scheduler=sched, lat_of_class=tuple(flat["lat"]),
                     disp_of_class=tuple(flat["disp"]))


def run_search(args, plan, base, w, device):
    """--search: analytic-prune search instead of a fixed-grid sweep."""
    from repro_torch.core import analytic
    from repro_torch.core.search import SearchSpace, search

    space = SearchSpace.from_base(base, spread=args.search_spread,
                                  sample_lat=args.sample_lat,
                                  sample_disp=args.sample_disp)
    t0 = time.time()
    with profile_ctx(args):
        result = search(w, space, plan=plan,
                        n_candidates=args.search_cands,
                        calibrate_from=None if args.no_manifest else "",
                        log=print, device=device)
    wall = time.time() - t0

    rep = result.report()
    print(json.dumps(rep, indent=1))
    print(f"[dse] search {w.name}: scored {result.n_scored} candidates "
          f"analytically, verified {result.n_verified} cycle-accurately "
          f"over {len(result.rounds)} rounds, best={result.best_cycles} "
          f"cycles, wall={wall:.1f}s")

    if not args.no_manifest:
        # verified lanes + stats + the workload's feature vector: exactly
        # the rows calibration_rows_from_manifests harvests to warm-start
        # the next search of this StaticConfig
        mpath = T.write_manifest(
            "search", scfg=result.scfg, mesh_shape=args.mesh,
            timings={"wall_s": round(wall, 4)},
            stats=[st for _, _, st in result.verified],
            lanes=[analytic.describe_vec(v) for v, _, _ in result.verified],
            extra={"workload": w.name, "plan": plan.describe(),
                   "features": result.features.tolist(),
                   "search": rep, "profile_dir": args.profile or None},
            device=device)
        print(f"[dse] manifest: {mpath}")

    if args.check:
        cfgs = [lane_config(result.scfg, analytic.decode(v))
                for v, _, _ in result.verified]
        n = check_lanes_vs_solo(w, cfgs, [st for _, _, st in result.verified],
                                args.max_cycles, device)
        print(f"[dse] check OK: all {n} verified lanes bit-exact vs solo")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", choices=sorted(BASES), default="tiny")
    ap.add_argument("--workload", default="hotspot")
    ap.add_argument("--scale", type=float, default=0.02)
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--axis", default="",
                    help="sweep one config field instead of the default grid")
    ap.add_argument("--values", default="",
                    help="comma-separated values for --axis")
    ap.add_argument("--check", action="store_true",
                    help="verify every lane against a solo engine run")
    add_sample_args(ap, when="the N lanes")
    add_search_args(ap)
    add_plan_args(ap)
    args = ap.parse_args(argv)
    plan = plan_from_args(args)
    device = resolve_device(args.device)
    if device.type == "cpu":
        # the simulator's tensors are small: extra threads only add overhead
        torch.set_num_threads(1)

    base = BASES[args.base]
    if args.search:
        if args.axis:
            raise SystemExit("--search and --axis are separate modes; "
                             "pick one (--sample-* triples shape the "
                             "search box instead)")
        w = make_workload(args.workload, scale=args.scale)
        return run_search(args, plan, base, w, device)
    if args.axis and (args.sample_lat or args.sample_disp):
        raise SystemExit("--axis and --sample-lat/--sample-disp are "
                         "separate sweep modes; pick one")
    if args.axis:
        values = [v for v in args.values.split(",") if v]
        if not values:
            raise SystemExit("--axis needs --values v1,v2,...")
        cfgs = axis_grid(base, args.axis, values)
    elif args.sample_lat or args.sample_disp:
        cfgs = sample_table_grid(base, args.n, args.sample_lat,
                                 args.sample_disp, seed=args.sample_seed)
    else:
        cfgs = default_grid(base, args.n)

    w = make_workload(args.workload, scale=args.scale)
    t0 = time.time()
    with profile_ctx(args):
        result = sweep(w, cfgs, plan=plan, device=device)
    wall = time.time() - t0

    rows = []
    for cfg, st in zip(cfgs, result.stats):
        rows.append(dict(describe(cfg), cycles=st["cycles"], ipc=st["ipc"],
                         l1_miss=st["l1_miss"], l2_miss=st["l2_miss"],
                         dram_req=st["dram_req"]))
    print(json.dumps(rows, indent=1))
    where = (f"{args.mesh[0]}x{args.mesh[1]} ('cfg','sm') mesh"
             if args.mesh else device)
    tm = result.timings
    print(f"[dse] {len(cfgs)} configs × {w.name}: one lockstep run on "
          f"{where}, wall={wall:.1f}s (compile={tm.get('compile_s')}s "
          f"execute={tm.get('execute_s')}s {tm.get('lanes_per_s')} lanes/s)")

    if not args.no_manifest:
        tls = result.timelines()
        mpath = T.write_manifest(
            "dse", scfg=result.scfg, mesh_shape=args.mesh,
            timings=dict(tm, wall_s=round(wall, 4)),
            stats=result.stats,
            timelines={k: v.tolist() for k, v in tls.items()} or None,
            lanes=[describe(c) for c in cfgs],
            extra={"workload": w.name, "plan": plan.describe(),
                   "profile_dir": args.profile or None},
            device=device)
        print(f"[dse] manifest: {mpath}")

    if args.check:
        n = check_lanes_vs_solo(w, plan.apply_telemetry(cfgs), result.stats,
                                args.max_cycles, device)
        print(f"[dse] check OK: all {n} lanes bit-exact vs solo")


if __name__ == "__main__":
    main()
