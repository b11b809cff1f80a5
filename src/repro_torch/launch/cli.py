"""Shared launcher CLI surface — one home for the RunPlan flags.

The port's copy of the parts of ``repro.launch.cli`` that launch/dse.py
and launch/zoo.py need: ``add_plan_args`` installs the shared execution
and packing flags, ``plan_from_args`` turns them into the typed
``RunPlan`` (core/plan.py) that ``sweep``/``grid_sweep`` accept,
``add_sample_args`` the per-class timing-table sweep triples, and
``base_config`` the named base configs.  The same command lines as the
reference's launchers work here, plus ``--device``: the launchers run on
the CUDA device unless it names another.

Flags of later slices parse as in the reference and raise
``NotImplementedError`` naming their slice when used: ``--mesh`` (slice
10), ``--telemetry`` (slice 7, through RunPlan), ``--profile`` (a trace
beside the run manifests of slice 7), ``--cache-dir`` (a graph cache,
through RunPlan).  ``--no-aot-cache`` is accepted and inert: nothing is
compiled.  The port writes no run manifest yet, so ``--no-manifest``
changes nothing.
"""
from __future__ import annotations

import argparse

from repro_torch.core.plan import BUCKET_POLICIES, LAYOUTS, RunPlan


def add_plan_args(ap: argparse.ArgumentParser) -> None:
    """Install the shared execution/packing/observability flags.  Read
    them back with ``plan_from_args``."""
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    # -- execution / distribution ------------------------------------------
    ap.add_argument("--mesh", nargs=2, type=int, metavar=("A", "B"),
                    help="distribute over a 2-D ('cfg','sm') device mesh "
                         "(slice 10 of the port: not ported yet)")
    ap.add_argument("--max-cycles", type=int, default=1 << 15,
                    help="per-kernel quantum-loop horizon (timeout guard)")
    ap.add_argument("--no-early-exit", action="store_true",
                    help="disable the entry-convergence early exit "
                         "(core/engine.py) — debugging knob; results are "
                         "bit-identical either way")
    # -- bucketed lane packing ---------------------------------------------
    ap.add_argument("--bucket-by", choices=BUCKET_POLICIES, default="none",
                    help="group grid workload lanes into buckets of "
                         "similar padded shape / predicted cost and run "
                         "each bucket padded only to its own max "
                         "(core/batch.py:bucket_workloads)")
    ap.add_argument("--max-buckets", type=int, default=None,
                    help="bucket count ceiling for --bucket-by; unset keeps "
                         "the classic ceiling of 4 (with --bucket-by cost "
                         "the automatic count is slice 8 of the port)")
    ap.add_argument("--layout", choices=LAYOUTS, default="padded",
                    help="kernel-trace layout: 'ragged' concatenates "
                         "kernels with an instr_base offset table instead "
                         "of NOP-padding to the longest kernel")
    # -- caching -------------------------------------------------------------
    ap.add_argument("--cache-dir", default="", metavar="DIR",
                    help="persistent cache of compiled programs (the port "
                         "compiles none: waits for a graph cache)")
    ap.add_argument("--no-aot-cache", action="store_true",
                    help="accepted, inert: the port runs eagerly")
    # -- observability ------------------------------------------------------
    ap.add_argument("--telemetry", type=int, default=0, metavar="S",
                    help="sample the per-SM counter timeline into S rows "
                         "per lane (slice 7 of the port); 0 = off")
    ap.add_argument("--telemetry-every", type=int, default=1, metavar="N",
                    help="sampling cadence in quanta (default 1)")
    ap.add_argument("--profile", default="", metavar="DIR",
                    help="capture a profiler trace of the run into DIR "
                         "(with the run manifests of slice 7)")
    ap.add_argument("--no-manifest", action="store_true",
                    help="skip the run manifest (the port writes none "
                         "until slice 7)")


def add_sample_args(ap: argparse.ArgumentParser, when: str) -> None:
    """The per-class timing-table sweep triples (repeatable), shared by
    both launchers; ``when`` names the flag they depend on in help."""
    ap.add_argument("--sample-lat", nargs=3, action="append", default=[],
                    metavar=("CLASS", "LO", "HI"),
                    help=f"with {when}: config lanes step the per-class "
                         "result latency of CLASS "
                         "(fp32/int32/sfu/tensor/ldg/stg/bar) from LO to "
                         "HI; repeatable")
    ap.add_argument("--sample-disp", nargs=3, action="append", default=[],
                    metavar=("CLASS", "LO", "HI"),
                    help=f"with {when}: config lanes step the per-class "
                         "dispatch interval of CLASS from LO to HI; "
                         "repeatable")
    ap.add_argument("--sample-seed", type=int, default=None, metavar="SEED",
                    help="draw the --sample-* lanes uniformly at random "
                         "from [LO, HI] with this seed instead of the "
                         "deterministic LO..HI linear steps (PCG64; same "
                         "seed, same lanes)")


def plan_from_args(args: argparse.Namespace) -> RunPlan:
    """The parsed shared flags as a validated RunPlan."""
    if getattr(args, "mesh", None):
        raise NotImplementedError(
            f"--mesh {args.mesh[0]} {args.mesh[1]}: multi-device "
            "distribution is slice 10 of the port, not ported yet")
    if getattr(args, "profile", ""):
        raise NotImplementedError(
            "--profile: profiler traces beside run manifests come with "
            "telemetry, slice 7 of the port, not ported yet")
    return RunPlan(
        max_cycles=args.max_cycles,
        early_exit=not args.no_early_exit,
        bucket_by=args.bucket_by,
        max_buckets=args.max_buckets,
        layout=args.layout,
        cache_dir=args.cache_dir or None,
        aot_cache=not args.no_aot_cache,
        telemetry_samples=args.telemetry,
        telemetry_every=args.telemetry_every,
    )


def base_config(name: str):
    from repro_torch.sim.config import RTX3080TI, TINY
    return {"tiny": TINY, "3080ti": RTX3080TI}[name]
