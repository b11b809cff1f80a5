"""Shared launcher CLI surface — one home for the RunPlan flags.

The port's copy of the parts of ``repro.launch.cli`` that launch/dse.py
and launch/zoo.py need: ``add_plan_args`` installs the shared execution,
packing and observability flags, ``plan_from_args`` turns them into the
typed ``RunPlan`` (core/plan.py) that ``sweep``/``grid_sweep`` accept,
``add_sample_args`` the per-class timing-table sweep triples,
``add_search_args`` the analytic-prune search knobs (dse only),
``add_service_args``/``service_from_args`` the sim server's knobs
(launch/serve.py), ``profile_ctx`` the ``--profile DIR`` trace and
``base_config`` the named base configs.  The same command lines as the
reference's launchers work here, plus ``--device``: the launchers run on
the CUDA device unless it names another.

``--mesh A B`` builds a 2-D ('cfg','sm') mesh (core/distribute.py:
make_mesh) on ``--device``: the first A·B CUDA cards, one card at every
position with ``--device cuda:0``, or the CPU with ``--device cpu``.
``--cache-dir`` (a graph cache) parses as in the reference and raises
``NotImplementedError`` through RunPlan; ``--no-aot-cache`` is accepted
and inert: nothing is compiled.
"""
from __future__ import annotations

import argparse
import contextlib
import os

from repro_torch.core.plan import BUCKET_POLICIES, LAYOUTS, RunPlan


def add_plan_args(ap: argparse.ArgumentParser) -> None:
    """Install the shared execution/packing/observability flags.  Read
    them back with ``plan_from_args``."""
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    # -- execution / distribution ------------------------------------------
    ap.add_argument("--mesh", nargs=2, type=int, metavar=("A", "B"),
                    help="distribute over a 2-D ('cfg','sm') device mesh — "
                         "A config-lane groups × B SM blocks: the first A·B "
                         "CUDA cards, or the --device at every position "
                         "when it names one (cpu, cuda:0) "
                         "(core/distribute.py)")
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
                    help="bucket count ceiling for --bucket-by; unset with "
                         "--bucket-by cost picks the count that minimizes "
                         "the predicted total padded cost "
                         "(core/batch.py:choose_bucket_count), unset "
                         "otherwise keeps the classic ceiling of 4")
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
                    help="sample the per-SM counter timeline into S "
                         "preallocated rows per lane (core/telemetry.py); "
                         "0 = off (nothing added to the run)")
    ap.add_argument("--telemetry-every", type=int, default=1, metavar="N",
                    help="sampling cadence in quanta (default 1)")
    ap.add_argument("--profile", default="", metavar="DIR",
                    help="capture a torch.profiler trace of the run into "
                         "DIR/trace.json, alongside the manifest")
    ap.add_argument("--no-manifest", action="store_true",
                    help="skip writing the run manifest JSON under "
                         "experiments/runs/")


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


def add_search_args(ap: argparse.ArgumentParser) -> None:
    """The analytic-prune search knobs (core/search.py), dse-only."""
    ap.add_argument("--search", action="store_true",
                    help="search the config space instead of sweeping a "
                         "fixed grid: propose candidates, score them all "
                         "with the analytical surrogate (core/analytic.py),"
                         " cycle-accurately verify only the predicted "
                         "top-k per round (core/search.py)")
    ap.add_argument("--search-rounds", type=int, default=3,
                    help="propose→score→verify rounds (default 3)")
    ap.add_argument("--search-topk", type=int, default=8,
                    help="candidates verified per round in one sweep() "
                         "call (default 8)")
    ap.add_argument("--search-seed", type=int, default=0,
                    help="proposer seed — the full candidate sequence and "
                         "top-k are bit-reproducible per seed")
    ap.add_argument("--search-cands", type=int, default=256,
                    help="candidates proposed and analytically scored per "
                         "round (default 256)")
    ap.add_argument("--search-spread", type=float, default=2.0,
                    help="search box half-width: each base config entry "
                         "spans [v/spread, v*spread] (default 2.0); "
                         "--sample-* triples override per-class table "
                         "bounds")


def plan_from_args(args: argparse.Namespace) -> RunPlan:
    """The parsed shared flags as a validated RunPlan.  Builds the mesh
    here (--mesh A B, on --device), so launchers never pick devices for
    it themselves."""
    mesh = None
    if getattr(args, "mesh", None):
        from repro_torch.core.distribute import make_mesh
        mesh = make_mesh(*args.mesh, device=getattr(args, "device", None))
    return RunPlan(
        mesh=mesh,
        max_cycles=args.max_cycles,
        early_exit=not args.no_early_exit,
        bucket_by=args.bucket_by,
        max_buckets=args.max_buckets,
        layout=args.layout,
        cache_dir=args.cache_dir or None,
        aot_cache=not args.no_aot_cache,
        telemetry_samples=args.telemetry,
        telemetry_every=args.telemetry_every,
        # search knobs exist only on parsers that called add_search_args
        search_seed=getattr(args, "search_seed", 0),
        search_rounds=getattr(args, "search_rounds", 3),
        search_topk=getattr(args, "search_topk", 8),
    )


def add_service_args(ap: argparse.ArgumentParser) -> None:
    """The sim-server knobs (launch/serve.py → core/service.py): base
    hardware config and the batch-former's flush rule."""
    ap.add_argument("--base", choices=("tiny", "3080ti"), default="tiny",
                    help="base GPU config the server compiles for; job "
                         "overrides may only touch dynamic knobs "
                         "(sim/config.py:DYNAMIC_FIELDS + scheduler + "
                         "per-class tables)")
    ap.add_argument("--batch-lanes", type=int, default=8,
                    help="flush the queue once this many lanes are "
                         "waiting (the batch-size half of the flush rule)")
    ap.add_argument("--max-wait-ms", type=float, default=50.0,
                    help="flush when the oldest pending job has waited "
                         "this long (the deadline half of the flush rule)")
    ap.add_argument("--lane-quantum", type=int, default=None, metavar="Q",
                    help="round each bucket's lane count up to a multiple "
                         "of Q by repeating live lanes — padded slots "
                         "carry real requests and AOT signatures stay "
                         "stable as batch sizes drift")
    ap.add_argument("--manifests", action="store_true",
                    help="write a per-job run manifest (queue/compile/"
                         "execute latency split) under experiments/runs/")


def base_config(name: str):
    from repro_torch.sim.config import RTX3080TI, TINY
    return {"tiny": TINY, "3080ti": RTX3080TI}[name]


def service_from_args(args: argparse.Namespace, plan=None):
    """A configured (threaded) SimService from the parsed service+plan
    flags, on ``--device`` (the CUDA card when it is not given)."""
    from repro_torch.core.service import SimService
    return SimService(
        base=base_config(args.base),
        plan=plan,
        batch_lanes=args.batch_lanes,
        max_wait_s=args.max_wait_ms / 1000.0,
        lane_quantum=args.lane_quantum,
        manifests=args.manifests,
        device=args.device,
    )


@contextlib.contextmanager
def profile_ctx(args):
    """``--profile DIR``: a torch.profiler trace of the block (the CPU,
    and the card when there is one), written to DIR/trace.json; nothing
    when the flag is off."""
    if not getattr(args, "profile", ""):
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(args.profile, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
