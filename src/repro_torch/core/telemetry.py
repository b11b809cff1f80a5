"""Cycle-resolved counter timelines and run manifests.

The port's copy of ``repro.core.telemetry``, in two halves:

**Timelines.**  When ``StaticConfig.telemetry_samples > 0`` the state
(sim/state.py:init_state) grows a ``telem`` part, every leaf behind the
lane axis: a preallocated ``(L, telemetry_samples, N_COUNTERS)`` int32
sample buffer, a write index and a cumulative lockstep-waste
accumulator, both ``(L,)``.  After every quantum the engine adds the
quantum's waste and, every ``telemetry_every``-th quantum while the
buffer has room, writes a row: the cumulative per-SM counters summed
over SMs, the global memory-system counters, the live-warp count and the
waste so far.  The end of every kernel forces a row, so the last written
row always equals the run's final counters (``check_final_sample``).
Lockstep waste counts, per quantum, Δ cycles for every SM that sits
fully converged (no live warp, no request in flight) while its kernel is
still running.  A lane that stopped is frozen by the engine's select,
its ``telem`` with it, so a lane's timeline equals its solo run's.  With
telemetry off the state has no ``telem`` part and the engine launches
nothing for it.  On a mesh (core/distribute.py) the per-SM sums and the
waste add over an 'sm' group's blocks, so the row stays the machine's.

**Run manifests.**  The launchers write one JSON manifest per run, and
the sim server one per job (``write_job_manifest``), under
``experiments/runs/``: git sha, StaticConfig hash, host context (torch
version, device platform, name and count), timings, per-lane stats and
the sampled timelines, in the reference's schema, so
``launch/report.py`` of either package reads the other's manifests.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import asdict

import numpy as np
import torch

from repro_torch.core.stats import _np, to_jsonable

# ---------------------------------------------------------------------------
# counter layout
# ---------------------------------------------------------------------------

# cumulative per-SM counters (sim/state.py "stats_sm"), summed over SMs at
# sample time — each matches the identically-named stats.finalize total
CUM_SM = ("issued", "issued_mem", "l1_hit", "l1_miss", "cycles_issue",
          "stall", "warp_cycles")
# cumulative global counters (serial-region "stats")
CUM_GLOBAL = ("l2_hit", "l2_miss", "dram_req", "dram_row_hit",
              "ctas_launched")
# gauges: instantaneous / telemetry-only values
GAUGES = ("active_warps", "lockstep_waste")
COUNTERS = ("cycle",) + CUM_SM + CUM_GLOBAL + GAUGES
N_COUNTERS = len(COUNTERS)
# the columns that must equal stats.finalize totals in the final sample
FINAL_MATCH = CUM_SM + CUM_GLOBAL


def enabled(scfg) -> bool:
    """Telemetry adds state and work only when the StaticConfig asks for
    samples."""
    return getattr(scfg, "telemetry_samples", 0) > 0


def init(scfg, device, n_lanes: int = 1) -> dict:
    """The ``telem`` state part of ``n_lanes`` lanes: sample buffer, write
    index, cumulative lockstep waste."""
    i32 = torch.int32
    return {
        "buf": torch.zeros((n_lanes, scfg.telemetry_samples, N_COUNTERS),
                           dtype=i32, device=device),
        "idx": torch.zeros(n_lanes, dtype=i32, device=device),
        "waste": torch.zeros(n_lanes, dtype=i32, device=device),
    }


def sm_counts(warp: dict, req: dict, stats_sm: dict, n_instr=None) -> dict:
    """The per-lane sums over SMs that a row and the waste read, int32
    (``torch.sum`` of int32 would return int64): ``sm`` (L, len(CUM_SM))
    the per-SM counters, ``active`` (L,) the active warps and, given the
    lanes' ``n_instr``, ``idle`` (L,) the SMs with no live warp and no
    request in flight.  An 'sm' group adds its blocks' counts
    (core/parallel.py:group_counts): integer sums, so exact."""
    i32 = torch.int32
    out = {"sm": torch.stack([stats_sm[k] for k in CUM_SM], 1).sum(
               2, dtype=i32),
           "active": warp["active"].flatten(1).sum(1, dtype=i32)}
    if n_instr is not None:
        live = warp["active"] & ~((warp["pc"] >= n_instr.reshape(-1, 1, 1))
                                  & (warp["pending"] == 0))
        sm_live = live.any(2)                              # (L, n_sm)
        sm_busy = (req["stage"] != 0).any(2)
        out["idle"] = (~(sm_live | sm_busy)).sum(1, dtype=i32)
    return out


def _counts(state: dict, n_instr=None) -> dict:
    return sm_counts(state["warp"], state["req"], state["stats_sm"], n_instr)


def _row(telem: dict, state: dict, counts: dict):
    """One (L, N_COUNTERS) snapshot of the current counters."""
    glob = torch.stack([state["stats"][k] for k in CUM_GLOBAL], 1)
    return torch.cat([
        state["ctrl"]["cycle"][:, None],
        counts["sm"],
        glob.to(torch.int32),
        counts["active"][:, None],
        telem["waste"][:, None]], 1)


def waste_increment(state: dict, counts: dict, scfg):
    """Lockstep waste accrued this quantum, per lane: Δ cycles for every
    idle SM (``counts['idle']``) while the kernel is not done.  Reads the
    state after the SM phase, with this quantum's ``done_cycle`` stamped,
    so the quantum a kernel converges in adds none."""
    running = state["ctrl"]["done_cycle"] < 0
    return torch.where(running, counts["idle"] * scfg.quantum, 0)


def sample(telem: dict, state: dict, scfg, force: bool = False,
           counts: dict | None = None) -> dict:
    """Maybe write a row, per lane.  Periodic rows fire every
    ``telemetry_every``-th quantum while the buffer has room; ``force``
    (end of kernel) always writes, over the last slot when the buffer is
    full.  The row goes in with a ``where`` at one slot per lane.
    ``counts``: the state's ``sm_counts``, when the caller has them."""
    n = scfg.telemetry_samples
    idx = telem["idx"]
    if force:
        do = torch.ones_like(idx, dtype=torch.bool)
    else:
        q = state["ctrl"]["cycle"] // scfg.quantum
        do = (q % scfg.telemetry_every == 0) & (idx < n)
    pos = idx.clamp(0, n - 1)
    slot = torch.arange(n, dtype=idx.dtype, device=idx.device)
    hit = (slot[None, :] == pos[:, None]) & do[:, None]    # (L, S)
    row = _row(telem, state, _counts(state) if counts is None else counts)
    buf = torch.where(hit[:, :, None], row[:, None, :], telem["buf"])
    return dict(telem, buf=buf,
                idx=torch.clamp(idx + do.to(idx.dtype), max=n))


def quantum_update(telem: dict, state: dict, trace: dict, scfg,
                   counts: dict | None = None) -> dict:
    """The telemetry step at the end of every quantum: add the quantum's
    lockstep waste, then maybe take a periodic sample.  ``counts``: the
    state's ``sm_counts`` with ``idle``, when the caller has them."""
    if counts is None:
        counts = _counts(state, trace["n_instr"])
    telem = dict(telem, waste=telem["waste"] + waste_increment(
        state, counts, scfg))
    return sample(telem, state, scfg, counts=counts)


# ---------------------------------------------------------------------------
# host-side extraction
# ---------------------------------------------------------------------------

def timeline(state: dict) -> np.ndarray:
    """The used rows of one lane's sample buffer as an (n_used,
    N_COUNTERS) int32 array (a lane-sliced state: take_lane /
    take_grid_lane)."""
    telem = state["telem"]
    return _np(telem["buf"])[:int(telem["idx"])]


def check_final_sample(state: dict, finalized: dict) -> list:
    """Names of FINAL_MATCH counters whose last timeline sample does NOT
    equal the finalize() total — empty list means the invariant holds."""
    tl = timeline(state)
    if tl.shape[0] == 0:
        return ["<no samples>"]
    last = tl[-1]
    return [name for name in FINAL_MATCH
            if int(last[COUNTERS.index(name)]) != int(finalized[name])]


# ---------------------------------------------------------------------------
# run manifests
# ---------------------------------------------------------------------------

MANIFEST_SCHEMA = 1


def runs_dir() -> str:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    return os.path.join(here, "experiments", "runs")


def git_sha() -> str:
    sha = os.environ.get("GITHUB_SHA", "")
    if not sha:
        import subprocess
        try:
            sha = subprocess.run(
                ["git", "rev-parse", "HEAD"], capture_output=True,
                text=True, timeout=10,
                cwd=os.path.dirname(os.path.abspath(__file__))).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            sha = ""
    return sha or "unknown"


def static_hash(scfg) -> str:
    """Stable short hash of a StaticConfig; equal to the reference's for
    the same config, so calibration rows cross between the packages."""
    payload = json.dumps(asdict(scfg), sort_keys=True)
    return hashlib.sha1(payload.encode()).hexdigest()[:12]


def host_context(device=None) -> dict:
    """Where a run happened: hostname, torch version, and the device the
    run used (``device``; the CUDA card when there is one, else the
    CPU, when it is not given)."""
    import platform
    import socket

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    ctx = {
        "hostname": socket.gethostname(),
        "platform": platform.platform(),
        "python": platform.python_version(),
        "torch_version": torch.__version__,
        "device_platform": device.type,
    }
    if device.type == "cuda":
        ctx["device_kind"] = torch.cuda.get_device_name(device)
        ctx["device_count"] = torch.cuda.device_count()
    else:
        ctx["device_kind"] = platform.processor() or platform.machine()
        ctx["device_count"] = 1
    return ctx


def write_manifest(kind: str, *, scfg=None, mesh_shape=None, timings=None,
                   stats=None, timelines=None, lanes=None, extra=None,
                   out_dir=None, device=None) -> str:
    """Write one run manifest JSON under experiments/runs/ (or
    ``out_dir``); returns its path.

    ``stats``: list of finalized per-lane stat dicts.  ``timelines``:
    {lane_key: [[row], ...]} (column order = COUNTERS).  ``lanes``:
    per-lane descriptions.  ``device``: the device the run used."""
    out_dir = out_dir or runs_dir()
    os.makedirs(out_dir, exist_ok=True)
    stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
    path = os.path.join(out_dir, f"{stamp}_{kind.replace('/', '_')}.json")
    # never silently overwrite a same-second manifest
    seq = 1
    while os.path.exists(path):
        path = os.path.join(out_dir,
                            f"{stamp}_{kind.replace('/', '_')}.{seq}.json")
        seq += 1
    payload = {
        "schema": MANIFEST_SCHEMA,
        "kind": kind,
        "created_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "git_sha": git_sha(),
        "host": host_context(device),
        "mesh_shape": list(mesh_shape) if mesh_shape else None,
        "timings": to_jsonable(timings or {}),
    }
    if scfg is not None:
        payload["static_config"] = to_jsonable(asdict(scfg))
        payload["static_config_hash"] = static_hash(scfg)
        payload["telemetry"] = {
            "samples": getattr(scfg, "telemetry_samples", 0),
            "every": getattr(scfg, "telemetry_every", 1),
            "counters": list(COUNTERS),
        }
    if lanes is not None:
        payload["lanes"] = to_jsonable(lanes)
    if stats is not None:
        payload["stats"] = to_jsonable(stats)
    if timelines is not None:
        payload["timelines"] = to_jsonable(timelines)
    if extra:
        payload.update(to_jsonable(extra))
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    return path


def write_job_manifest(job, *, scfg=None, out_dir=None, device=None) -> str:
    """Per-job manifest for the sim server (core/service.py): the job's
    identity, its per-lane ``finalize`` stats, and the latency split the
    serving story is about — how long the job queued against how long its
    batch spent executing.  Same schema and venue as every other run
    manifest (experiments/runs/), so report.py and
    cost_hints_from_manifests see served jobs like any other run;
    ``device`` is the server's."""
    return write_manifest(
        "serve_job", scfg=scfg, stats=job.stats,
        timings=dict(job.latency(), **{
            "n_lanes": job.n_lanes,
            "batch_lanes": (job.batch or {}).get("n_lanes"),
            "aot_cache": (job.batch or {}).get("aot_cache"),
        }),
        lanes=[{"workload": job.name}] * job.n_lanes,
        extra={"job": {"id": job.id, "seq": job.seq,
                       "batch": job.batch}},
        out_dir=out_dir, device=device)
