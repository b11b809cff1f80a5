"""Batched design-space exploration: many simulations as lanes of one run.

The port's counterpart of ``repro.core.sweep``.  The reference runs N
configs of one workload as one ``jit(vmap(run_workload))`` program; here
the N configs are N lanes of one lane-batched state (sim/state.py), and
every quantum steps all lanes together: one memory phase, one CTA
dispatch and — on the card — one ``sm_quantum`` launch per quantum for
all lanes (core/engine.py).  Every timing parameter reaches the engine as
a per-lane ``DynConfig`` leaf, so only configs that share one
``StaticConfig`` batch.  Each lane is bit-identical to a solo run of its
(workload, config) pair: a lane that finished is frozen by select while
the others run on (core/engine.py:run_kernel).

  sweep(workload, cfgs)           one workload × N configs
  grid_sweep(workloads, cfgs)     W workloads × C configs, W·C lanes per
                                  bucket (core/batch.py:bucket_workloads)
  pair_sweep([(w, cfg), ...])     N unrelated (workload, config) lanes

Workloads of a grid or a pair sweep are padded to a shared (kernel
count, instruction count) with inert kernels and NOP slots, or
ragged-concatenated (``plan.layout``); a sweep's one workload is shared
by every lane through a stride-0 view.  Runs on the CUDA device unless
``device`` names another one; with ``plan.mesh`` a sweep or grid runs
on the mesh's devices instead (core/distribute.py).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from repro_torch.core import batch
from repro_torch.core import stats as S
from repro_torch.core import telemetry
from repro_torch.core.batch import (concat_kernels, concat_workloads,
                                    stack_kernels, stack_workloads)
from repro_torch.core.engine import run_workload_stacked
from repro_torch.core.parallel import make_sm_runner
from repro_torch.core.plan import RunPlan, resolve_plan
from repro_torch.core.stats import take_grid_lane, take_lane
from repro_torch.device import resolve_device
from repro_torch.sim.config import DynConfig, StaticConfig, split_config
from repro_torch.sim.state import init_state
from repro_torch.sim.trace import Workload

def stack_dyn(cfgs, device=None):
    """Split each config and stack the ``DynConfig``s along a new leading
    lane axis — scalar leaves become ``(n,)``, the per-class
    ``core.lat``/``core.disp`` tables ``(n, N_CLASSES)``.

    A lane may be a full ``GPUConfig`` or a pre-split ``(StaticConfig,
    dyn_overrides)`` pair (flat dict or ``DynConfig``).  All lanes must
    share the same StaticConfig, and every lane is validated before any
    run; a failure is re-raised naming the offending lane."""
    device = resolve_device(device)
    if not cfgs:
        raise ValueError("empty config list")
    splits = []
    for i, c in enumerate(cfgs):
        try:
            if isinstance(c, tuple) and len(c) == 2:
                splits.append(split_config(c[0], c[1], device=device))
            else:
                splits.append(split_config(c, device=device))
        except ValueError as e:
            raise ValueError(f"config lane {i}: {e}") from None
    scfg = splits[0][0]
    for i, (s, _) in enumerate(splits):
        if s != scfg:
            raise ValueError(
                f"config {i} has a different static shape than config 0 "
                f"(vmap lanes must share one StaticConfig):\n  {s}\n  {scfg}")
    return scfg, DynConfig.stack([d for _, d in splits])


def _lanes(tree: dict, n: int) -> dict:
    """One workload's trace shared by ``n`` lanes: stride-0 views."""
    return {f: v.expand(n, *v.shape) for f, v in tree.items()}


def _runner(scfg, mode, max_cycles, early_exit):
    sm_runner = make_sm_runner(scfg, mode)

    def run(state0, stacked, dyn):
        return run_workload_stacked(state0, stacked, scfg, dyn, sm_runner,
                                    max_cycles, early_exit)
    return run


def make_sweep_runner(scfg: StaticConfig, mode: str = "vmap",
                      max_cycles: int = 1 << 20, early_exit: bool = True):
    """``(state_batch, stacked_kernels, dyn_batch) -> final state batch``:
    one workload's stacked (or ragged) kernels, shared by every config
    lane of ``dyn_batch``."""
    run = _runner(scfg, mode, max_cycles, early_exit)

    def sweep_run(state0, stacked, dyn):
        return run(state0, _lanes(stacked, dyn.icnt.icnt_lat.shape[0]), dyn)
    return sweep_run


def grid_lanes(stacked: dict, dyn: DynConfig) -> tuple:
    """W stacked workloads × C configs as W·C lanes, workload-major: the
    lanes' (stacked kernels, DynConfig)."""
    n_w = stacked["n_ctas"].shape[0]
    n_c = dyn.icnt.icnt_lat.shape[0]
    lanes = {f: v.repeat_interleave(n_c, 0) for f, v in stacked.items()}
    return lanes, dyn.map(lambda x: x.repeat(n_w, *(1,) * (x.dim() - 1)))


def make_grid_runner(scfg: StaticConfig, mode: str = "vmap",
                     max_cycles: int = 1 << 20, early_exit: bool = True):
    """``(state_grid, stacked_workloads, dyn_batch) -> final state`` with
    two leading lane axes (workload, config): W stacked workloads × C
    configs run as W·C lanes, workload-major; the grid state comes in
    flat (W·C lanes) and goes out shaped (W, C, …)."""
    run = _runner(scfg, mode, max_cycles, early_exit)

    def grid_run(state0, stacked, dyn):
        n_w = stacked["n_ctas"].shape[0]
        n_c = dyn.icnt.icnt_lat.shape[0]
        out = run(state0, *grid_lanes(stacked, dyn))
        return _map(out, lambda x: x.reshape(n_w, n_c, *x.shape[1:]))
    return grid_run


def make_pair_runner(scfg: StaticConfig, mode: str = "vmap",
                     max_cycles: int = 1 << 20, early_exit: bool = True):
    """``(state_batch, stacked_workloads, dyn_batch) -> final state
    batch``: lane ``i`` runs workload ``i`` of the stack under config
    ``i`` — N unrelated submissions as N lanes."""
    return _runner(scfg, mode, max_cycles, early_exit)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def timed_call(runner, *args, n_lanes: int = 1) -> tuple:
    """Run ``runner(*args)`` with the wall-clock split the run manifests
    record.  Nothing is compiled, so ``compile_s`` is None; ``execute_s``
    ends after the device has finished (``torch.cuda.synchronize``).
    Returns (result, timings)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = runner(*args)
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    execute_s = round(time.perf_counter() - t0, 4)
    return out, {"n_lanes": n_lanes, "compile_s": None,
                 "execute_s": execute_s,
                 "lanes_per_s": round(n_lanes / max(execute_s, 1e-9), 2)}


def _run_device(plan: RunPlan, device) -> torch.device:
    """Where a run's tensors live: the mesh's first device when the plan
    has a mesh (its devices win; a ``device`` of another type raises),
    else ``device`` (core/device.py)."""
    if plan.mesh is not None:
        from repro_torch.core.distribute import mesh_device
        return mesh_device(plan.mesh, device)
    return resolve_device(device)


def _to_cpu(state: dict) -> dict:
    """The final state on the host, read once for every lane's stats."""
    return _map(state, lambda x: x.cpu())


@dataclass
class SweepResult:
    scfg: StaticConfig
    state: dict                       # batched final state (leading lane axis)
    n: int
    stats: list = field(default_factory=list)   # per-lane finalized dicts
    timings: dict = field(default_factory=dict)

    @property
    def cycles(self):
        return [s["cycles"] for s in self.stats]

    def table(self, keys=("cycles", "ipc", "l1_miss", "l2_miss",
                          "dram_req")) -> list:
        return [{k: s[k] for k in keys} for s in self.stats]

    def timelines(self) -> dict:
        """{lane_index_str: (n_used, N_COUNTERS) sample rows} for every
        lane, when the StaticConfig enabled telemetry."""
        if not telemetry.enabled(self.scfg):
            return {}
        return {str(i): telemetry.timeline(take_lane(self.state, i))
                for i in range(self.n)}


def sweep(workload: Workload, cfgs, mode: str = None,
          max_cycles: int = None, mesh=None, exchange: str = None,
          plan: RunPlan = None, device=None) -> SweepResult:
    """Run ``workload`` under every config, one lane per config, all
    lanes in one lockstep run.  Execution knobs come from ``plan=``
    (core/plan.py:RunPlan); the legacy flat kwargs build one.  With a
    mesh, lanes are split over 'cfg' and each lane's SM axis over 'sm'
    (core/distribute.py) — same stats, bit-exact, at any mesh shape; the
    mesh's devices win over ``device``."""
    plan = resolve_plan(plan, where="sweep", mode=mode,
                        max_cycles=max_cycles, mesh=mesh, exchange=exchange)
    device = _run_device(plan, device)
    cfgs = plan.apply_telemetry(cfgs)
    scfg, dyn_batch = stack_dyn(cfgs, device)
    batch.check_workload_fits(scfg, workload)
    packs = [k.pack(device) for k in workload.kernels]
    stacked = (concat_kernels(packs) if plan.layout == "ragged"
               else stack_kernels(packs))
    n = len(cfgs)
    state0 = init_state(scfg, device, n)
    if plan.mesh is not None:
        from repro_torch.core import distribute as D

        D.check_mesh(plan.mesh, scfg, n)
        dyn_batch = D.place_lanes(dyn_batch, plan.mesh)
        stacked = D.place_lanes(stacked, plan.mesh, ())
        state0 = D.place_state(state0, plan.mesh, D.CFG_AXIS)
        runner = D.make_dist_sweep_runner(scfg, plan.mesh, plan.max_cycles,
                                          plan.exchange, plan.early_exit)
    else:
        runner = make_sweep_runner(scfg, plan.mode, plan.max_cycles,
                                   plan.early_exit)
    bstate, timings = timed_call(runner, state0, stacked, dyn_batch,
                                 n_lanes=n)
    host = _to_cpu(bstate)
    stats = [S.finalize(take_lane(host, i)) for i in range(n)]
    return SweepResult(scfg=scfg, state=bstate, n=n, stats=stats,
                       timings=timings)


# ---------------------------------------------------------------------------
# grid sweep: benchmarks × configs
# ---------------------------------------------------------------------------

@dataclass
class GridResult:
    scfg: StaticConfig
    state: dict          # final state, leading (workload, config) lane axes
    names: list          # workload names, grid row order
    n_workloads: int
    n_cfgs: int
    stats: list = field(default_factory=list)   # stats[w][c] finalized dict
    timings: dict = field(default_factory=dict)
    # [(workload_indices, bucket_state), ...]; ``state`` is the one
    # bucket's state when the grid ran as one bucket, else None
    buckets: list = None

    def lane_state(self, w: int, c: int) -> dict:
        """Final state of lane (workload ``w``, config ``c``), whichever
        bucket it ran in."""
        if self.buckets is not None:
            for idxs, bstate in self.buckets:
                if w in idxs:
                    return take_grid_lane(bstate, idxs.index(w), c)
            raise KeyError(f"workload index {w} in no bucket")
        return take_grid_lane(self.state, w, c)

    def table(self, keys=("cycles", "ipc", "l1_miss", "l2_miss",
                          "dram_req")) -> list:
        return [{"workload": self.names[w], "cfg": c,
                 **{k: self.stats[w][c][k] for k in keys}}
                for w in range(self.n_workloads)
                for c in range(self.n_cfgs)]

    def timelines(self) -> dict:
        """{"<workload>/<cfg>": (n_used, N_COUNTERS) sample rows} per grid
        lane, when the StaticConfig enabled telemetry."""
        if not telemetry.enabled(self.scfg):
            return {}
        return {f"{self.names[w]}/{c}": telemetry.timeline(
                    self.lane_state(w, c))
                for w in range(self.n_workloads)
                for c in range(self.n_cfgs)}


def bucket_groups(workloads, plan: RunPlan, scfg: StaticConfig) -> list:
    """The one bucket-forming policy ``grid_sweep`` and ``pair_sweep``
    share: partition the workload-lane indices per ``plan.bucket_by`` /
    ``plan.max_buckets`` (core/batch.py:bucket_workloads), seeding 'cost'
    keys from measured run-manifest hints refined by the analytic model
    when the bucket count is chosen automatically."""
    hints = None
    max_buckets = plan.max_buckets
    if plan.bucket_by == "cost":
        hints = batch.cost_hints_from_manifests()
        if max_buckets is None:
            # lanes without a measured hint get an analytically predicted
            # cost key, and bucket_workloads(max_buckets=None) minimizes
            # the predicted total padded cost over the candidate counts
            from repro_torch.core import analytic
            hints = dict({w.name: analytic.predicted_workload_cost(w, scfg)
                          for w in workloads}, **hints)
    elif max_buckets is None:
        max_buckets = 4            # the classic ceiling for non-cost modes
    return batch.bucket_workloads(workloads, plan.bucket_by, max_buckets,
                                  hints)


def _add_timings(total: dict, tm: dict) -> None:
    total["execute_s"] = round(total["execute_s"] + tm["execute_s"], 4)


def grid_sweep(workloads, cfgs, mode: str = None, max_cycles: int = None,
               mesh=None, exchange: str = None, plan: RunPlan = None,
               device=None) -> GridResult:
    """Simulate every workload under every config — W×C lanes, one
    lockstep run per BUCKET.  Workloads are padded to a shared (kernel
    count, instruction count) with inert kernels/NOP slots (or
    ragged-concatenated, ``plan.layout``), so each lane is bit-identical
    to a solo ``simulate()`` of that (workload, config) pair.  Stats come
    back in the original lane order.

    With a mesh (2-D ('cfg', 'sm'), core/distribute.py) config lanes are
    split over 'cfg', each lane's SM axis over 'sm'; every group runs
    every workload.  Stats are bit-exact at any mesh shape."""
    plan = resolve_plan(plan, where="grid_sweep", mode=mode,
                        max_cycles=max_cycles, mesh=mesh, exchange=exchange)
    device = _run_device(plan, device)
    cfgs = plan.apply_telemetry(cfgs)
    scfg, dyn_batch = stack_dyn(cfgs, device)
    for w in workloads:
        batch.check_workload_fits(scfg, w)
    nw, nc = len(workloads), len(cfgs)
    groups = bucket_groups(workloads, plan, scfg)
    if plan.mesh is not None:
        from repro_torch.core import distribute as D

        D.check_mesh(plan.mesh, scfg, nc)
        dyn_batch = D.place_lanes(dyn_batch, plan.mesh)
        runner = D.make_dist_grid_runner(scfg, plan.mesh, plan.max_cycles,
                                         plan.exchange, plan.early_exit)
    else:
        runner = make_grid_runner(scfg, plan.mode, plan.max_cycles,
                                  plan.early_exit)

    stats = [[None] * nc for _ in range(nw)]
    bucket_states = []
    timings = {"n_lanes": nw * nc, "n_buckets": len(groups),
               "compile_s": None, "execute_s": 0.0}
    for idxs in groups:
        ws = [workloads[i] for i in idxs]
        stacked = (concat_workloads(ws, device) if plan.layout == "ragged"
                   else stack_workloads(ws, device))
        state0 = init_state(scfg, device, len(ws) * nc)
        if plan.mesh is not None:
            stacked = D.place_lanes(stacked, plan.mesh, ())
            state0 = D.place_state(
                _map(state0, lambda x: x.reshape(len(ws), nc, *x.shape[1:])),
                plan.mesh, None, D.CFG_AXIS)
        bstate, tm = timed_call(runner, state0, stacked, dyn_batch,
                                n_lanes=len(ws) * nc)
        bucket_states.append((list(idxs), bstate))
        host = _to_cpu(bstate)
        for pos, w in enumerate(idxs):
            for c in range(nc):
                stats[w][c] = S.finalize(take_grid_lane(host, pos, c))
        _add_timings(timings, tm)
    timings["lanes_per_s"] = round(
        nw * nc / max(timings["execute_s"], 1e-9), 2)
    single = bucket_states[0][1] if len(groups) == 1 else None
    return GridResult(scfg=scfg, state=single,
                      names=[w.name for w in workloads],
                      n_workloads=nw, n_cfgs=nc, stats=stats,
                      timings=timings, buckets=bucket_states)


# ---------------------------------------------------------------------------
# pair sweep: heterogeneous (workload, config) lanes
# ---------------------------------------------------------------------------

@dataclass
class PairResult:
    """Result of a ``pair_sweep``: per-lane finalized stats in submission
    order, whatever the bucketing, plus the per-bucket final states."""
    scfg: StaticConfig
    n: int
    stats: list = field(default_factory=list)    # per-lane finalized dicts
    timings: dict = field(default_factory=dict)
    # [(lane_indices, bucket_state), ...] — lane i's state sits at
    # position lane_indices.index(i) of its bucket (duplicate fill lanes
    # past len(lane_indices) are discarded)
    buckets: list = field(default_factory=list)

    def lane_state(self, i: int) -> dict:
        for idxs, bstate in self.buckets:
            if i in idxs:
                return take_lane(bstate, idxs.index(i))
        raise KeyError(f"lane index {i} in no bucket")


def _pad_fill(idxs: list, lane_quantum: int | None) -> list:
    """Round a bucket's lane list up to a multiple of ``lane_quantum`` by
    repeating its own lanes cyclically — padded slots carry live work (a
    duplicate of a real lane is bit-identical and independent) instead
    of inert NOPs."""
    if not lane_quantum or lane_quantum <= 1:
        return list(idxs)
    n = len(idxs)
    padded = ((n + lane_quantum - 1) // lane_quantum) * lane_quantum
    return [idxs[j % n] for j in range(padded)]


def pair_sweep(pairs, plan: RunPlan = None, lane_quantum: int | None = None,
               device=None) -> PairResult:
    """Run a heterogeneous batch of (workload, config) PAIR lanes — lane
    ``i`` simulates ``pairs[i] = (workload_i, cfg_i)`` — one lockstep run
    per bucket.  Every lane is bit-identical to a solo
    ``simulate(workload, cfg)`` of its pair whatever it was batched with.

    ``lane_quantum`` rounds each bucket's lane count up to a multiple by
    repeating live lanes (``_pad_fill``); duplicate results are dropped.
    All configs must share one StaticConfig; the mesh path is not wired
    for pair lanes (use grid_sweep for mesh runs)."""
    plan = resolve_plan(plan, where="pair_sweep")
    if plan.mesh is not None:
        raise ValueError("pair_sweep does not support mesh distribution; "
                         "use grid_sweep for mesh runs")
    if not pairs:
        raise ValueError("empty pair list")
    device = resolve_device(device)
    workloads = [w for w, _ in pairs]
    cfgs = plan.apply_telemetry([c for _, c in pairs])
    scfg, _ = stack_dyn(cfgs, device)   # validates the shared static shape
    for w in workloads:
        batch.check_workload_fits(scfg, w)
    groups = bucket_groups(workloads, plan, scfg)
    runner = make_pair_runner(scfg, plan.mode, plan.max_cycles,
                              plan.early_exit)

    n = len(pairs)
    stats = [None] * n
    bucket_states = []
    timings = {"n_lanes": n, "n_buckets": len(groups),
               "compile_s": None, "execute_s": 0.0}
    for idxs in groups:
        fill = _pad_fill(idxs, lane_quantum)
        ws = [workloads[i] for i in fill]
        stacked = (concat_workloads(ws, device) if plan.layout == "ragged"
                   else stack_workloads(ws, device))
        _, dyn_b = stack_dyn([cfgs[i] for i in fill], device)
        bstate, tm = timed_call(runner,
                                init_state(scfg, device, len(fill)),
                                stacked, dyn_b, n_lanes=len(idxs))
        bucket_states.append((list(idxs), bstate))
        host = _to_cpu(bstate)
        for pos, i in enumerate(idxs):      # duplicates past len(idxs) drop
            stats[i] = S.finalize(take_lane(host, pos))
        _add_timings(timings, tm)
    timings["lanes_per_s"] = round(n / max(timings["execute_s"], 1e-9), 2)
    return PairResult(scfg=scfg, n=n, stats=stats, timings=timings,
                      buckets=bucket_states)
