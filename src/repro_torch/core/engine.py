"""Deterministic simulation engine: the quantum loop (Algorithm 1, windowed).

Each machine quantum (Δ = 16 cycles):
  1. memory phase   (serial region)   — full request table
  2. CTA dispatch   (serial region)   — quantum boundary
  3. SM phase ×Δ    (parallel region) — per SM, local

The SM phase runner is injected (core/parallel.py), so one engine body
serves the sequential, vectorized and sharded modes, with bit-identical
results; the SM-sharded quantum loop plugs in as a ``kernel_runner``.

Lanes: every state leaf, trace leaf and ``DynConfig`` leaf carries a
leading lane axis of ``L`` independent simulations (core/sweep.py), and a
solo ``simulate`` is the one-lane case of the same code.  The reference
vmaps its ``lax.while_loop`` over lanes: every lane steps, and a lane
whose kernel has converged, or whose clock reached ``max_cycles``, is
frozen by select.  Here the lanes run in lockstep through Python loops
over kernels and quanta: each quantum steps every lane, keeps the new
state of the lanes still running, and reads back one flag (does any lane
still run?); the loop stops at the first quantum after which none does.
"""
from __future__ import annotations

import torch

from repro_torch.core import telemetry
from repro_torch.core.batch import (check_workload_fits, concat_kernels,
                                    split_ragged, stack_kernels)
from repro_torch.core.stats import take_lane
from repro_torch.device import resolve_device
from repro_torch.sim.config import (DynConfig, GPUConfig, StaticConfig,
                                    split_config)
from repro_torch.sim.cta import cta_issue
from repro_torch.sim.memsys import mem_phase
from repro_torch.sim.state import init_state, reset_for_kernel
from repro_torch.sim.trace import Workload


def converged(ctrl: dict, warp: dict, req: dict, trace: dict):
    """The kernel-completion predicate, per lane: all CTAs dispatched, no
    live warp (active with work left or loads pending), no in-flight
    request."""
    n_lanes = ctrl["cycle"].shape[0]
    live = warp["active"] & ~((warp["pc"] >= trace["n_instr"].reshape(
        n_lanes, 1, 1)) & (warp["pending"] == 0))
    return ((ctrl["next_cta"] >= trace["n_ctas"].reshape(n_lanes))
            & ~live.flatten(1).any(1)
            & ~(req["stage"] != 0).flatten(1).any(1))


def stamp_done(ctrl: dict, done, at) -> dict:
    """``ctrl`` with ``done_cycle`` set to ``at`` in every lane that is
    ``done`` and was not yet."""
    return dict(ctrl, done_cycle=torch.where(
        (ctrl["done_cycle"] < 0) & done, at, ctrl["done_cycle"]))


def mark_entry_converged(state: dict, trace: dict) -> dict:
    """Early exit: stamp ``done_cycle`` before the quantum loop in every
    lane whose kernel is already converged at entry, so that lane runs
    zero quanta.  After ``reset_for_kernel`` only an ``n_ctas == 0``
    padding kernel can be converged at entry, and the kernel loop masks
    those out."""
    ctrl = state["ctrl"]
    entry = converged(ctrl, state["warp"], state["req"], trace)
    return dict(state, ctrl=stamp_done(ctrl, entry, ctrl["cycle"]))


def quantum_step(state: dict, trace: dict, cfg: StaticConfig,
                 dyn: DynConfig, sm_runner):
    """One quantum of every lane."""
    t0 = state["ctrl"]["cycle"]
    req, mem, gstats = mem_phase(state["req"], state["mem"], state["stats"],
                                 t0, cfg, dyn,
                                 sm_ids=state["ctrl"]["sm_ids"])
    warp, ctrl, gstats = cta_issue(state["warp"], dict(state["ctrl"]),
                                   gstats, trace, cfg)
    warp, sm, req, stats_sm = sm_runner(warp, state["sm"], req,
                                        state["stats_sm"], trace, t0, dyn)
    cycle_end = t0 + cfg.quantum
    ctrl = dict(stamp_done(ctrl, converged(ctrl, warp, req, trace),
                           cycle_end), cycle=cycle_end)
    out = {"warp": warp, "sm": sm, "req": req, "mem": mem, "ctrl": ctrl,
           "stats_sm": stats_sm, "stats": gstats}
    # the counter timeline: nothing runs for it when telemetry is off
    if telemetry.enabled(cfg):
        out["telem"] = telemetry.quantum_update(state["telem"], out, trace,
                                                cfg)
    return out


def _select(pred, new, old):
    """``new`` where the lane predicate ``pred`` (L,) holds, else ``old``,
    leaf by leaf over nested dicts; ``pred`` is broadcast to each leaf's
    rank."""
    if isinstance(new, dict):
        return {k: _select(pred, v, old[k]) for k, v in new.items()}
    return torch.where(pred.reshape(-1, *(1,) * (new.dim() - 1)), new, old)


def run_kernel(state: dict, trace: dict, cfg: StaticConfig,
               dyn: DynConfig, sm_runner, max_cycles: int = 1 << 20,
               early_exit: bool = True):
    """Quanta until every lane's kernel converged or its clock reached
    ``max_cycles``; one host read per quantum.  A lane that stopped is
    frozen: it keeps its state, its timeline included, while the others
    step.  With telemetry on, every lane then takes the kernel's forced
    end sample (core/telemetry.py)."""
    if early_exit:
        state = mark_entry_converged(state, trace)
    n_lanes = state["ctrl"]["cycle"].shape[0]
    while True:
        ctrl = state["ctrl"]
        running = (ctrl["done_cycle"] < 0) & (ctrl["cycle"] < max_cycles)
        if not bool(running.any()):
            break
        new = quantum_step(state, trace, cfg, dyn, sm_runner)
        # one lane that runs needs no select
        state = new if n_lanes == 1 else _select(running, new, state)
    if telemetry.enabled(cfg):
        state = dict(state, telem=telemetry.sample(state["telem"], state,
                                                   cfg, force=True))
    return state


def kernel_cycles(ctrl: dict):
    """Cycles charged to the kernel that just ran, per lane: its
    done_cycle, or the current clock if it hit max_cycles."""
    return torch.where(ctrl["done_cycle"] >= 0, ctrl["done_cycle"],
                       ctrl["cycle"])


def _kernel_traces(stacked: dict) -> list:
    """The stacked kernels one at a time: per kernel, every lane's packed
    trace, ``(L, …)`` (ragged: the flat instruction streams with the
    kernel's scalars)."""
    if "instr_base" in stacked:
        per_kernel, flat = split_ragged(stacked)
    else:
        per_kernel, flat = stacked, {}
    return [dict(flat, **{f: v[:, k] for f, v in per_kernel.items()})
            for k in range(per_kernel["n_ctas"].shape[1])]


def run_groups_stacked(states: list, stackeds: list, cfg: StaticConfig,
                       dyns: list, kernel_runner, state_transform=None,
                       reset=reset_for_kernel, select=_select) -> list:
    """``run_workload_stacked`` for several independent lane groups at once,
    kernel by kernel: ``kernel_runner(states, packeds, dyns) -> states``
    runs one kernel of every group (core/distribute.py's 'cfg' groups,
    which it steps together).  Every group's workload has the same
    kernel count; ``cfg`` is the shape ``reset`` builds.  ``reset`` and
    ``select`` default to the whole state's; an 'sm' group's state brings
    its own (core/parallel.py:reset_group, select_group)."""
    kernels = [_kernel_traces(s) for s in stackeds]
    states = list(states)
    totals = [torch.zeros_like(st["ctrl"]["cycle"]) for st in states]
    timeouts = [torch.zeros_like(t) for t in totals]
    for k in range(len(kernels[0])):
        packed = [ks[k] for ks in kernels]
        sts = [reset(st, cfg) for st in states]
        if state_transform is not None:
            sts = [state_transform(st) for st in sts]
        sts = kernel_runner(sts, packed, dyns)
        for g, st in enumerate(sts):
            empty = packed[g]["n_ctas"] == 0
            totals[g] = totals[g] + torch.where(empty, 0,
                                                kernel_cycles(st["ctrl"]))
            timeouts[g] = timeouts[g] + (
                ~empty & (st["ctrl"]["done_cycle"] < 0)).int()
            states[g] = select(empty, states[g], st)
    return [dict(st, ctrl=dict(st["ctrl"], total_cycles=t, timeouts=o))
            for st, t, o in zip(states, totals, timeouts)]


def run_workload_stacked(state: dict, stacked: dict, cfg: StaticConfig,
                         dyn: DynConfig, sm_runner, max_cycles: int = 1 << 20,
                         early_exit: bool = True, state_transform=None,
                         kernel_runner=None) -> dict:
    """Run a whole workload in every lane: a loop over the stacked kernel
    axis, the lanes in lockstep.

    ``stacked``'s leaves lead with the lane axis, then the kernel axis:
    padded (core/batch.py:stack_kernels per lane), every leaf
    ``(L, n_kernels, …)``; or ragged (``instr_base`` present,
    core/batch.py:concat_kernels per lane), the per-kernel scalars
    ``(L, n_kernels)`` and the flat instruction streams ``(L, n)``, split
    by ``split_ragged`` and re-merged per kernel.  A lane axis may be a
    stride-0 view of one workload shared by every lane.

    Per kernel: state reset (sim/state.py:reset_for_kernel), then
    ``state_transform`` when given, run the kernel to completion,
    accumulate its cycles.  Padding kernels (``n_ctas == 0``) are masked
    out per lane — the carried state passes through unchanged and 0
    cycles are charged.  A kernel that hits ``max_cycles`` bumps the
    lane's ``timeouts`` counter.

    ``kernel_runner`` — ``(state, packed, dyn) -> state`` — replaces the
    default ``run_kernel`` quantum loop (a sharded one, say: see
    core/parallel.py:run_kernel_sharded); the reset, masking and timeout
    accounting stay shared by every execution mode."""
    if kernel_runner is None:
        def kernel_runner(st, packed, d):
            return run_kernel(st, packed, cfg, d, sm_runner, max_cycles,
                              early_exit)

    def one_group(sts, packeds, dyns):
        return [kernel_runner(sts[0], packeds[0], dyns[0])]

    [state] = run_groups_stacked([state], [stacked], cfg, [dyn], one_group,
                                 state_transform)
    return state


def run_workload(state: dict, kernels: list, cfg: StaticConfig,
                 dyn: DynConfig, sm_runner=None, max_cycles: int = 1 << 20,
                 state_transform=None, kernel_runner=None) -> dict:
    """Run packed kernels back to back in every lane of ``state``,
    accumulating total cycles.  ``kernels`` (``KernelTrace.pack``) and
    ``dyn`` (``split_config``) are one workload and one config, without a
    lane axis: every lane shares them through stride-0 views.  The kernel
    list is padded and stacked (core/batch.py) and handed to
    ``run_workload_stacked``, with its ``kernel_runner`` when given (say
    ``core/parallel.py:run_kernel_sharded``)."""
    n = state["ctrl"]["cycle"].shape[0]

    def lanes(tree: dict) -> dict:
        return {f: v.expand(n, *v.shape) for f, v in tree.items()}

    return run_workload_stacked(
        state, lanes(stack_kernels(kernels)), cfg,
        dyn.map(lambda x: x.expand(n, *x.shape)), sm_runner, max_cycles,
        state_transform=state_transform, kernel_runner=kernel_runner)


def simulate(workload: Workload, cfg: GPUConfig, sm_runner, *,
             max_cycles: int | None = None, early_exit: bool = True,
             device=None, plan=None) -> dict:
    """Run all kernels of a workload; returns the final state of its one
    lane (no lane axis).

    The one-lane case of ``run_workload_stacked``.  ``plan``
    (core/plan.py:RunPlan) may give max_cycles, early_exit and the trace
    layout instead of the keywords.  Runs on the CUDA device unless
    ``device`` names another one."""
    device = resolve_device(device)
    layout = "padded"
    if plan is not None:
        if max_cycles is not None:
            raise ValueError("simulate: pass either plan= or max_cycles=, "
                             "not both")
        max_cycles, early_exit, layout = (plan.max_cycles, plan.early_exit,
                                          plan.layout)
    if max_cycles is None:
        max_cycles = 1 << 20
    if max_cycles <= 0:
        raise ValueError(f"max_cycles must be positive, got {max_cycles}")
    scfg, dyn = split_config(cfg, device=device)
    check_workload_fits(scfg, workload)
    packs = [k.pack(device) for k in workload.kernels]
    trace = (concat_kernels(packs) if layout == "ragged"
             else stack_kernels(packs))
    state = run_workload_stacked(
        init_state(scfg, device, 1), {f: v[None] for f, v in trace.items()},
        scfg, dyn.map(lambda x: x[None]), sm_runner, max_cycles, early_exit)
    return take_lane(state, 0)
