"""Deterministic simulation engine: the quantum loop (Algorithm 1, windowed).

Each machine quantum (Δ = 16 cycles):
  1. memory phase   (serial region)   — full request table
  2. CTA dispatch   (serial region)   — quantum boundary
  3. SM phase ×Δ    (parallel region) — per SM, local

The SM phase runner is injected (core/parallel.py), so one engine body
serves the sequential and vectorized modes, with bit-identical results.

The reference's ``lax.while_loop`` over quanta and ``lax.scan`` over the
stacked kernel axis are Python loops here; the quantum loop reads back one
flag per quantum (has the kernel converged?) and stops at the first
quantum that converged.
"""
from __future__ import annotations

import torch

from repro_torch.core.batch import check_workload_fits, stack_kernels
from repro_torch.device import resolve_device
from repro_torch.sim.config import (DynConfig, GPUConfig, StaticConfig,
                                    split_config)
from repro_torch.sim.cta import cta_issue
from repro_torch.sim.memsys import mem_phase
from repro_torch.sim.state import init_state, reset_for_kernel
from repro_torch.sim.trace import Workload


def converged(ctrl: dict, warp: dict, req: dict, trace: dict):
    """The kernel-completion predicate: all CTAs dispatched, no live warp
    (active with work left or loads pending), no in-flight request."""
    live = warp["active"] & ~((warp["pc"] >= trace["n_instr"])
                              & (warp["pending"] == 0))
    return ((ctrl["next_cta"] >= trace["n_ctas"]) & ~live.any()
            & ~(req["stage"] != 0).any())


def mark_entry_converged(state: dict, trace: dict) -> dict:
    """Early exit: stamp ``done_cycle`` before the quantum loop when the
    kernel is already converged at entry, so the loop runs zero quanta.
    After ``reset_for_kernel`` only an ``n_ctas == 0`` padding kernel can
    be converged at entry, and the kernel loop masks those out."""
    ctrl = state["ctrl"]
    entry = converged(ctrl, state["warp"], state["req"], trace)
    dc = torch.where((ctrl["done_cycle"] < 0) & entry, ctrl["cycle"],
                     ctrl["done_cycle"])
    return dict(state, ctrl=dict(ctrl, done_cycle=dc))


def quantum_step(state: dict, trace: dict, cfg: StaticConfig,
                 dyn: DynConfig, sm_runner):
    t0 = state["ctrl"]["cycle"]
    req, mem, gstats = mem_phase(state["req"], state["mem"], state["stats"],
                                 t0, cfg, dyn,
                                 sm_ids=state["ctrl"]["sm_ids"])
    warp, ctrl, gstats = cta_issue(state["warp"], dict(state["ctrl"]),
                                   gstats, trace, cfg)
    warp, sm, req, stats_sm = sm_runner(warp, state["sm"], req,
                                        state["stats_sm"], trace, t0, dyn)
    cycle_end = t0 + cfg.quantum
    done = converged(ctrl, warp, req, trace)
    done_cycle = torch.where((ctrl["done_cycle"] < 0) & done, cycle_end,
                             ctrl["done_cycle"])
    ctrl = dict(ctrl, cycle=cycle_end, done_cycle=done_cycle)
    return {"warp": warp, "sm": sm, "req": req, "mem": mem, "ctrl": ctrl,
            "stats_sm": stats_sm, "stats": gstats}


def run_kernel(state: dict, trace: dict, cfg: StaticConfig,
               dyn: DynConfig, sm_runner, max_cycles: int = 1 << 20,
               early_exit: bool = True):
    """Quanta until the kernel converged or the clock reached
    ``max_cycles``; one host read per quantum."""
    if early_exit:
        state = mark_entry_converged(state, trace)
    while True:
        ctrl = state["ctrl"]
        if not bool((ctrl["done_cycle"] < 0) & (ctrl["cycle"] < max_cycles)):
            return state
        state = quantum_step(state, trace, cfg, dyn, sm_runner)


def kernel_cycles(ctrl: dict):
    """Cycles charged to the kernel that just ran: its done_cycle, or the
    current clock if it hit max_cycles."""
    return torch.where(ctrl["done_cycle"] >= 0, ctrl["done_cycle"],
                       ctrl["cycle"])


def _select(pred, old, new):
    """``old`` where ``pred``, else ``new``, leaf by leaf over nested
    dicts."""
    if isinstance(new, dict):
        return {k: _select(pred, old[k], v) for k, v in new.items()}
    return torch.where(pred, old, new)


def run_workload_stacked(state: dict, stacked: dict, cfg: StaticConfig,
                         dyn: DynConfig, sm_runner, max_cycles: int = 1 << 20,
                         early_exit: bool = True) -> dict:
    """Run a whole workload: a loop over the stacked kernel axis
    (core/batch.py:stack_kernels).

    Per kernel: state reset (sim/state.py:reset_for_kernel), run the
    kernel to completion, accumulate its cycles.  Padding kernels
    (``n_ctas == 0``) are masked out — the carried state passes through
    unchanged and 0 cycles are charged.  A kernel that hits ``max_cycles``
    bumps the ``timeouts`` counter."""
    dev = state["ctrl"]["cycle"].device
    total = torch.zeros((), dtype=torch.int32, device=dev)
    timeouts = torch.zeros((), dtype=torch.int32, device=dev)
    n_kernels = stacked["n_ctas"].shape[0]
    for k in range(n_kernels):
        packed = {f: v[k] for f, v in stacked.items()}
        st = reset_for_kernel(state, cfg)
        st = run_kernel(st, packed, cfg, dyn, sm_runner, max_cycles,
                        early_exit)
        empty = packed["n_ctas"] == 0
        total = total + torch.where(empty, 0, kernel_cycles(st["ctrl"]))
        timeouts = timeouts + (~empty & (st["ctrl"]["done_cycle"] < 0)).int()
        state = _select(empty, state, st)
    return dict(state, ctrl=dict(state["ctrl"], total_cycles=total,
                                 timeouts=timeouts))


def run_workload(state: dict, kernels: list, cfg: StaticConfig,
                 dyn: DynConfig, sm_runner, max_cycles: int = 1 << 20,
                 early_exit: bool = True) -> dict:
    """Run packed kernels back to back: padded, stacked and handed to
    ``run_workload_stacked``."""
    return run_workload_stacked(state, stack_kernels(kernels), cfg, dyn,
                                sm_runner, max_cycles, early_exit)


def simulate(workload: Workload, cfg: GPUConfig, sm_runner, *,
             max_cycles: int = 1 << 20, early_exit: bool = True,
             device=None) -> dict:
    """Run all kernels of a workload; returns the final state.

    Runs on the CUDA device unless ``device`` names another one."""
    device = resolve_device(device)
    if max_cycles <= 0:
        raise ValueError(f"max_cycles must be positive, got {max_cycles}")
    scfg, dyn = split_config(cfg, device=device)
    check_workload_fits(scfg, workload)
    stacked = stack_kernels([k.pack(device) for k in workload.kernels])
    return run_workload_stacked(init_state(scfg, device), stacked, scfg,
                                dyn, sm_runner, max_cycles, early_exit)
