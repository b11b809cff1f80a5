"""Simulator state: a struct of arrays, as dicts of tensors.

Same keys, shapes and dtypes (int32, bool) as ``repro.sim.state``:

  · arrays with a leading ``n_sm`` axis are touched ONLY by the SM phase;
  · ``mem`` / ``ctrl`` and the global stats are touched ONLY by the
    memory and CTA phases (the serial region);
  · per-SM statistics are isolated per SM and reduced once at the end of
    the run (core/stats.py).
"""
from __future__ import annotations

import torch

from repro_torch.sim.config import N_UNITS, StaticConfig


def init_state(cfg: StaticConfig, device) -> dict:
    ns, w, m = cfg.n_sm, cfg.warps_per_sm, cfg.mshr_per_sm
    sc = cfg.n_subcores
    i32, b = torch.int32, torch.bool

    def zeros(*shape, dtype=i32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def full(shape, v):
        return torch.full(shape, v, dtype=i32, device=device)

    return {
        "warp": {
            "pc": zeros(ns, w),
            "active": zeros(ns, w, dtype=b),
            "ready_at": zeros(ns, w),
            "pending": zeros(ns, w),
            "wait_mem": zeros(ns, w, dtype=b),
            "wait_bar": zeros(ns, w, dtype=b),   # at a CTA barrier
            "cta": full((ns, w), -1),
            "wic": zeros(ns, w),                 # warp index within CTA
        },
        "sm": {
            "last_issued": full((ns, sc), -1),
            "unit_free": zeros(ns, sc, N_UNITS),
            "l1_tag": full((ns, cfg.l1_sets, cfg.l1_ways), -1),
            "l1_lru": zeros(ns, cfg.l1_sets, cfg.l1_ways),
            "addrset": full((ns, cfg.addrset_cap), -1),
            "addrset_over": zeros(ns),
        },
        "req": {
            "stage": zeros(ns, m),   # 0 free, 1 →L2, 2 →DRAM, 3 done
            "addr": zeros(ns, m),
            "t": zeros(ns, m),
            "warp": zeros(ns, m),
            "is_store": zeros(ns, m, dtype=b),
        },
        "mem": {
            "l2_tag": full((cfg.l2_slices, cfg.l2_sets, cfg.l2_ways), -1),
            "l2_lru": zeros(cfg.l2_slices, cfg.l2_sets, cfg.l2_ways),
            "l2_busy": zeros(cfg.l2_slices),
            "dram_busy": zeros(cfg.dram_channels),
            "dram_row": full((cfg.dram_channels,), -1),
        },
        "ctrl": {
            "cycle": zeros(),
            "next_cta": zeros(),
            "rr": zeros(),
            "done_cycle": full((), -1),
            # original SM id at each array position
            "sm_ids": torch.arange(ns, dtype=i32, device=device),
        },
        # per-SM stats (parallel region; reduced at the epilogue)
        "stats_sm": {k: zeros(ns) for k in (
            "issued", "issued_mem", "l1_hit", "l1_miss",
            "cycles_issue",    # cycles with ≥1 issue
            "stall",           # active but no issue
            "warp_cycles")},
        # global stats (serial region)
        "stats": {k: zeros() for k in (
            "l2_hit", "l2_miss", "dram_req", "dram_row_hit",
            "ctas_launched")},
    }


def reset_for_kernel(state: dict, cfg: StaticConfig) -> dict:
    """Between kernels: clear warps and requests, flush L1 (Accel-sim
    semantics), keep L2/DRAM state and accumulated stats."""
    s = init_state(cfg, state["ctrl"]["cycle"].device)
    return {
        "warp": s["warp"],
        "sm": dict(state["sm"],
                   l1_tag=s["sm"]["l1_tag"], l1_lru=s["sm"]["l1_lru"],
                   last_issued=s["sm"]["last_issued"],
                   unit_free=torch.zeros_like(state["sm"]["unit_free"])),
        "req": s["req"],
        "mem": dict(state["mem"]),
        "ctrl": dict(state["ctrl"], next_cta=s["ctrl"]["next_cta"],
                     done_cycle=s["ctrl"]["done_cycle"]),
        "stats_sm": dict(state["stats_sm"]),
        "stats": dict(state["stats"]),
    }
