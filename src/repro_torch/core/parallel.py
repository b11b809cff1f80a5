"""Execution modes for the SM phase — the paper's `#pragma omp parallel for`.

  'seq'   — a Python loop over SMs: one SM at a time (single-thread
            reference)
  'vmap'  — every SM at once along the leading SM axis

SM-axis sharding over several devices ('shard') is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.sim.config import static_part
from repro_torch.sim.smcore import sm_quantum


def make_sm_runner(cfg, mode: str = "vmap"):
    """Returns sm_runner(warp, sm, req, stats_sm, trace, t0, dyn)."""
    scfg = static_part(cfg)

    if mode == "vmap":
        def runner(warp, sm, req, stats_sm, trace, t0, dyn):
            return sm_quantum(warp, sm, req, stats_sm, trace, t0, scfg, dyn)
        return runner

    if mode == "seq":
        def runner(warp, sm, req, stats_sm, trace, t0, dyn):
            parts = (warp, sm, req, stats_sm)
            outs = [sm_quantum(*({k: v[i:i + 1] for k, v in p.items()}
                                 for p in parts), trace, t0, scfg, dyn)
                    for i in range(scfg.n_sm)]
            return tuple({k: torch.cat([o[j][k] for o in outs])
                          for k in parts[j]} for j in range(len(parts)))
        return runner

    if mode == "shard":
        raise NotImplementedError(
            "mode='shard' (SM-axis sharding over devices) is not ported to "
            "repro_torch yet; use mode='seq' or 'vmap'")
    raise ValueError(f"unknown mode {mode!r} (expected seq/vmap/shard)")
