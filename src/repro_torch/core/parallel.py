"""Execution modes for the SM phase — the paper's `#pragma omp parallel for`.

  'seq'   — a Python loop over SMs, lane by lane: one SM of one lane at
            a time (single-thread reference)
  'vmap'  — every SM of every lane at once: on the card, one launch of
            the fused ``sm_quantum`` kernel per quantum

The state carries a leading lane axis ``(L, n_sm, …)`` (core/sweep.py);
a solo simulation is one lane.  SM-axis sharding over several devices
('shard') is slice 10 of the port, not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.sim.config import static_part
from repro_torch.sim.smcore import sm_quantum


def make_sm_runner(cfg, mode: str = "vmap"):
    """Returns sm_runner(warp, sm, req, stats_sm, trace, t0, dyn), every
    argument with a leading lane axis."""
    scfg = static_part(cfg)

    if mode == "vmap":
        def runner(warp, sm, req, stats_sm, trace, t0, dyn):
            return sm_quantum(warp, sm, req, stats_sm, trace, t0, scfg, dyn)
        return runner

    if mode == "seq":
        def runner(warp, sm, req, stats_sm, trace, t0, dyn):
            parts = (warp, sm, req, stats_sm)
            outs = []                   # outs[lane][sm] = (warp, sm, ...)
            for lane in range(t0.shape[0]):
                one = slice(lane, lane + 1)
                tr = {k: v[one] for k, v in trace.items()}
                dl = dyn.map(lambda x: x[one])
                outs.append([sm_quantum(*({k: v[one, i:i + 1]
                                           for k, v in p.items()}
                                          for p in parts), tr, t0[one],
                                        scfg, dl)
                             for i in range(scfg.n_sm)])
            return tuple({k: torch.cat([torch.cat([o[j][k] for o in lane], 1)
                                        for lane in outs])
                          for k in parts[j]} for j in range(len(parts)))
        return runner

    if mode == "shard":
        raise NotImplementedError(
            "mode='shard' (SM-axis sharding over devices) is slice 10 of "
            "the port, not ported to repro_torch yet; use mode='seq' or "
            "'vmap'")
    raise ValueError(f"unknown mode {mode!r} (expected seq/vmap/shard)")
