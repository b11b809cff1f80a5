"""Per-workload instruction-mix features for the analytical fast path.

The port's copy of ``repro.sim.features`` (pure numpy).  The analytical
cost model (core/analytic.py) predicts a workload's cycle count from a
candidate ``DynConfig`` without running the engine.  Every model input
that depends only on the trace — per-class instruction counts,
dependency-chain structure, address-pattern mix, CTA/wave geometry — is
extracted here, once per (workload, StaticConfig), into a fixed-length
float64 vector:

  · ``issue[c]`` — per-(SM×subcore) issue volume of class ``c``: each
    sub-core issues one instruction per cycle and its port stays busy
    ``disp[c]`` cycles, so Σ issue[c]·disp[c] is the throughput bound.
  · ``chain[c]`` — wave-weighted count of instructions that depend on a
    previous instruction of class ``c`` (the latency-chain bound).
  · ``dep_load[m]`` — wave-weighted count of instructions depending on a
    previous LDG with address mode ``m`` (stream/strided/random).
  · ``mem_ch[m]`` — memory operations per DRAM channel by mode (the
    bandwidth bound).
  · ``waves`` — CTA waves summed over kernels; ``instr_sm`` — total
    issues per SM (scheduler-sensitivity scale).
"""
from __future__ import annotations

import numpy as np

from repro_torch.sim.config import (LDG, N_CLASSES, STG, StaticConfig,
                                    static_part)

# address-pattern buckets (sim/trace.py: A_STREAM/A_STRIDED/A_RANDOM);
# A_NONE loads fold into the stream bucket (best-case locality)
N_MODES = 3

# feature-vector layout
F_ISSUE = 0                       # [0, 7): per-class issue volume
F_CHAIN = F_ISSUE + N_CLASSES     # [7, 14): per-class dependency chain
F_DEP_LOAD = F_CHAIN + N_CLASSES  # [14, 17): dep-on-load by addr mode
F_MEM_CH = F_DEP_LOAD + N_MODES   # [17, 20): mem ops/channel by addr mode
F_WAVES = F_MEM_CH + N_MODES      # 20: total CTA waves
F_INSTR_SM = F_WAVES + 1          # 21: total issues per SM
N_FEATURES = F_INSTR_SM + 1

FEATURE_NAMES = tuple(
    [f"issue_{c}" for c in range(N_CLASSES)]
    + [f"chain_{c}" for c in range(N_CLASSES)]
    + ["dep_load_stream", "dep_load_strided", "dep_load_random",
       "mem_ch_stream", "mem_ch_strided", "mem_ch_random",
       "waves", "instr_sm"])


def kernel_geometry(kernel, scfg: StaticConfig) -> tuple:
    """(total_warps, waves) of one kernel on this machine shape: CTAs
    resident per SM are bounded by both the CTA slot limit and the warp
    slots, and the grid drains in ⌈n_ctas / (resident · n_sm)⌉ waves."""
    resident = min(scfg.max_cta_per_sm,
                   max(scfg.warps_per_sm // max(kernel.warps_per_cta, 1), 1))
    waves = -(-kernel.n_ctas // max(resident * scfg.n_sm, 1))
    return kernel.n_ctas * kernel.warps_per_cta, waves


def kernel_features(kernel, scfg: StaticConfig) -> np.ndarray:
    """One kernel's (N_FEATURES,) contribution (float64)."""
    f = np.zeros(N_FEATURES, np.float64)
    total_warps, waves = kernel_geometry(kernel, scfg)
    ops = np.asarray(kernel.ops, np.int64)
    dep = np.asarray(kernel.dep, bool)
    mode = np.asarray(kernel.addr_mode, np.int64)
    ports = float(scfg.n_sm * scfg.n_subcores)

    cnt = np.bincount(ops, minlength=N_CLASSES)[:N_CLASSES]
    f[F_ISSUE:F_ISSUE + N_CLASSES] = cnt * (total_warps / ports)

    # chain[c]: instructions whose PREDECESSOR is class c and that carry a
    # dep flag — the stall charges the predecessor's result latency
    if len(ops) > 1:
        pred_of_dep = ops[:-1][dep[1:]]
        f[F_CHAIN:F_CHAIN + N_CLASSES] = (
            np.bincount(pred_of_dep, minlength=N_CLASSES)[:N_CLASSES]
            * float(waves))
        dep_ld = pred_of_dep == LDG
        ld_modes = np.clip(mode[:-1][dep[1:]][dep_ld] - 1, 0, N_MODES - 1)
        f[F_DEP_LOAD:F_DEP_LOAD + N_MODES] = (
            np.bincount(ld_modes, minlength=N_MODES)[:N_MODES]
            * float(waves))

    is_mem = (ops == LDG) | (ops == STG)
    mem_modes = np.clip(mode[is_mem] - 1, 0, N_MODES - 1)
    f[F_MEM_CH:F_MEM_CH + N_MODES] = (
        np.bincount(mem_modes, minlength=N_MODES)[:N_MODES]
        * (total_warps / float(max(scfg.dram_channels, 1))))

    f[F_WAVES] = float(waves)
    f[F_INSTR_SM] = len(ops) * total_warps / float(max(scfg.n_sm, 1))
    return f


def workload_features(workload, scfg) -> np.ndarray:
    """Sum of the workload's kernel feature vectors — kernels run
    back-to-back, so their cost contributions add."""
    scfg = static_part(scfg)
    f = np.zeros(N_FEATURES, np.float64)
    for k in workload.kernels:
        f += kernel_features(k, scfg)
    return f
