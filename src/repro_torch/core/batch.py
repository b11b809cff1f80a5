"""Trace batching: pad and stack kernel traces (the padded layout).

The engine reads a packed kernel trace through two scalars — ``n_instr``
(instruction fetch is clipped to ``pc < n_instr``) and ``n_ctas``
(dispatch stops at ``next_cta >= n_ctas``) — so a trace can be padded
without changing a single simulated event:

  · **NOP slots**: instruction arrays grow to a shared ``n_instr_max``;
    the pad region is never fetched.
  · **Empty kernels**: ``n_ctas=0`` kernels, which the engine's kernel
    loop masks out entirely (state passes through, 0 cycles charged).

The ragged layout and bucketing of the reference are not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# per-instruction (length-L) fields of a packed kernel trace
INSTR_FIELDS = ("ops", "dep", "addr_mode", "addr_param")


def check_workload_fits(scfg, workload) -> None:
    """A kernel whose CTA needs more warp slots than an SM has can never
    dispatch and would spin until ``max_cycles``: raise by name."""
    wps = scfg.warps_per_sm
    for k in workload.kernels:
        if k.warps_per_cta > wps:
            raise ValueError(
                f"kernel {k.name!r} of workload {workload.name!r} has "
                f"warps_per_cta={k.warps_per_cta} > warps_per_sm={wps}: "
                "it could never dispatch and would spin to max_cycles.  "
                "Use a larger config, or split oversized CTAs")


def pad_packed(packed: dict, n_instr_max: int) -> dict:
    """Pad a packed kernel's instruction arrays to ``n_instr_max`` with
    inert NOP slots; ``n_instr`` keeps the TRUE length."""
    length = int(packed["ops"].shape[0])
    if length > n_instr_max:
        raise ValueError(
            f"kernel has {length} instructions > n_instr_max={n_instr_max}")
    out = dict(packed)
    for f in INSTR_FIELDS:
        out[f] = F.pad(packed[f], (0, n_instr_max - length))
    return out


def empty_packed(n_instr_max: int, device) -> dict:
    """An ``n_ctas=0`` kernel: dispatches nothing, runs nothing."""
    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)
    return {
        "ops": zeros(n_instr_max),
        "dep": zeros(n_instr_max, dtype=torch.bool),
        "addr_mode": zeros(n_instr_max),
        "addr_param": zeros(n_instr_max),
        "n_ctas": zeros(),
        "warps_per_cta": torch.ones((), dtype=torch.int32,
                                    device=device),  # a divisor: never 0
        "n_instr": zeros(),
    }


def stack_kernels(kernels: list, n_instr: int | None = None,
                  n_kernels: int | None = None) -> dict:
    """Pad packed kernels to shared (n_kernels, n_instr) and stack them
    into a leading kernel axis."""
    if not kernels:
        raise ValueError("empty kernel list")
    lengths = [int(k["ops"].shape[0]) for k in kernels]
    if n_instr is None:
        n_instr = max(lengths)
    if n_kernels is None:
        n_kernels = len(kernels)
    if len(kernels) > n_kernels:
        raise ValueError(
            f"{len(kernels)} kernels > n_kernels={n_kernels}")
    padded = [pad_packed(k, n_instr) for k in kernels]
    padded += [empty_packed(n_instr, kernels[0]["ops"].device)] * (
        n_kernels - len(kernels))
    return {f: torch.stack([p[f] for p in padded]) for f in padded[0]}
