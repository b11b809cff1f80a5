"""Warp issue selection: the CUDA kernel's wrapper and its plain version.

``issue_select`` replaces ``repro/kernels/sm_issue/kernel.py:
issue_select_pallas``, widened to ``repro/sim/smcore.py:_issue_subcore``'s
full selection contract (``wait_bar`` blocking, the LRR selector, the
``instr_base`` fetch offset, a true kernel length ``n_instr``).  For each
SM and sub-core it returns two winners, ``sel_open`` (any op) and
``sel_closed`` (LDG/STG excluded); see ``csrc/sm_issue.cu``.

On CUDA tensors the wrapper launches the kernel (built from
``csrc/sm_issue.cu`` at first use) or raises; on CPU tensors it runs
``issue_select_plain``.  ``issue_select.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from functools import cache
from pathlib import Path

import torch

from repro_torch.kernels.build import build_library
from repro_torch.sim.config import (LDG, N_UNITS, SCHED_GTO, STG,
                                    UNIT_OF_CLASS)

SOURCE = Path(__file__).resolve().parent / "csrc" / "sm_issue.cu"
BIG = 1 << 30


@cache
def unit_table(device) -> torch.Tensor:
    """``UNIT_OF_CLASS`` as an int64 tensor on ``device``."""
    return torch.tensor(UNIT_OF_CLASS, dtype=torch.long, device=device)


def issue_select_plain(pc, active, ready_at, pending, wait_mem, wait_bar,
                       last_issued, unit_free, ops, n_instr, instr_base,
                       sched, t, *, n_subcores: int):
    """The plain PyTorch version of the kernel, vectorized over SMs and
    sub-cores.  Shapes: pc/active/ready_at/pending/wait_mem/wait_bar
    (n_sm, W); last_issued (n_sm, SC); unit_free (n_sm, SC, N_UNITS);
    ops (L,); n_instr/instr_base/sched/t scalars.  Returns
    (sel_open, sel_closed), each (n_sm, SC) int32 warp slots, -1 = none."""
    ns, w = pc.shape
    sc = n_subcores
    dev = pc.device
    n_instr, instr_base, sched, t = (
        torch.as_tensor(v, dtype=torch.int32, device=dev)
        for v in (n_instr, instr_base, sched, t))
    # warp slot w belongs to sub-core w % SC
    w_ids = torch.arange(w, dtype=torch.int32, device=dev)
    lane = torch.remainder(w_ids, sc)

    blocked = (wait_mem & (pending > 0)) | wait_bar
    ready = active & (pc < n_instr) & ~blocked & (ready_at <= t)
    op = ops[instr_base + torch.clamp(pc, min=0).minimum(n_instr - 1)]
    port = lane.long() * N_UNITS + unit_table(dev)[op]
    cand = ready & (unit_free.reshape(ns, -1).gather(1, port) <= t)

    last = last_issued[:, lane]
    key = torch.where(sched == SCHED_GTO,
                      torch.where(w_ids == last, -1, w_ids),
                      torch.remainder(w_ids - last - 1, w))
    keys = torch.stack([torch.where(cand, key, BIG),
                        torch.where(cand & (op != LDG) & (op != STG), key,
                                    BIG)])
    # least key per sub-core, ties to the first (lowest) warp slot
    best = keys.view(2, ns, w // sc, sc).min(2)
    sel = torch.where(best.values < BIG,
                      best.indices.int() * sc + lane[:sc], -1)
    return sel[0], sel[1]


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"sm_issue: {name} is on {x.device}, expected "
                         f"{device}")
    if x.dtype != dtype:
        raise TypeError(f"sm_issue: {name} has dtype {x.dtype}, expected "
                        f"{dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"sm_issue: {name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"sm_issue: {name} must be contiguous")


@cache
def _launcher():
    lib, info = build_library(SOURCE, "sm_issue")
    fn = lib.sm_issue_launch
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, info


def build() -> dict:
    """Build (or reuse) and load the kernel; returns the build record of
    ``repro_torch.kernels.build.build_library``."""
    return _launcher()[1]


def issue_select(pc, active, ready_at, pending, wait_mem, wait_bar,
                 last_issued, unit_free, ops, n_instr, instr_base, sched, t,
                 *, n_subcores: int):
    """Issue selection for every SM and sub-core: the CUDA kernel on CUDA
    tensors, ``issue_select_plain`` on CPU tensors.  Same arguments and
    results as ``issue_select_plain``; on CUDA the scalars are 0-d int32
    tensors (Python ints are copied to the device)."""
    args = (pc, active, ready_at, pending, wait_mem, wait_bar, last_issued,
            unit_free, ops, n_instr, instr_base, sched, t)
    device = pc.device
    if device.type == "cpu":
        return issue_select_plain(*args, n_subcores=n_subcores)
    if device.type != "cuda":
        raise ValueError(f"sm_issue: no kernel for device {device}")
    ns, w = pc.shape
    sc = n_subcores
    if not 1 <= sc <= 32 or w % sc:
        raise ValueError(f"sm_issue: n_subcores={sc} must be in [1, 32] "
                         f"and divide the warp count {w}")
    i32, b = torch.int32, torch.bool
    for name, x, dtype in (("pc", pc, i32), ("active", active, b),
                           ("ready_at", ready_at, i32),
                           ("pending", pending, i32),
                           ("wait_mem", wait_mem, b),
                           ("wait_bar", wait_bar, b)):
        _check(name, x, dtype, (ns, w), device)
    _check("last_issued", last_issued, i32, (ns, sc), device)
    _check("unit_free", unit_free, i32, (ns, sc, N_UNITS), device)
    _check("ops", ops, i32, (ops.shape[0],), device)
    scalars = [torch.as_tensor(v, dtype=i32, device=device)
               for v in (n_instr, instr_base, sched, t)]
    for name, x in zip(("n_instr", "instr_base", "sched", "t"), scalars):
        _check(name, x, i32, (), device)
    sel_open = torch.empty((ns, sc), dtype=i32, device=device)
    sel_closed = torch.empty((ns, sc), dtype=i32, device=device)
    fn, _ = _launcher()
    ptrs = [x.data_ptr() for x in (*args[:9], *scalars, sel_open,
                                   sel_closed)]
    err = fn(*ptrs, ns, w, sc, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"sm_issue: kernel launch failed with CUDA error "
                           f"{err}")
    issue_select.launches += 1
    return sel_open, sel_closed


issue_select.launches = 0
