"""The fused SM quantum: the CUDA kernel's wrapper.

``sm_quantum`` runs Δ cycles of the SM phase for every lane and SM given,
exactly ``repro/sim/smcore.py:sm_quantum_single`` per SM, in one launch:
one thread block per (lane, SM), the SM's state in shared memory for the
whole quantum (see ``csrc/sm_quantum.cu``).  Lanes are independent
simulations (core/sweep.py), each with its own trace, dynamic config and
clock, or sharing one through a lane stride of 0.  Its plain version is
the port's eager cycle loop, ``repro_torch.sim.smcore.sm_quantum_eager``,
which the tests hold bit-exact against the JAX package;
``repro_torch.sim.smcore.sm_quantum`` sends CPU tensors there and CUDA
tensors here.

The wrapper takes CUDA tensors only: it launches the kernel (built from
``csrc/sm_quantum.cu`` at first use) or raises.  Inputs are never
modified: the kernel writes fresh output tensors.  ``sm_quantum.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
from functools import cache
from pathlib import Path

import torch

from repro_torch.kernels.build import build_library, once
from repro_torch.sim.config import N_CLASSES, N_UNITS, StaticConfig

SOURCE = Path(__file__).resolve().parent / "csrc" / "sm_quantum.cu"
STAT_KEYS = ("issued", "issued_mem", "l1_hit", "l1_miss", "cycles_issue",
             "stall", "warp_cycles")
# the state's leaves in the kernel's order (csrc/sm_quantum.cu:Leaf)
LEAVES = (
    ("warp", ("pc", "active", "ready_at", "pending", "wait_mem", "wait_bar",
              "cta", "wic")),
    ("sm", ("last_issued", "unit_free", "l1_tag", "l1_lru", "addrset",
            "addrset_over")),
    ("req", ("stage", "addr", "t", "warp", "is_store")),
    ("stats_sm", STAT_KEYS),
)
BOOL_LEAVES = frozenset({("warp", "active"), ("warp", "wait_mem"),
                         ("warp", "wait_bar"), ("req", "is_store")})
# shared memory a block may use on the H100 (232,448 bytes)
MAX_SHARED = 227 * 1024


@cache
def per_sm_shapes(cfg: StaticConfig) -> dict:
    """{(group, key): shape of one SM's slice} of every leaf."""
    w, sc, m = cfg.warps_per_sm, cfg.n_subcores, cfg.mshr_per_sm
    sm = {"last_issued": (sc,), "unit_free": (sc, N_UNITS),
          "l1_tag": (cfg.l1_sets, cfg.l1_ways),
          "l1_lru": (cfg.l1_sets, cfg.l1_ways),
          "addrset": (cfg.addrset_cap,), "addrset_over": ()}
    return {(g, k): {"warp": (w,), "sm": sm.get(k), "req": (m,),
                     "stats_sm": ()}[g]
            for g, keys in LEAVES for k in keys}


@cache
def leaf_counts(cfg: StaticConfig) -> tuple:
    """Elements of one SM's slice of every leaf, in the kernel's order."""
    return tuple(torch.Size(s).numel() for s in per_sm_shapes(cfg).values())


@cache
def shared_bytes(cfg: StaticConfig) -> int:
    """Shared memory of one block: every leaf of one SM as int32, and W
    words of scratch."""
    return 4 * (sum(leaf_counts(cfg)) + cfg.warps_per_sm)


def pack_state(warp, sm, req, stats_sm) -> list:
    """The four state dicts → their 26 leaves in the kernel's order."""
    groups = {"warp": warp, "sm": sm, "req": req, "stats_sm": stats_sm}
    for g, keys in LEAVES:
        if set(groups[g]) != set(keys):
            raise ValueError(f"sm_quantum: {g} has keys "
                             f"{sorted(groups[g])}, expected {sorted(keys)}")
    return [groups[g][k] for g, keys in LEAVES for k in keys]


def unpack_state(leaves) -> tuple:
    """The inverse of ``pack_state``: (warp, sm, req, stats_sm)."""
    it = iter(leaves)
    return tuple({k: next(it) for k in keys} for _, keys in LEAVES)


def _check(name, x, dtype, shape, device):
    if x.device != device or x.dtype != dtype or x.shape != shape \
            or not x.is_contiguous():
        _refuse(name, x, dtype, shape, device)


def _refuse(name, x, dtype, shape, device):
    name = ".".join(name) if isinstance(name, tuple) else name
    if x.device != device:
        raise ValueError(f"sm_quantum: {name} is on {x.device}, expected "
                         f"{device}")
    if x.dtype != dtype:
        raise TypeError(f"sm_quantum: {name} has dtype {x.dtype}, expected "
                        f"{dtype}")
    if x.shape != shape:
        raise ValueError(f"sm_quantum: {name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    raise ValueError(f"sm_quantum: {name} must be contiguous")


def _lane_stride(name, x, dtype, inner, n_lanes, device) -> int:
    """Check an aux argument of shape ``(n_lanes, *inner)``, its inner
    part contiguous; returns its stride along the lane axis in elements
    (0 where one value is shared by every lane)."""
    if x.device != device or x.dtype != dtype \
            or tuple(x.shape) != (n_lanes, *inner):
        _refuse(name, x, dtype, torch.Size((n_lanes, *inner)), device)
    if not x[:1].is_contiguous():
        raise ValueError(f"sm_quantum: {name} must be contiguous past its "
                         "lane axis")
    return x.stride(0) if n_lanes > 1 else 0


@once
def _launcher():
    lib, info = build_library(SOURCE, "sm_quantum")
    fn = lib.sm_quantum_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, info


def build() -> dict:
    """Build (or reuse) and load the kernel; returns the build record of
    ``repro_torch.kernels.build.build_library``."""
    return _launcher()[1]


_SCALAR, _TABLE = (), (N_CLASSES,)
_IS_BOOL = (ctypes.c_int * 26)(*(int((g, k) in BOOL_LEAVES)
                                  for g, keys in LEAVES for k in keys))


def sm_quantum(warp, sm, req, stats_sm, trace, t0, cfg: StaticConfig, dyn):
    """Δ cycles of every lane and SM given, in one launch of the CUDA
    kernel.  Returns fresh (warp, sm, req, stats_sm) dicts.

    State leaves ``(L, n_sm, …)``, contiguous.  ``trace``: a packed
    kernel trace per lane — instruction arrays ``(L, n)``, scalars
    ``(L,)``, ``instr_base`` optional (0 when absent); ``t0`` ``(L,)``
    int32; ``dyn``'s scalars ``(L,)`` and tables ``(L, N_CLASSES)``.  An
    argument's lane axis may have stride 0 (one value for every lane)."""
    device = warp["pc"].device
    if device.type != "cuda":
        raise ValueError(f"sm_quantum: no kernel for device {device}")
    if not 1 <= cfg.n_subcores <= 32:
        raise ValueError(f"sm_quantum: n_subcores={cfg.n_subcores} must be "
                         "in [1, 32] (one warp per sub-core)")
    if shared_bytes(cfg) > MAX_SHARED:
        raise ValueError(f"sm_quantum: one SM's state takes "
                         f"{shared_bytes(cfg)} bytes of shared memory, above "
                         f"the block's {MAX_SHARED}")
    leaves = pack_state(warp, sm, req, stats_sm)
    n_lanes, ns = leaves[0].shape[:2]
    i32, b = torch.int32, torch.bool
    for ((g, k), shape), x in zip(per_sm_shapes(cfg).items(), leaves):
        _check((g, k), x, b if (g, k) in BOOL_LEAVES else i32,
               torch.Size((n_lanes, ns, *shape)), device)
    length = (trace["ops"].shape[-1],)
    # the kernel's aux arguments, in its order
    aux = (("trace.ops", trace["ops"], i32, length),
           ("trace.dep", trace["dep"], b, length),
           ("trace.addr_mode", trace["addr_mode"], i32, length),
           ("trace.addr_param", trace["addr_param"], i32, length),
           ("trace.n_instr", trace["n_instr"], i32, _SCALAR),
           ("trace.warps_per_cta", trace["warps_per_cta"], i32, _SCALAR),
           ("trace.instr_base", trace.get("instr_base"), i32, _SCALAR),
           ("dyn.core.lat", dyn.core.lat, i32, _TABLE),
           ("dyn.core.disp", dyn.core.disp, i32, _TABLE),
           ("dyn.core.sched", dyn.core.sched, i32, _SCALAR),
           ("dyn.cache.l1_hit_lat", dyn.cache.l1_hit_lat, i32, _SCALAR),
           ("dyn.icnt.icnt_lat", dyn.icnt.icnt_lat, i32, _SCALAR),
           ("t0", t0, i32, _SCALAR))
    strides = [0 if x is None      # no instr_base: 0
               else _lane_stride(name, x, dtype, inner, n_lanes, device)
               for name, x, dtype, inner in aux]
    outs = [torch.empty_like(x) for x in leaves]
    if n_lanes * ns == 0:
        return unpack_state(outs)
    dims = (ctypes.c_int * 8)(
        cfg.warps_per_sm, cfg.n_subcores, cfg.l1_sets, cfg.l1_ways,
        cfg.addrset_cap, cfg.mshr_per_sm, cfg.mem_blocks, cfg.quantum)
    ptrs = [None if x is None else x.data_ptr() for _, x, _, _ in aux]
    fn, _ = _launcher()
    # the launcher sets its shared-memory attribute and launches on the
    # current device: make it the tensors' one
    with torch.cuda.device(device):
        err = fn((ctypes.c_void_p * 26)(*(x.data_ptr() for x in leaves)),
                 (ctypes.c_void_p * 26)(*(x.data_ptr() for x in outs)),
                 (ctypes.c_int * 26)(*leaf_counts(cfg)), _IS_BOOL,
                 (ctypes.c_void_p * len(ptrs))(*ptrs),
                 (ctypes.c_longlong * len(strides))(*strides), dims, n_lanes,
                 ns, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"sm_quantum: kernel launch failed with CUDA "
                           f"error {err}")
    sm_quantum.launches += 1
    return unpack_state(outs)


sm_quantum.launches = 0
