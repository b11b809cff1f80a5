"""Kernel traces: the simulator's workload representation.

A kernel is a grid of CTAs; every warp executes the same instruction list
with per-warp addresses generated procedurally from (cta, warp, pc).
``KernelTrace`` keeps numpy arrays; ``pack()`` turns one into the dict of
int32/bool tensors the engine reads, on a given device.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

# address modes
A_NONE, A_STREAM, A_STRIDED, A_RANDOM = range(4)

_U32 = 0xFFFFFFFF


@dataclass(eq=False)
class KernelTrace:
    name: str
    n_ctas: int
    warps_per_cta: int
    ops: np.ndarray          # (L,) int32 instruction class
    dep: np.ndarray          # (L,) bool — depends on previous instruction
    addr_mode: np.ndarray    # (L,) int32
    addr_param: np.ndarray   # (L,) int32

    @property
    def n_instr(self) -> int:
        return len(self.ops)

    def __eq__(self, other) -> bool:
        """Full IR equality, array fields elementwise (the dataclass's
        default equality is ambiguous on arrays)."""
        if not isinstance(other, KernelTrace):
            return NotImplemented
        return (self.name == other.name
                and self.n_ctas == other.n_ctas
                and self.warps_per_cta == other.warps_per_cta
                and all(np.array_equal(getattr(self, f), getattr(other, f))
                        for f in ("ops", "dep", "addr_mode", "addr_param")))

    def pack(self, device) -> dict:
        def i32(x):
            return torch.as_tensor(np.asarray(x, np.int32), device=device)
        return {
            "ops": i32(self.ops),
            "dep": torch.as_tensor(np.asarray(self.dep, bool),
                                   device=device),
            "addr_mode": i32(self.addr_mode),
            "addr_param": i32(self.addr_param),
            "n_ctas": i32(self.n_ctas),
            "warps_per_cta": i32(self.warps_per_cta),
            "n_instr": i32(self.n_instr),
        }


@dataclass
class Workload:
    name: str
    kernels: list = field(default_factory=list)

    @property
    def total_ctas(self) -> int:
        return sum(k.n_ctas for k in self.kernels)

    def ctas_per_kernel(self) -> list[int]:
        return [k.n_ctas for k in self.kernels]


def build_kernel(name: str, *, n_ctas: int, warps_per_cta: int,
                 body: list[tuple], repeats: int = 1,
                 seed: int = 0) -> KernelTrace:
    """body: list of (op_class, dep, addr_mode, addr_param) tuples."""
    rows = [row for _ in range(repeats) for row in body]
    ops, dep, am, ap = (list(c) for c in zip(*rows)) if rows else ([],) * 4
    return KernelTrace(
        name=name, n_ctas=n_ctas, warps_per_cta=warps_per_cta,
        ops=np.asarray(ops, np.int32), dep=np.asarray(dep, bool),
        addr_mode=np.asarray(am, np.int32),
        addr_param=np.asarray(ap, np.int32))


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor reduced mod 2^32 into int32's range: what int32
    arithmetic that wraps on overflow would have given."""
    return (((x + (1 << 31)) & _U32) - (1 << 31)).to(torch.int32)


def gen_address(mode, param, gwarp, pc, mem_blocks: int):
    """Vectorized procedural address generator (block addresses).

    The reference computes in int32 (and uint32 for the random mode) with
    wraparound; here every product is formed exactly in int64 and reduced
    mod 2^32 once, which gives the same bits.  ``%`` is floor-mod."""
    param = param.long()
    gwarp = gwarp.long()
    pc = pc.long()
    stream = torch.remainder(
        wrap_i32(param * 4096 + gwarp * 8 + torch.remainder(pc, 8)),
        mem_blocks)
    strided = torch.remainder(
        wrap_i32(param * 4096 + gwarp * 257 + pc * 31), mem_blocks)
    h = (gwarp * 2654435761 + pc * 40503 + param * 97) & _U32
    random = torch.remainder(h, mem_blocks).to(torch.int32)
    addr = torch.where(mode == A_STREAM, stream,
                       torch.where(mode == A_STRIDED, strided, random))
    return addr.to(torch.int32)
