"""Workload zoo: a registry of named synthetic workloads.

The same eight generators as ``repro.sim.workloads``, built on the
``build_kernel`` body DSL, with deliberately distinct cache, DRAM and
compute signatures:

  gemm_tiled        tensor-core GEMM k-loop: strided A/B tiles, MMA pairs
  stencil           5-point streaming stencil sweeps, barrier per step
  streaming_copy    pure LDG→STG stream, DRAM-bandwidth bound
  strided_transpose large-stride load/store, cache-hostile
  random_gather     dependent random-address loads, latency bound
  reduction_tree    8-way reduction: kernel chain, CTA count ÷8 per level
  tensor_heavy      MMA-dominated, near-zero memory traffic
  mixed             multi-kernel pipeline mixing the above phases

``zoo_names()`` lists them and ``zoo_workload(name, scale=…)`` builds one.
Real-trace workloads (``trace:<name>``) need trace ingestion, which is not
ported yet: such names raise ``NotImplementedError``.
"""
from __future__ import annotations

from repro_torch.sim.config import BAR, FP32, INT32, LDG, SFU, STG, TENSOR
from repro_torch.sim.trace import (A_RANDOM, A_STREAM, A_STRIDED, Workload,
                                   build_kernel)

ZOO: dict = {}


def register(name: str):
    def deco(fn):
        ZOO[name] = fn
        return fn
    return deco


def zoo_names() -> list:
    return sorted(ZOO)


def zoo_workload(name: str, scale: float = 1.0) -> Workload:
    """Build a zoo workload by registry name."""
    if name.startswith("trace:"):
        raise NotImplementedError(
            f"zoo workload {name!r}: trace ingestion (trace:<name>) is not "
            "ported to repro_torch yet")
    if name not in ZOO:
        raise KeyError(f"unknown zoo workload {name!r}; "
                       f"available: {', '.join(zoo_names())}")
    return ZOO[name](scale)


def resolve_workload(name: str, scale: float = 1.0) -> Workload:
    """One resolver for the ported workload namespaces: ``zoo:<x>`` and
    bare zoo names, then the Table-2 synthetic generators."""
    if name.startswith("zoo:"):
        return zoo_workload(name[len("zoo:"):], scale)
    if name.startswith("trace:") or name in ZOO:
        return zoo_workload(name, scale)
    from repro_torch.workloads.synthetic import make_workload
    return make_workload(name, scale=scale)


def _s(n, scale):  # scaled CTA count, at least 1
    return max(1, int(round(n * scale)))


@register("gemm_tiled")
def _gemm_tiled(scale: float) -> Workload:
    """Tiled GEMM: per k-step two strided tile loads feed two MMA ops;
    streamed epilogue store.  Strided reuse across warps → L2 hits."""
    body = []
    for k in range(6):
        body.append((LDG, False, A_STRIDED, k))          # A tile
        body.append((LDG, False, A_STRIDED, 64 + k))     # B tile
        body.append((TENSOR, True, 0, 0))
        body.append((TENSOR, True, 0, 0))
    body.append((STG, False, A_STREAM, 128))
    return Workload("gemm_tiled", [build_kernel(
        "gemm", n_ctas=_s(768, scale), warps_per_cta=4, body=body,
        repeats=2)])


@register("stencil")
def _stencil(scale: float) -> Workload:
    """5-point stencil, 3 time steps: neighbour streams (5 offsets), FP32
    update chain, barrier, streamed store.  Streaming + high L1 locality."""
    w = Workload("stencil")
    for step in range(3):
        body = [(LDG, False, A_STREAM, 8 * step + off) for off in range(5)]
        body += [(FP32, i == 0, 0, 0) for i in range(6)]
        body.append((BAR, False, 0, 0))
        body.append((STG, False, A_STREAM, 8 * step + 6))
        w.kernels.append(build_kernel(
            f"step{step}", n_ctas=_s(640, scale), warps_per_cta=4,
            body=body, repeats=2))
    return w


@register("streaming_copy")
def _streaming_copy(scale: float) -> Workload:
    """memcpy: back-to-back independent stream loads + stores, almost no
    compute — pure DRAM bandwidth, near-perfect row locality."""
    body = []
    for i in range(4):
        body.append((LDG, False, A_STREAM, i))
        body.append((STG, False, A_STREAM, 32 + i))
    return Workload("streaming_copy", [build_kernel(
        "copy", n_ctas=_s(1280, scale), warps_per_cta=4, body=body,
        repeats=3)])


@register("strided_transpose")
def _strided_transpose(scale: float) -> Workload:
    """Transpose-like: streamed loads written back at a large stride —
    cache-hostile stores, DRAM row churn, light INT addressing."""
    body = []
    for i in range(4):
        body.append((LDG, False, A_STREAM, i))
        body.append((INT32, True, 0, 0))
        body.append((STG, False, A_STRIDED, 32 + i))
    return Workload("strided_transpose", [build_kernel(
        "transpose", n_ctas=_s(640, scale), warps_per_cta=4, body=body,
        repeats=2)])


@register("random_gather")
def _random_gather(scale: float) -> Workload:
    """Pointer-chase analogue: dependent random-address loads with integer
    index math between them — MSHR/latency bound, ~0 row locality."""
    body = []
    for i in range(5):
        body.append((LDG, i > 0, A_RANDOM, i))
        body.append((INT32, True, 0, 0))
    body.append((STG, False, A_RANDOM, 9))
    return Workload("random_gather", [build_kernel(
        "gather", n_ctas=_s(512, scale), warps_per_cta=4, body=body,
        repeats=2)])


@register("reduction_tree")
def _reduction_tree(scale: float) -> Workload:
    """8-way reduction tree: each level's CTA count is an eighth of the
    previous (512 → 64 → 8 → 1) — multi-kernel tail-latency shape (late
    kernels starve most SMs)."""
    w = Workload("reduction_tree")
    n = 512
    level = 0
    while n >= 1:
        body = [(LDG, False, A_STREAM, 4 * level),
                (LDG, False, A_STREAM, 4 * level + 1),
                (FP32, True, 0, 0), (FP32, True, 0, 0),
                (BAR, False, 0, 0),
                (STG, False, A_STREAM, 4 * level + 2)]
        w.kernels.append(build_kernel(
            f"level{level}", n_ctas=_s(n, scale) if n > 1 else 1,
            warps_per_cta=2, body=body))
        n //= 8
        level += 1
        if n == 0:
            break
    return w


@register("tensor_heavy")
def _tensor_heavy(scale: float) -> Workload:
    """MMA-dominated: one operand fetch then long dependent MMA chains
    with an SFU epilogue — compute bound, unit-port limited."""
    body = [(LDG, False, A_STRIDED, 0), (LDG, False, A_STRIDED, 64)]
    body += [(TENSOR, True, 0, 0)] * 10
    body.append((SFU, True, 0, 0))
    body.append((STG, False, A_STREAM, 128))
    return Workload("tensor_heavy", [build_kernel(
        "mma", n_ctas=_s(512, scale), warps_per_cta=4, body=body,
        repeats=3)])


@register("mixed")
def _mixed(scale: float) -> Workload:
    """Multi-kernel pipeline: copy-in → GEMM tile → random gather → small
    reduce.  Kernels differ in length, width and CTA count — the padding
    stress case for the batched frontend."""
    w = Workload("mixed")
    w.kernels.append(build_kernel(
        "copy_in", n_ctas=_s(768, scale), warps_per_cta=4,
        body=[(LDG, False, A_STREAM, 0), (STG, False, A_STREAM, 16)],
        repeats=2))
    gemm = []
    for k in range(4):
        gemm += [(LDG, False, A_STRIDED, k), (LDG, False, A_STRIDED, 64 + k),
                 (TENSOR, True, 0, 0), (TENSOR, True, 0, 0)]
    gemm.append((STG, False, A_STREAM, 128))
    w.kernels.append(build_kernel(
        "gemm", n_ctas=_s(384, scale), warps_per_cta=4, body=gemm))
    w.kernels.append(build_kernel(
        "gather", n_ctas=_s(256, scale), warps_per_cta=2,
        body=[(LDG, False, A_RANDOM, 3), (INT32, True, 0, 0),
              (LDG, True, A_RANDOM, 5), (INT32, True, 0, 0)], repeats=2))
    w.kernels.append(build_kernel(
        "reduce", n_ctas=_s(32, scale), warps_per_cta=2,
        body=[(LDG, False, A_STREAM, 7), (FP32, True, 0, 0),
              (BAR, False, 0, 0), (STG, False, A_STREAM, 9)]))
    return w
