"""Table-2 benchmark analogues.

Accel-sim replays SASS traces of the real binaries; those traces are not
shippable here, so each suite entry is a *synthetic trace generator* tuned
to the structural properties the paper reports or that follow from the
app's algorithm: CTAs/kernel (Fig. 7 — myocyte=2, lavaMD ≫ 80, cut_1 small),
kernel counts, instruction mix, dependence density and address pattern
(streaming stencils vs. irregular graph traversal vs. tensor-core GEMM
tiles).  ``scale`` shrinks CTA counts/trace lengths uniformly so the full
suite simulates in minutes on one CPU core; relative behaviour (Fig. 5/6/7
shapes) is preserved.
"""
from __future__ import annotations

from repro_torch.sim.config import BAR, FP32, INT32, LDG, SFU, STG, TENSOR
from repro_torch.sim.trace import (A_RANDOM, A_STREAM, A_STRIDED, Workload,
                                   build_kernel)


def _body_compute(n_fp=8, n_sfu=0, dep_every=3, param=0):
    body = []
    for i in range(n_fp):
        body.append((FP32, i % dep_every == 0, 0, 0))
    for i in range(n_sfu):
        body.append((SFU, True, 0, 0))
    return body


def _body_stream(n_ld=4, n_fp=6, param=0, store=True):
    body = [(LDG, False, A_STREAM, param + i) for i in range(n_ld)]
    body += [(FP32, i == 0, 0, 0) for i in range(n_fp)]
    if store:
        body.append((STG, False, A_STREAM, param + 7))
    return body


def _body_irregular(n_ld=4, n_int=6, param=0):
    body = []
    for i in range(n_ld):
        body.append((LDG, i > 0, A_RANDOM, param + i))
        body.append((INT32, True, 0, 0))
    body += [(INT32, False, 0, 0)] * n_int
    return body


def _body_gemm_tile(k_steps=4, param=0):
    body = []
    for i in range(k_steps):
        body.append((LDG, False, A_STRIDED, param + i))
        body.append((LDG, False, A_STRIDED, param + 64 + i))
        body.append((TENSOR, True, 0, 0))
        body.append((TENSOR, True, 0, 0))
    body.append((STG, False, A_STREAM, param))
    return body


def _s(n, scale):  # scaled CTA count, at least 1
    return max(1, int(round(n * scale)))


def make_workload(name: str, scale: float = 1.0) -> Workload:  # noqa: C901
    w = Workload(name)
    add = w.kernels.append
    if name == "gaussian":
        for i in range(24):
            n = _s(max(4, 256 - 10 * i), scale)
            add(build_kernel(f"fan{i}", n_ctas=n, warps_per_cta=2,
                             body=_body_stream(2, 4, param=i), repeats=2))
    elif name == "hotspot":
        for it in range(4):
            add(build_kernel(f"step{it}", n_ctas=_s(1024, scale),
                             warps_per_cta=4,
                             body=_body_stream(5, 12, param=it), repeats=2))
    elif name == "hybridsort":
        add(build_kernel("hist", n_ctas=_s(256, scale), warps_per_cta=4,
                         body=_body_irregular(3, 4), repeats=3))
        for i in range(4):
            add(build_kernel(f"bucket{i}", n_ctas=_s(128, scale),
                             warps_per_cta=4,
                             body=_body_irregular(4, 6, param=i), repeats=2))
    elif name == "lavaMD":
        add(build_kernel("kcal", n_ctas=_s(4096, scale), warps_per_cta=4,
                         body=_body_compute(24, 8) + _body_stream(2, 8),
                         repeats=4))
    elif name == "lud":
        for i in range(16):
            n = _s(max(2, 128 - 8 * i), scale)
            add(build_kernel(f"diag{i}", n_ctas=n, warps_per_cta=2,
                             body=_body_stream(3, 8, param=i), repeats=2))
    elif name == "myocyte":
        # the paper's pathological case: 2 CTAs per kernel
        add(build_kernel("solver", n_ctas=2, warps_per_cta=4,
                         body=_body_compute(16, 8, dep_every=2)
                         + _body_stream(2, 8), repeats=24))
    elif name == "nn":
        add(build_kernel("dist", n_ctas=_s(168, scale), warps_per_cta=4,
                         body=_body_stream(3, 4), repeats=2))
    elif name == "nw":
        for i in range(12):
            n = _s(min(i + 1, 12 - i) * 16, scale)
            add(build_kernel(f"wave{i}", n_ctas=max(n, 1), warps_per_cta=2,
                             body=_body_stream(3, 6, param=i)))
    elif name == "pathfinder":
        for it in range(3):
            add(build_kernel(f"row{it}", n_ctas=_s(463, scale),
                             warps_per_cta=4,
                             body=_body_stream(3, 6, param=it), repeats=2))
    elif name == "srad":
        for it in range(3):
            add(build_kernel(f"srad1_{it}", n_ctas=_s(512, scale),
                             warps_per_cta=4,
                             body=_body_stream(4, 10, param=it) +
                             [(SFU, True, 0, 0)], repeats=2))
    elif name == "fdtd2d":
        for it in range(3):
            for f in range(3):
                add(build_kernel(f"f{f}_{it}", n_ctas=_s(708, scale),
                                 warps_per_cta=4,
                                 body=_body_stream(4, 8, param=f)))
    elif name == "syrk":
        add(build_kernel("syrk", n_ctas=_s(512, scale), warps_per_cta=4,
                         body=_body_gemm_tile(6), repeats=2))
    elif name == "mst":
        for it in range(12):
            add(build_kernel(f"find{it}", n_ctas=_s(192, scale),
                             warps_per_cta=4,
                             body=_body_irregular(5, 8, param=it),
                             repeats=2))
    elif name == "sssp":
        sizes = [8, 32, 128, 384, 512, 384, 160, 64, 24, 8]
        for it, n in enumerate(sizes):
            add(build_kernel(f"relax{it}", n_ctas=_s(n, scale),
                             warps_per_cta=4,
                             body=_body_irregular(5, 6, param=it),
                             repeats=2))
    elif name == "conv":
        add(build_kernel("im2col", n_ctas=_s(1568, scale), warps_per_cta=4,
                         body=_body_stream(4, 4)))
        add(build_kernel("gemm", n_ctas=_s(1024, scale), warps_per_cta=4,
                         body=_body_gemm_tile(6), repeats=2))
    elif name == "gemm":
        add(build_kernel("gemm", n_ctas=_s(1600, scale), warps_per_cta=4,
                         body=_body_gemm_tile(8), repeats=2))
    elif name == "rnn":
        for t in range(16):
            add(build_kernel(f"cell{t}", n_ctas=_s(64, scale),
                             warps_per_cta=4,
                             body=_body_gemm_tile(4, param=t)))
    elif name == "cut_1":
        # 2560×16×2560 tiles → few CTAs (paper: dynamic scheduler wins)
        add(build_kernel("cutlass", n_ctas=_s(20, max(scale, 1.0)),
                         warps_per_cta=8, body=_body_gemm_tile(20),
                         repeats=2))
    elif name == "cut_2":
        add(build_kernel("cutlass", n_ctas=_s(160, scale), warps_per_cta=8,
                         body=_body_gemm_tile(20), repeats=2))
    elif name == "stencil_bar":
        # shared-memory-style stencil with CTA barriers between phases
        body = (_body_stream(3, 6)
                + [(BAR, False, 0, 0)]
                + _body_compute(8)
                + [(BAR, False, 0, 0)]
                + _body_stream(2, 4))
        add(build_kernel("stencil", n_ctas=_s(512, scale), warps_per_cta=4,
                         body=body, repeats=3))
    else:
        raise KeyError(name)
    return w


SUITES = {
    "rodinia": ["gaussian", "hotspot", "hybridsort", "lavaMD", "lud",
                "myocyte", "nn", "nw", "pathfinder", "srad"],
    "polybench": ["fdtd2d", "syrk"],
    "lonestar": ["mst", "sssp"],
    "deepbench": ["conv", "gemm", "rnn"],
    "cutlass": ["cut_1", "cut_2"],
}

ALL_BENCHMARKS = [b for s in SUITES.values() for b in s]
