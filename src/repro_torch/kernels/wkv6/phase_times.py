"""Where the wkv6 kernels' time goes: a kernel with one phase cut out at a
time, each timed against the whole at the serving prefill's shape.

    PYTHONPATH=src python -m repro_torch.kernels.wkv6.phase_times
    PYTHONPATH=src python -m repro_torch.kernels.wkv6.phase_times --backward

The first cuts the forward kernel, the second the backward kernel
(``csrc/wkv6_bwd.cu``, with a final-state adjoint; its cuts are
``BWD_CUTS``: pass 1, the prefetches, and each stage's work of each half
of the block).

Needs one CUDA card.  Each variant is ``csrc/wkv6.cu`` with one block of
the chunk loop skipped (its condition made false for any T > 0), built
like the kernel (in parallel) and timed with CUDA events in turns over
two rounds on the same seeded inputs at (B, S, H, hs) = (8, 512, 32, 64).
A variant computes nonsense; only its time is read.  The whole's time
less a variant's is that phase's share, as far as phases do not overlap:
"loads" skips the prefetch of the next chunk (the computation alone),
"loads_only" skips all computation.  Prints the card, then one JSON
object of microseconds per launch.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.kernels.build import BUILD_DIR, build_library
from repro_torch.kernels.wkv6.kernel import (BWD_SOURCE, SOURCE,
                                             bwd_chunk, bwd_scratch_floats)

SHAPE = (8, 512, 32, 64)
# (variant, [(text in the source, its replacement)])
CUTS = {
    "whole": [],
    "scan": [("    {\n      const int part = tid % PARTS",
              "    if (T < 0) {\n      const int part = tid % PARTS")],
    "diagonal": [("    {\n      const int s1 = da * SUB + dsp",
                  "    if (T < 0) {\n      const int s1 = da * SUB + dsp")],
    "p2": [("    {\n      const int nt = warp & 1, k_lo",
            "    if (T < 0) {\n      const int nt = warp & 1, k_lo")],
    "split": [("      const int t = t0 + m * TSTEP, c = c4;\n",
               "      const int t = t0 + m * TSTEP, c = c4;\n"
               "      if (T > 0) break;\n")],
    "products": [("    {\n      const int mt = warp & 1;",
                  "    if (T < 0) {\n      const int mt = warp & 1;"),
                 ("    if (warp < NMT) {", "    if (warp < NMT && T < 0) {")],
    "loads": [("    if (n + 1 < n_chunks)  // stage",
               "    if (n + 1 < n_chunks && T < 0)  // stage")],
    "loads_only": [("    float* Lc = R + Ly::w_off;    // w, then L in its place\n",
                    "    float* Lc = R + Ly::w_off;    // w, then L in its place\n"
                    "    if (T > 0) continue;\n")],
}

BWD_CUTS = {
    "whole": [],
    "pass1": [("    if (cuda_half) decays<HS>(smem, stg + Ly::w_off, ct);",
               "    if (cuda_half && T < 0) decays<HS>(smem, stg + Ly::w_off,"
               " ct);"),
              ("    for (int q = warp; q < 2 * NMT; q += NW)\n"
               "      step_back<HS, NJH>(Gs, stg",
               "    for (int q = warp; T < 0 && q < 2 * NMT; q += NW)\n"
               "      step_back<HS, NJH>(Gs, stg")],
    "loads": [("    if (n + 1 < nc) load(n + 1, st ^ 1, false);",
               "    if (n + 1 < nc && T < 0) load(n + 1, st ^ 1, false);"),
              ("    if (n > 0) load(n - 1, st ^ 1, true);",
               "    if (n > 0 && T < 0) load(n - 1, st ^ 1, true);")],
    "s1_cuda": [("      decays<HS>(smem, Wst, ct);\n      if (own) {",
                 "      decays<HS>(smem, Wst, ct);\n      if (own && T < 0) {"),
                ("      if (wt < 3) {\n        const int tb",
                 "      if (wt < 3 && T < 0) {\n        const int tb")],
    "s1_products": [("    } else {\n      const int mt = wt & 1, j0",
                     "    } else if (T < 0) {\n      const int mt = wt & 1, "
                     "j0")],
    "s2_diag_a": [("      {\n        const int s1 = da * SUB + dsp",
                   "      if (T < 0) {\n        const int s1 = da * SUB + dsp")],
    "s2_walk": [("      if (own) {\n        float rv[SUB]",
                 "      if (own && T < 0) {\n        float rv[SUB]")],
    "s2_products": [("    } else {\n      // A's off-diagonal block",
                     "    } else if (T < 0) {\n      // A's off-diagonal block")],
    "s3_cuda": [("      if (own) {\n        const float ui = us[ci];",
                 "      if (own && T < 0) {\n        const float ui = us[ci];"),
                ("      if (own) {\n        const float other",
                 "      if (own && T < 0) {\n        const float other")],
    "s3_products": [("    } else {\n      // dv = (k . cb) G + A^T do",
                     "    } else if (T < 0) {\n      // dv = (k . cb) G + "
                     "A^T do")],
    "s3_g": [("    for (int q = warp; q < 2 * NMT; q += NW)\n"
              "      step_back<HS, NJH>(Gs, R",
              "    for (int q = warp; T < 0 && q < 2 * NMT; q += NW)\n"
              "      step_back<HS, NJH>(Gs, R")],
}


def variant(name, cuts, text, backward=False):
    stem = "wkv6_bwd" if backward else "wkv6"
    for old, new in cuts:
        if text.count(old) != 1:
            raise RuntimeError(f"phase_times: cut {name!r} does not match "
                               f"csrc/{stem}.cu once: {old!r}")
        text = text.replace(old, new)
    path = BUILD_DIR / f"{stem}_cut_{name}.cu"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    lib, _ = build_library(path, f"{stem}_cut_{name}")
    chunk = None
    if backward:
        fn = lib.wkv6_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        chunk = bwd_chunk(text)
    else:
        fn = lib.wkv6_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, chunk


def main() -> int:
    if not torch.cuda.is_available():
        print("phase_times: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    backward = "--backward" in sys.argv[1:]
    cuts = BWD_CUTS if backward else CUTS
    text = (BWD_SOURCE if backward else SOURCE).read_text()
    with ThreadPoolExecutor(len(cuts)) as pool:
        built = dict(zip(cuts, pool.map(
            lambda kv: variant(*kv, text, backward), cuts.items())))
    fns = {name: fn for name, (fn, _) in built.items()}
    b, s, h, hs = SHAPE
    rng = np.random.default_rng(0)
    f = np.float32
    host = [(0.5 * rng.standard_normal(SHAPE)).astype(f) for _ in range(3)]
    host += [(-np.exp(rng.standard_normal(SHAPE) - 1)).astype(f),
             (0.3 * rng.standard_normal((h, hs))).astype(f),
             np.zeros((b, h, hs, hs), f)]
    if backward:        # do and the final state's adjoint
        host += [rng.standard_normal(SHAPE).astype(f),
                 rng.standard_normal((b, h, hs, hs)).astype(f)]
    args = [torch.as_tensor(x, device="cuda") for x in host]
    if backward:
        outs = [torch.empty_like(args[0]) for _ in range(4)]
        floats = max(bwd_scratch_floats(b, s, h, hs, chunk)  # each cut's
                     for _, chunk in built.values())
        outs += [torch.empty((b, h, hs), device="cuda"),
                 torch.empty(floats, device="cuda")]
    else:
        outs = [torch.empty_like(args[0]), torch.empty_like(args[5])]
    ptrs = [a.data_ptr() for a in args + outs]
    stream = torch.cuda.current_stream().cuda_stream

    def timed(fn, n=50):
        for _ in range(5):
            fn(*ptrs, b, s, h, hs, stream)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            if fn(*ptrs, b, s, h, hs, stream):
                raise RuntimeError("phase_times: launch failed")
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n * 1e3

    rounds = [{name: timed(fn) for name, fn in fns.items()}
              for _ in range(2)]
    us = {name: min(r[name] for r in rounds) for name in cuts}
    print(json.dumps({"kernel": "wkv6_bwd" if backward else "wkv6",
                      "shape": list(SHAPE), "us_per_launch": us,
                      "without": {name: us["whole"] - us[name]
                                  for name in cuts if name != "whole"}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
