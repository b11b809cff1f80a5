"""Where the wkv6 kernel's time goes: the kernel with one phase cut out at a
time, each timed against the whole at the serving prefill's shape.

    PYTHONPATH=src python -m repro_torch.kernels.wkv6.phase_times

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
from repro_torch.kernels.wkv6.kernel import SOURCE

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


def variant(name, cuts, text):
    for old, new in cuts:
        if text.count(old) != 1:
            raise RuntimeError(f"phase_times: cut {name!r} does not match "
                               f"csrc/wkv6.cu once: {old!r}")
        text = text.replace(old, new)
    path = BUILD_DIR / f"wkv6_cut_{name}.cu"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    lib, _ = build_library(path, f"wkv6_cut_{name}")
    fn = lib.wkv6_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    if not torch.cuda.is_available():
        print("phase_times: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    text = SOURCE.read_text()
    with ThreadPoolExecutor(len(CUTS)) as pool:
        fns = dict(zip(CUTS, pool.map(lambda kv: variant(*kv, text),
                                      CUTS.items())))
    b, s, h, hs = SHAPE
    rng = np.random.default_rng(0)
    f = np.float32
    host = [(0.5 * rng.standard_normal(SHAPE)).astype(f) for _ in range(3)]
    host += [(-np.exp(rng.standard_normal(SHAPE) - 1)).astype(f),
             (0.3 * rng.standard_normal((h, hs))).astype(f),
             np.zeros((b, h, hs, hs), f)]
    args = [torch.as_tensor(x, device="cuda") for x in host]
    o, s_out = torch.empty_like(args[0]), torch.empty_like(args[5])
    ptrs = [a.data_ptr() for a in args] + [o.data_ptr(), s_out.data_ptr()]
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
    us = {name: min(r[name] for r in rounds) for name in CUTS}
    print(json.dumps({"shape": list(SHAPE), "us_per_launch": us,
                      "without": {name: us["whole"] - us[name]
                                  for name in CUTS if name != "whole"}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
