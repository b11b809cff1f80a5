"""Simulator launcher — run one workload on the RTX 3080 Ti config.

  python -m repro_torch.launch.simulate --workload nn --scale 0.5 --mode vmap
  python -m repro_torch.launch.simulate --workload myocyte --device cpu

Prints the comparable stats as JSON and a summary line, like
``python -m repro.launch.simulate``.  Runs on the CUDA device unless
``--device`` names another.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.core import stats as S
from repro_torch.core.engine import simulate
from repro_torch.core.parallel import make_sm_runner
from repro_torch.device import resolve_device
from repro_torch.sim.config import RTX3080TI
from repro_torch.workloads import make_workload


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="")
    ap.add_argument("--arch", default="")
    ap.add_argument("--scale", type=float, default=0.03)
    ap.add_argument("--mode", choices=["seq", "vmap"], default="vmap")
    ap.add_argument("--max-cycles", type=int, default=1 << 17)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    if args.arch:
        ap.error("--arch needs the LM stack, which is not ported to "
                 "repro_torch yet; use --workload")

    device = resolve_device(args.device)
    if device.type == "cpu":
        # the simulator's tensors are tiny: extra threads only add overhead
        torch.set_num_threads(1)
    cfg = RTX3080TI
    w = make_workload(args.workload or "hotspot", scale=args.scale)
    t0 = time.time()
    st = simulate(w, cfg, make_sm_runner(cfg, args.mode),
                  max_cycles=args.max_cycles, device=device)
    out = S.finalize(st)
    print(json.dumps({k: v for k, v in S.comparable(out).items()}, indent=1))
    print(f"[simulate] {w.name}: {out['cycles']} GPU cycles, "
          f"ipc={out['ipc']}, wall={time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
