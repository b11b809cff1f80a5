"""Perf-iteration probe: FLOPs, HBM bytes and collectives of one step
attributed to the port's functions; the port's
``repro.launch.perf_probe``.  Usage:

  python -m repro_torch.launch.perf_probe --arch qwen2-72b --shape train_4k

``attribute(fn, args)`` runs ``fn(*args)`` under the cost pass
(``launch/hlo_costs.py``) and keys each counted operation by its
stack's tag (``hlo_costs.stack_tag``): the innermost
``repro_torch/models/…`` or ``parallelism/…`` function on the stack
(else the innermost of the port's, else "?"), or the first ``coarse``
key that the stack's function names contain.  The backward's
operations run in the autograd engine, with no Python stack of their
own: anomaly mode records each graph node's forward stack, and an
operation of the backward takes the tag of the node that runs it (in a
checkpoint's recompute, of its own stack), with " (bwd)" added.  The
cell's step (``dryrun.build_lowerable``) runs on fake tensors; the
tables are summed over the mesh's devices.
"""
from __future__ import annotations

import argparse
import collections
import re
import warnings

import torch

from repro_torch.launch import hlo_analysis as hlo
from repro_torch.launch import hlo_costs as H

_FRAME = re.compile(r'File "([^"]+)", line \d+, in (\S+)')


def make_tagger(coarse: tuple = ()):
    """The cost pass's tagger: ``hlo_costs.stack_tag`` of the running
    Python stack, or in the autograd engine of its node's forward stack."""
    def tagger():
        tag, in_model = H.stack_tag(H.stack_frames(), coarse)
        node = torch._C._current_autograd_node()
        if node is None:
            return tag or "?"
        tb = node.metadata.get("traceback_")
        if in_model and not (tb and tag.endswith(".backward")):
            return tag + " (bwd)"   # a checkpoint's recompute
        if not tb:
            return f"backward:{node.name()}"
        frames = [m.groups() for m in _FRAME.finditer("".join(tb))]
        return (H.stack_tag(frames[::-1], coarse)[0] or "?") + " (bwd)"
    return tagger


def attribute(fn, args, coarse: tuple = ()) -> dict:
    """{"flops": Counter(tag), "bytes": Counter((op, tag)), "colls":
    Counter((link, tag))} of ``fn(*args)``, summed over devices, with the
    pass itself under "pass"."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Anomaly Detection")
        with torch.autograd.detect_anomaly(check_nan=False):
            _, cp = H.analyze(fn, *args, tagger=make_tagger(coarse))
    out = {k: collections.Counter(v) for k, v in cp.by_tag.items()}
    out["pass"] = cp
    return out


def print_tables(att: dict, n_dev: int, top: int, dtype=torch.float32):
    """The reference's three tables, per device (summed over the mesh's
    devices, divided by their count), with the H100's peaks."""
    tf = sum(att["flops"].values()) / n_dev
    print(f"== per-device FLOPs: {tf:.3e}  (compute term "
          f"{tf / hlo.PEAK_FLOPS[dtype]:.4f}s on {hlo.CARD}, "
          f"{hlo.POWER_LIMIT_W} W)")
    for t, f in att["flops"].most_common(top):
        print(f"  {f / n_dev:.3e} {f / max(tf * n_dev, 1) * 100:5.1f}%  {t}")
    tb = sum(att["bytes"].values()) / n_dev
    print(f"== per-device HBM bytes: {tb:.3e}  (memory term "
          f"{tb / hlo.HBM_BW:.4f}s)")
    for (op, t), b in att["bytes"].most_common(top):
        print(f"  {b / n_dev:.3e} {b / max(tb * n_dev, 1) * 100:5.1f}%  "
              f"[{op}] {t}")
    tc = sum(att["colls"].values()) / n_dev
    print(f"== per-device collective bytes: {tc:.3e}  (collective term "
          f"~{tc / hlo.NVLINK_BW:.4f}s over NVLink)")
    for (link, t), b in att["colls"].most_common(top):
        print(f"  {b / n_dev:.3e} {b / max(tc * n_dev, 1) * 100:5.1f}%  "
              f"[{link}] {t}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=18)
    args = ap.parse_args()

    from repro_torch.launch.dryrun import build_lowerable
    fn, fargs, meta = build_lowerable(args.arch, args.shape,
                                      multi_pod=args.multi_pod)
    if meta.get("skipped"):
        print(f"[perf_probe] SKIP: {meta['reason']}")
        return
    att = attribute(fn, fargs)
    print_tables(att, meta["n_chips"], args.top)


if __name__ == "__main__":
    main()
