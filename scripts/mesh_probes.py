"""SM-axis sharding and the ('cfg','sm') mesh on four distinct cards,
beside the same runs with every position on the first card.  Run from the
repository root on a machine with four CUDA cards:

    PYTHONPATH=src python3 scripts/mesh_probes.py

Runs, in turns, the 4-way shards of nn@0.5 and syrk@0.16 (RTX 3080 Ti
config, static assignment, window exchange) and dse's grid of 8 configs
over nn@0.5 on the 2×2, 4×1 and 1×4 meshes, each twice on the repeated
card and twice on the four cards, with walls and ``sm_quantum`` launches,
and a 16-quantum loop profile of each mesh on the four cards; then
``dse --mesh 2 2 --check`` on the first four cards and the card tests of
the mesh and of the launch device (tests/test_torch_cuda.py).  Prints the
card's name and power limit first and exits non-zero if a result
disagrees.  chip_smoke.py's phase m holds the one-card runs.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from repro_torch.core.distribute import make_mesh  # noqa: E402
from repro_torch.core.plan import RunPlan  # noqa: E402
from repro_torch.core.sweep import sweep  # noqa: E402
from repro_torch.kernels.sm_issue import kernel as K  # noqa: E402
from repro_torch.kernels.sm_quantum import kernel as Q  # noqa: E402
from repro_torch.launch import dse  # noqa: E402
from repro_torch.launch.dse import default_grid, lane_signature  # noqa: E402
from repro_torch.sim.config import RTX3080TI  # noqa: E402
from repro_torch.sim.workloads import resolve_workload  # noqa: E402

MESHES = ((2, 2), (4, 1), (1, 4))


def mesh_sweeps(devices, label):
    """dse's grid of 8 configs over nn@0.5 on every mesh of MESHES, its
    positions taken from ``devices`` in order, twice each, against the
    no-mesh sweep; a loop profile of each mesh on distinct cards."""
    bad = []
    w = resolve_workload("nn", 0.5)
    cfgs = default_grid(RTX3080TI, 8)
    plan = dict(max_cycles=1 << 17)
    ref, wall, _, _, _ = CS._counted_run(torch, K, Q, lambda: sweep(
        w, cfgs, plan=RunPlan(**plan), device="cuda"))
    want = [lane_signature(s) for s in ref.stats]
    print(f"[mesh {label}] no mesh: wall {wall:.3f} s", flush=True)
    for a, b in MESHES:
        mesh = make_mesh(a, b, devices=devices[:a * b])
        for _ in range(2):
            r, wall, fused, _, steps = CS._mesh_counted(
                torch, K, Q, lambda: sweep(w, cfgs, plan=RunPlan(
                    mesh=mesh, **plan), device="cuda"))
            ok = [lane_signature(s) for s in r.stats] == want \
                and fused == b * steps
            print(f"[mesh {label}] {a}x{b} on {mesh.describe()['devices']}: "
                  f"ok={ok} wall {wall:.3f} s, {steps} group quanta, "
                  f"{fused} sm_quantum launches", flush=True)
            bad += [] if ok else [f"{label} {a}x{b}"]
        if label == "distinct":
            row = CS.loop_profile(torch, w, cfgs, 16,
                                  CS.mesh_loop(w, cfgs, mesh, 16))
            print(f"[mesh {label}] {a}x{b} first 16 quanta: "
                  f"{CS.profile_text(row)}", flush=True)
    return bad


def main():
    if torch.cuda.device_count() < 4:
        print("mesh_probes: needs four CUDA cards", file=sys.stderr)
        return 1
    print(CS.card_line(), flush=True)
    K.build()
    Q.build()
    t0 = time.perf_counter()
    with open(os.path.join(CS.GOLDEN, "torch_port_rtx3080ti.json")) as f:
        full = json.load(f)
    first = [torch.device("cuda", 0)] * 4
    four = [torch.device("cuda", i) for i in range(4)]
    bad = []
    for bench, scale in (("nn", 0.5), ("syrk", 0.16)):
        key = f"{bench}@{scale}"
        for label, devs in (("repeated", first), ("distinct", four)):
            for _ in range(2):
                got, to, wall, fused, _, steps = CS.shard_run(
                    torch, K, Q, bench, scale, RTX3080TI, "static",
                    "window", 1 << 17, devices=devs)
                ok = got == full[key] and to == 0 and fused == 4 * steps
                print(f"[1-D {label}] {key} 4 shards: ok={ok} wall "
                      f"{wall:.3f} s, {steps} quanta", flush=True)
                bad += [] if ok else [f"{label} {key}"]
    for label, devs in (("repeated", first), ("distinct", four)):
        bad += mesh_sweeps(devs, label)
    lines, err = CS._launcher_run(dse.main, [
        "--base", "3080ti", "--workload", "nn", "--scale", "0.5", "--mesh",
        "2", "2", "--check", "--no-manifest"])
    print(f"[dse] first four cards: {err or lines[-3:]}", flush=True)
    bad += [] if not err and lines[-1].startswith("[dse] check OK") \
        else ["dse"]
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "cuda",
         os.path.join(ROOT, "tests", "test_torch_cuda.py"), "-k",
         "repeated or tensors_device"], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    print(r.stdout[-1500:], flush=True)
    bad += [] if r.returncode == 0 else ["card tests"]
    print(f"[done] in {time.perf_counter() - t0:.1f} s; disagreements: "
          f"{bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
