"""Chip smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line; any failure exits non-zero before the
last line:
  1. the card's name and power limit (nvidia-smi) and the build of the
     port's CUDA kernel (sm_issue) from the sources in this checkout;
  2. the kernel against its plain PyTorch version on the card, exact
     equality on seeded cases at the TINY and RTX 3080 Ti shapes, and the
     time per launch of both;
  3. myocyte@1.0 on TINY in vmap and seq modes against
     tests/golden/determinism_tiny.json, with the kernel's launch count;
  4. the main path at full width: nn@0.5 and syrk@0.16 on the RTX 3080 Ti
     config (80 SMs x 48 warps, vmap) against
     tests/golden/torch_port_rtx3080ti.json, with 0 timeouts, wall time,
     quanta/s, simulated cycles/s and kernel launches;
  5. a profile of the first 16 quanta of syrk@0.16: device busy and
     idle share, kernel launches and device-to-host reads per quantum;
  6. a JSON line of per-kernel numbers;
  7. the last line, {"ok": true, "device": {...}}.

Imports nothing of JAX or of the JAX package.  Needs one CUDA card.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
N_CASES = 1200
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and the
# non-tensor-core rate used for the kernel's integer operations
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
# integer operations per warp slot: the candidate mask, the key, the
# argmin (counted generously)
OPS_PER_SLOT = 24


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    check(out, "nvidia-smi printed no card")
    return out[0]


def random_case(rng, torch, ns, w, sc, kind):
    """Seeded inputs of the sm_issue kernel, on the card.

    kind: 'neutral' (the TPU kernel's contract: no barrier wait, GTO,
    instr_base 0, n_instr = len(ops)), 'full' (barriers, LRR, instr_base,
    padded ops, n_instr down to 0) or 'ties' (identical warps: the lowest
    slot or the last-issued warp must win)."""
    dev = "cuda"
    L = int(rng.integers(1, 40))
    if kind == "ties":
        pc = np.full((ns, w), int(rng.integers(0, L)), np.int32)
        active = np.ones((ns, w), bool)
        ready_at = np.zeros((ns, w), np.int32)
        pending = np.zeros((ns, w), np.int32)
        wait_mem = np.zeros((ns, w), bool)
        wait_bar = rng.random((ns, w)) < 0.05
        unit_free = np.zeros((ns, sc, 5), np.int32)
        t = 0
    else:
        pc = rng.integers(0, L + 2, (ns, w)).astype(np.int32)
        active = rng.random((ns, w)) < 0.7
        ready_at = rng.integers(0, 20, (ns, w)).astype(np.int32)
        pending = rng.integers(0, 2, (ns, w)).astype(np.int32)
        wait_mem = rng.random((ns, w)) < 0.3
        wait_bar = (rng.random((ns, w)) < 0.2 if kind == "full"
                    else np.zeros((ns, w), bool))
        unit_free = rng.integers(0, 15, (ns, sc, 5)).astype(np.int32)
        t = int(rng.integers(0, 15))
    last = rng.integers(-1, w, (ns, sc)).astype(np.int32)
    if kind == "neutral":
        base, n_instr, sched, n_ops = 0, L, 0, L
    else:
        base = int(rng.integers(0, 8))
        n_instr = int(rng.integers(0, L + 1))
        sched = int(rng.integers(0, 2))
        n_ops = base + L + int(rng.integers(0, 8))
    ops = rng.integers(0, 7, (n_ops,)).astype(np.int32)

    def T(x):
        return torch.as_tensor(x, device=dev)

    return ((T(pc), T(active), T(ready_at), T(pending), T(wait_mem),
             T(wait_bar), T(last), T(unit_free), T(ops))
            + tuple(T(np.int32(v)) for v in (n_instr, base, sched, t)), sc)


def time_per_call(torch, fn, n):
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n          # ms


def device_events(prof):
    """(name, microseconds) of every device activity a profile caught:
    kernels, copies and fills."""
    from torch.autograd import DeviceType
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def profiled(torch, fn):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return device_events(prof), wall


def phase_kernel(torch, K):
    """Kernel vs plain version, exact, on seeded cases."""
    rng = np.random.default_rng(20261016)
    shapes = ((8, 8, 2), (80, 48, 4), (4, 8, 2), (3, 96, 3))
    kinds = ("neutral", "full", "ties")
    n_bad, max_err = 0, 0
    counts = {k: 0 for k in kinds}
    for i in range(N_CASES):
        ns, w, sc = shapes[i % len(shapes)]
        kind = kinds[(i // len(shapes)) % len(kinds)]
        args, sc = random_case(rng, torch, ns, w, sc, kind)
        got = K.issue_select(*args, n_subcores=sc)
        ref = K.issue_select_plain(*args, n_subcores=sc)
        for g, r in zip(got, ref):
            max_err = max(max_err, int((g - r).abs().max()))
            n_bad += int(not torch.equal(g, r))
        counts[kind] += 1
    torch.cuda.synchronize()
    check(n_bad == 0, f"sm_issue kernel disagrees with its plain version "
          f"in {n_bad} outputs (max abs err {max_err})")
    # time both at the main path's full width
    args, sc = random_case(rng, torch, 80, 48, 4, "full")
    wrapper_ms = time_per_call(
        torch, lambda: K.issue_select(*args, n_subcores=sc), 2000)
    plain_ms = time_per_call(
        torch, lambda: K.issue_select_plain(*args, n_subcores=sc), 200)

    def launches():
        for _ in range(500):
            K.issue_select(*args, n_subcores=sc)
    events, _ = profiled(torch, launches)
    kern = [us for name, us in events if "sm_issue_kernel" in name]
    # device time per launch from the profiler; the CUDA-event time of
    # back-to-back wrapper calls where the profiler saw no device activity
    ms = sum(kern) / len(kern) / 1e3 if kern else wrapper_ms
    n_bytes = sum(x.numel() * x.element_size() for x in args) \
        + 2 * 80 * 4 * 4
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 80 * 48 * OPS_PER_SLOT / ALU_OPS_PER_S * 1e3
    return {"cases": sum(counts.values()), "by_kind": counts,
            "max_abs_err": max_err, "ms": ms, "wrapper_ms": wrapper_ms,
            "device_timed": bool(kern), "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": n_bytes}


def run_case(torch, K, bench, scale, cfg, mode, max_cycles):
    from repro_torch.core import stats as S
    from repro_torch.core.engine import simulate
    from repro_torch.core.parallel import make_sm_runner
    from repro_torch.sim.workloads import resolve_workload

    w = resolve_workload(bench, scale)
    runner = make_sm_runner(cfg, mode)
    torch.cuda.synchronize()
    K.issue_select.launches = 0
    t0 = time.perf_counter()
    st = simulate(w, cfg, runner, max_cycles=max_cycles, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.issue_select.launches
    out = S.finalize(st)
    return S.comparable(out), out["timeouts"], wall, launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels.sm_issue import kernel as K
    from repro_torch.sim.config import RTX3080TI, TINY

    with open(os.path.join(GOLDEN, "determinism_tiny.json")) as f:
        tiny_golden = json.load(f)
    with open(os.path.join(GOLDEN, "torch_port_rtx3080ti.json")) as f:
        full_golden = json.load(f)

    # 1. card and build
    card = card_line()
    print(card)
    t0 = time.perf_counter()
    info = K.build()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "Used" in ln]
    print(f"[1 build] card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; sm_issue built in {info['seconds']:.2f} s "
          f"(load {build_s:.2f} s); ptxas: {' | '.join(ptxas)}", flush=True)

    # 2. kernel vs plain version
    kr = phase_kernel(torch, K)
    print(f"[2 kernel] sm_issue == plain on {kr['cases']} cases "
          f"{kr['by_kind']} (max abs err {kr['max_abs_err']}); at 80x48 SC=4: "
          f"kernel {kr['ms'] * 1e3:.3f} us/launch on the device "
          f"({'profiler' if kr['device_timed'] else 'not profiled: events'}),"
          f" wrapper {kr['wrapper_ms'] * 1e3:.2f} us/call, plain "
          f"{kr['plain_ms'] * 1e3:.2f} us/call, bound "
          f"{kr['bound_ms'] * 1e3:.4f} us ({kr['bound_by']}, "
          f"{kr['bytes']} B)", flush=True)

    # 3. TINY golden in both modes
    for mode in ("vmap", "seq"):
        got, timeouts, wall, launches = run_case(
            torch, K, "myocyte", 1.0, TINY, mode, 1 << 15)
        check(got == tiny_golden["myocyte@1.0"],
              f"myocyte@1.0 {mode} differs from the golden: {got}")
        check(timeouts == 0, f"myocyte@1.0 {mode}: {timeouts} timeouts")
        quanta = got["cycles"] // TINY.quantum
        if mode == "vmap":
            ok = launches == TINY.quantum * quanta
        else:   # one launch per SM that has work, per cycle
            ok = (0 < launches <= TINY.quantum * quanta * TINY.n_sm
                  and launches % TINY.quantum == 0)
        check(ok, f"myocyte@1.0 {mode}: {launches} sm_issue launches for "
              f"{quanta} quanta")
        print(f"[3 tiny] myocyte@1.0 {mode}: golden OK, {got['cycles']} "
              f"cycles, {quanta} quanta, {launches} sm_issue launches, "
              f"wall {wall:.2f} s", flush=True)

    # 4. the main path at full width
    main_launches = 0
    walls = []
    for bench, scale in (("nn", 0.5), ("syrk", 0.16)):
        got, timeouts, wall, launches = run_case(
            torch, K, bench, scale, RTX3080TI, "vmap", 1 << 17)
        key = f"{bench}@{scale}"
        check(got == full_golden[key], f"{key} differs from the pinned "
              f"stats: {got}")
        check(timeouts == 0, f"{key}: {timeouts} timeouts")
        quanta = got["cycles"] // RTX3080TI.quantum
        check(launches == RTX3080TI.quantum * quanta,
              f"{key}: {launches} sm_issue launches for {quanta} quanta")
        main_launches += launches
        walls.append(wall)
        print(f"[4 full] {key} RTX3080TI vmap: pinned stats OK, timeouts 0, "
              f"{got['cycles']} cycles, {quanta} quanta, wall {wall:.3f} s, "
              f"{quanta / wall:.1f} quanta/s, {got['cycles'] / wall:.1f} "
              f"simulated cycles/s, {launches} sm_issue launches",
              flush=True)
    check(main_launches > 0, "the main path never launched sm_issue")

    # 5. where the time goes: a profile of the first quanta of syrk@0.16
    n_q = 16
    events, wall = profiled(torch, lambda: run_case(
        torch, K, "syrk", 0.16, RTX3080TI, "vmap", n_q * RTX3080TI.quantum))
    busy = sum(us for _, us in events) / 1e6
    kernels = [(n, us) for n, us in events
               if not n.startswith(("Memcpy", "Memset"))]
    by_name = {}
    for name, us in kernels:
        by_name[name] = by_name.get(name, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    if events:
        print(f"[5 profile] syrk@0.16 first {n_q} quanta under the "
              f"profiler: wall {wall:.3f} s, device busy {busy:.3f} s "
              f"(idle share {1 - busy / wall:.4f}), "
              f"{len(kernels) / n_q:.0f} kernel launches/quantum, "
              f"{sum('DtoH' in n for n, _ in events) / n_q:.1f} device-to-"
              f"host reads/quantum, {len(by_name)} distinct kernels; top: "
              + "; ".join(f"{n[:60]} {us / 1e3:.1f} ms" for n, us in top),
              flush=True)
    else:
        print(f"[5 profile] the profiler saw no device activity: device "
              f"busy share not measured (wall {wall:.3f} s)", flush=True)

    # 6. per-kernel numbers
    print(json.dumps({"kernels": [{
        "name": "sm_issue", "route": "cuda",
        "source": "src/repro_torch/kernels/sm_issue/csrc/sm_issue.cu",
        "replaces": "src/repro/kernels/sm_issue/kernel.py:45",
        "launches": main_launches, "max_abs_err": kr["max_abs_err"],
        "ms": kr["ms"], "plain_ms": kr["plain_ms"],
        "bound_ms": kr["bound_ms"], "bound_by": kr["bound_by"],
        "library_ms": None, "wrapper_ms": kr["wrapper_ms"],
        "us_per_launch": kr["ms"] * 1e3,
        "plain_us": kr["plain_ms"] * 1e3, "bound_us": kr["bound_ms"] * 1e3,
    }]}))
    # 7. the result
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
