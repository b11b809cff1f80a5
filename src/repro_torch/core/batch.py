"""Trace batching: pad, stack, concatenate and bucket kernel traces.

The engine reads a packed kernel trace through two scalars — ``n_instr``
(instruction fetch is clipped to ``pc < n_instr``) and ``n_ctas``
(dispatch stops at ``next_cta >= n_ctas``) — so a trace can be padded
without changing a single simulated event:

  · **NOP slots**: instruction arrays grow to a shared ``n_instr_max``;
    the pad region is never fetched.
  · **Empty kernels**: ``n_ctas=0`` kernels, which the engine's kernel
    loop masks out entirely (state passes through, 0 cycles charged).

Two layouts, as in ``repro.core.batch``: padded (``stack_kernels``,
``stack_workloads``: every kernel NOP-padded to the longest) and ragged
(``concat_kernels``, ``concat_workloads``: each workload's kernels
concatenated flat with an ``instr_base`` offset table).  Bucketing
(``bucket_workloads``) groups workload lanes of similar padded shape or
predicted cost so that each bucket runs padded only to its own max.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.telemetry import COUNTERS

# per-instruction (length-L) fields of a packed kernel trace
INSTR_FIELDS = ("ops", "dep", "addr_mode", "addr_param")
# per-kernel scalar fields
SCALAR_FIELDS = ("n_ctas", "warps_per_cta", "n_instr")


def check_workload_fits(scfg, workload) -> None:
    """A kernel whose CTA needs more warp slots than an SM has can never
    dispatch and would spin until ``max_cycles``: raise by name."""
    wps = scfg.warps_per_sm
    for k in workload.kernels:
        if k.warps_per_cta > wps:
            raise ValueError(
                f"kernel {k.name!r} of workload {workload.name!r} has "
                f"warps_per_cta={k.warps_per_cta} > warps_per_sm={wps}: "
                "it could never dispatch and would spin to max_cycles.  "
                "Use a larger config, or split oversized CTAs at ingest "
                "(traceio.load_trace(..., max_warps_per_cta=...))")


def pad_packed(packed: dict, n_instr_max: int) -> dict:
    """Pad a packed kernel's instruction arrays to ``n_instr_max`` with
    inert NOP slots; ``n_instr`` keeps the TRUE length."""
    length = int(packed["ops"].shape[0])
    if length > n_instr_max:
        raise ValueError(
            f"kernel has {length} instructions > n_instr_max={n_instr_max}")
    out = dict(packed)
    for f in INSTR_FIELDS:
        out[f] = F.pad(packed[f], (0, n_instr_max - length))
    return out


def empty_packed(n_instr_max: int, device) -> dict:
    """An ``n_ctas=0`` kernel: dispatches nothing, runs nothing."""
    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)
    return {
        "ops": zeros(n_instr_max),
        "dep": zeros(n_instr_max, dtype=torch.bool),
        "addr_mode": zeros(n_instr_max),
        "addr_param": zeros(n_instr_max),
        "n_ctas": zeros(),
        "warps_per_cta": torch.ones((), dtype=torch.int32,
                                    device=device),  # a divisor: never 0
        "n_instr": zeros(),
    }


def stack_kernels(kernels: list, n_instr: int | None = None,
                  n_kernels: int | None = None) -> dict:
    """Pad packed kernels to shared (n_kernels, n_instr) and stack them
    into a leading kernel axis."""
    if not kernels:
        raise ValueError("empty kernel list")
    lengths = [int(k["ops"].shape[0]) for k in kernels]
    if n_instr is None:
        n_instr = max(lengths)
    if n_kernels is None:
        n_kernels = len(kernels)
    if len(kernels) > n_kernels:
        raise ValueError(
            f"{len(kernels)} kernels > n_kernels={n_kernels}")
    padded = [pad_packed(k, n_instr) for k in kernels]
    padded += [empty_packed(n_instr, kernels[0]["ops"].device)] * (
        n_kernels - len(kernels))
    return {f: torch.stack([p[f] for p in padded]) for f in padded[0]}


def _stack(trees: list) -> dict:
    """Stack dicts of tensors leaf by leaf along a new leading axis."""
    return {f: torch.stack([t[f] for t in trees]) for f in trees[0]}


def _packs(workloads: list, device) -> list:
    if not workloads:
        raise ValueError("empty workload list")
    packs = [[k.pack(device) for k in w.kernels] for w in workloads]
    if any(not p for p in packs):
        raise ValueError("workload with no kernels")
    return packs


def stack_workloads(workloads: list, device) -> dict:
    """Stack whole workloads into a leading workload-lane axis.

    Every kernel of every workload is padded to the global
    (max kernel count, max instruction count); leaves come out shaped
    ``(n_workloads, n_kernels, ...)``."""
    packs = _packs(workloads, device)
    n_kernels = max(len(p) for p in packs)
    n_instr = max(int(k["ops"].shape[0]) for p in packs for k in p)
    return _stack([stack_kernels(p, n_instr=n_instr, n_kernels=n_kernels)
                   for p in packs])


# ---------------------------------------------------------------------------
# ragged layout: flat instruction streams + per-kernel offset tables
# ---------------------------------------------------------------------------

def concat_kernels(packs: list, n_instr_total: int | None = None,
                   n_kernels: int | None = None) -> dict:
    """Concatenate packed kernels into the ragged workload layout.

    Instruction arrays become ONE flat ``(n_instr_total,)`` array per
    field; per-kernel scalars gain an ``instr_base`` offset table so the
    engine fetches at ``instr_base + pc`` while pc stays kernel-local.
    The flat length is Σ lengths, padded (inert zeros past every
    base+n_instr) only up to a shared ``n_instr_total`` across
    workloads."""
    if not packs:
        raise ValueError("empty kernel list")
    lengths = [int(k["ops"].shape[0]) for k in packs]
    total = sum(lengths)
    if n_instr_total is None:
        n_instr_total = total
    if total > n_instr_total:
        raise ValueError(
            f"{total} instructions > n_instr_total={n_instr_total}")
    if n_kernels is None:
        n_kernels = len(packs)
    if len(packs) > n_kernels:
        raise ValueError(f"{len(packs)} kernels > n_kernels={n_kernels}")
    device = packs[0]["ops"].device
    pad_k = n_kernels - len(packs)
    bases = [0]
    for length in lengths[:-1]:
        bases.append(bases[-1] + length)
    out = {}
    for f in INSTR_FIELDS:
        flat = torch.cat([k[f] for k in packs])
        out[f] = F.pad(flat, (0, n_instr_total - total))
    for f in SCALAR_FIELDS:
        fill = 1 if f == "warps_per_cta" else 0   # never a 0 divisor
        out[f] = torch.tensor([int(k[f]) for k in packs] + [fill] * pad_k,
                              dtype=torch.int32, device=device)
    out["instr_base"] = torch.tensor(bases + [0] * pad_k, dtype=torch.int32,
                                     device=device)
    return out


def concat_workloads(workloads: list, device) -> dict:
    """Ragged counterpart of ``stack_workloads``: each workload's kernels
    concatenate flat (``concat_kernels``), then workloads stack into the
    leading lane axis.  Instruction leaves come out
    ``(n_workloads, n_instr_total_max)``; per-kernel scalars (including
    ``instr_base``) come out ``(n_workloads, n_kernels_max)``."""
    packs = _packs(workloads, device)
    n_kernels = max(len(p) for p in packs)
    total = max(sum(int(k["ops"].shape[0]) for k in p) for p in packs)
    return _stack([concat_kernels(p, n_instr_total=total,
                                  n_kernels=n_kernels) for p in packs])


def split_ragged(trace: dict):
    """Split a ragged workload trace into (per-kernel scalars, flat
    instruction streams).  The engine's kernel loop takes one kernel's
    scalars at a time and re-merges them with the streams."""
    scan = {f: trace[f] for f in SCALAR_FIELDS + ("instr_base",)}
    flat = {f: trace[f] for f in INSTR_FIELDS}
    return scan, flat


# ---------------------------------------------------------------------------
# bucketed lane packing: group grid lanes by shape / predicted cost
# ---------------------------------------------------------------------------

def workload_cost(workload, cost_hints: dict | None = None) -> float:
    """Predicted simulation cost of one workload: Σ n_instr × n_ctas over
    its kernels.  A recorded hint (``cost_hints_from_manifests``)
    overrides the proxy."""
    if cost_hints and workload.name in cost_hints:
        return float(cost_hints[workload.name])
    return float(sum(k.n_instr * k.n_ctas for k in workload.kernels))


def workload_shape(workload) -> tuple:
    """The padded-footprint key: (kernel count, longest kernel's n_instr).
    Workloads sharing it pad each other for free in one bucket."""
    return (len(workload.kernels),
            max(k.n_instr for k in workload.kernels))


def _gap_partition(keys: list, order: list, max_buckets: int) -> list:
    """Split the sorted lane order at the ``max_buckets - 1`` largest
    positive key gaps (zero-width gaps never split — rerun stability)."""
    gaps = [(keys[order[j + 1]] - keys[order[j]], j)
            for j in range(len(order) - 1)]
    cuts = sorted(j for g, j in sorted(gaps, reverse=True)[:max_buckets - 1]
                  if g > 0)
    buckets, start = [], 0
    for j in cuts:
        buckets.append(order[start:j + 1])
        start = j + 1
    buckets.append(order[start:])
    return buckets


def choose_bucket_count(keys: list, overhead: float | None = None,
                        max_k: int = 8) -> int:
    """Pick the k ∈ [1, max_k] whose gap-cut partition minimizes the
    predicted total padded cost

        Σ_buckets |bucket| · max(bucket key)  +  overhead · k

    (default overhead: the mean lane cost).  Ties break toward fewer
    buckets."""
    n = len(keys)
    if n <= 1:
        return max(n, 1)
    if overhead is None:
        overhead = sum(keys) / n
    order = sorted(range(n), key=lambda i: (keys[i], i))
    best_k, best_cost = 1, None
    for k in range(1, min(max_k, n) + 1):
        buckets = _gap_partition(keys, order, k)
        cost = sum(len(b) * max(keys[i] for i in b) for b in buckets) \
            + overhead * len(buckets)
        if best_cost is None or cost < best_cost:
            best_k, best_cost = k, cost
    return best_k


def bucket_workloads(workloads: list, by: str = "shape",
                     max_buckets: int | None = 4,
                     cost_hints: dict | None = None) -> list:
    """Partition workload-lane indices into ≤ ``max_buckets`` buckets of
    similar padded shape ('shape') or predicted cost ('cost').
    ``max_buckets=None`` picks the count with ``choose_bucket_count``.

    Returns a list of index lists covering ``range(len(workloads))``
    exactly once.  Deterministic: lanes are ordered by (key, index) and
    split at the ``max_buckets - 1`` largest key gaps — zero-width gaps
    never split, so reruns group identically whatever the lane order."""
    n = len(workloads)
    if by == "none" or n == 0:
        return [list(range(n))]
    if by == "shape":
        keys = [float(k * l) for k, l in map(workload_shape, workloads)]
    elif by == "cost":
        keys = [workload_cost(w, cost_hints) for w in workloads]
    else:
        raise ValueError(f"unknown bucket policy {by!r}; "
                         "use 'none', 'shape' or 'cost'")
    if max_buckets is None:
        max_buckets = choose_bucket_count(keys)
    order = sorted(range(n), key=lambda i: (keys[i], i))
    return _gap_partition(keys, order, max_buckets)


def cost_hints_from_manifests(run_dir: str = "experiments/runs") -> dict:
    """Measured per-workload cost from prior run manifests: for every
    stats entry carrying a workload name, cost = cycles + the final
    recorded ``lockstep_waste`` of its timeline.  The max across
    lanes/manifests wins.  Missing or garbled manifests are skipped —
    hints are an optimization, never a correctness input."""
    import glob
    import json
    import os

    col = COUNTERS.index("lockstep_waste")
    hints: dict = {}
    for path in sorted(glob.glob(os.path.join(run_dir, "*.json"))):
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, ValueError):
            continue
        waste = {}
        try:
            for name, rows in (payload.get("timelines") or {}).items():
                if rows:
                    # grid manifests key timelines "<workload>/<cfg>" —
                    # fold the cfg lanes onto the workload, max wins
                    base = name.rsplit("/", 1)[0]
                    waste[base] = max(waste.get(base, 0.0),
                                      float(rows[-1][col]))
        except (ValueError, TypeError, IndexError):
            pass
        for entry in payload.get("stats") or []:
            if not isinstance(entry, dict) or "workload" not in entry:
                continue
            try:
                cost = float(entry["cycles"]) + waste.get(
                    entry["workload"], 0.0)
            except (KeyError, TypeError, ValueError):
                continue
            name = entry["workload"]
            hints[name] = max(hints.get(name, 0.0), cost)
    return hints
