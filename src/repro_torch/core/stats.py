"""Deterministic stat reduction — the paper's epilogue gather.

Per-SM counters are integers, so the reduction is bit-exact regardless of
execution mode or device count.  The per-SM bounded address sets (paper's
set-valued stat, strategy 2) are unioned here, on the host, once.
"""
from __future__ import annotations

import numpy as np
import torch


def _np(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def finalize(state: dict) -> dict:
    out = {}
    for k, v in state["stats_sm"].items():
        arr = _np(v).astype(np.int64)
        out[k] = int(arr.sum())
        out[f"{k}_per_sm"] = arr
    for k, v in state["stats"].items():
        out[k] = int(v)
    out["cycles"] = int(state["ctrl"].get("total_cycles",
                                          state["ctrl"]["cycle"]))
    # truncation accounting: kernels that hit max_cycles before finishing
    # (engine.run_workload* count them; done_cycle stayed negative).  Kept
    # out of comparable() — it is run-harness metadata, not timing state.
    out["timeouts"] = int(state["ctrl"].get("timeouts", 0))
    out["timeout"] = out["timeouts"] > 0
    # set-valued stat: union of per-SM address sets
    aset = _np(state["sm"]["addrset"]).ravel()
    out["unique_addrs"] = int(np.unique(aset[aset >= 0]).size)
    out["addrset_overflow"] = int(np.sum(
        _np(state["sm"]["addrset_over"])))
    ipc = out["issued"] / max(out["cycles"], 1)
    out["ipc"] = round(ipc, 4)
    return out


def to_jsonable(obj):
    """Recursively convert a stats/manifest payload to JSON-safe builtins:
    numpy arrays and tensors → lists, scalars → int/float, tuples → lists.
    ``finalize`` output carries ``*_per_sm`` int64 arrays that
    ``json.dump`` rejects — every manifest/bench writer funnels through
    here instead of crashing or silently str()-ing them."""
    if isinstance(obj, dict):
        return {str(k): to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(v) for v in obj]
    if isinstance(obj, (bool, np.bool_)):
        return bool(obj)
    if isinstance(obj, (int, np.integer)):
        return int(obj)
    if isinstance(obj, (float, np.floating)):
        return float(obj)
    if obj is None or isinstance(obj, str):
        return obj
    if isinstance(obj, torch.Tensor) or hasattr(obj, "__array__"):
        arr = _np(obj)
        if arr.ndim == 0:
            return arr.item()
        return arr.tolist()
    return str(obj)                        # last resort: stable repr


def comparable(stats: dict) -> dict:
    """The subset that must be IDENTICAL across execution modes."""
    keys = ("issued", "issued_mem", "l1_hit", "l1_miss", "l2_hit", "l2_miss",
            "dram_req", "dram_row_hit", "ctas_launched", "cycles",
            "unique_addrs", "cycles_issue", "stall", "warp_cycles")
    return {k: stats[k] for k in keys}
