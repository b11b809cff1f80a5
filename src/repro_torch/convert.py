"""Carry-across functions between the JAX package's data and the port's.

The JAX package's state pytree, packed kernels, ``DynConfig``, LM
parameters and LM cache reach this module as numpy arrays (``numpy.asarray``
of each leaf, nested dicts and lists kept); these functions turn them into
the port's tensors on a device, and back.  Dtypes carry over unchanged
(int32 stays int32, bool stays bool), so identical seeded inputs can be fed
to both packages and their outputs compared.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.sim.config import N_CLASSES, N_UNITS, DynConfig
from repro_torch.sim.trace import gen_address


def to_torch(tree, device):
    """Nested dicts of numpy arrays (or scalars) → the same dicts of
    tensors on ``device``, copied."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), device=device)


def to_numpy(tree):
    """Nested dicts of tensors → the same dicts of numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def stack_lanes(trees: list):
    """Per-lane trees (nested dicts of numpy arrays or scalars) → one tree
    whose leaves lead with a lane axis, lane ``i`` from ``trees[i]``: the
    layout of the port's lane-batched state, traces and configs."""
    if isinstance(trees[0], dict):
        return {k: stack_lanes([t[k] for t in trees]) for k in trees[0]}
    return np.stack([np.asarray(t) for t in trees])


def dyn_to_torch(flat: dict, device) -> DynConfig:
    """A flat {key: array} view of a DynConfig (the JAX package's
    ``DynConfig.flat()``) → the port's ``DynConfig`` on ``device``."""
    return DynConfig.from_flat(
        {k: np.asarray(v, np.int32) for k, v in flat.items()}, device)


def dyn_to_numpy(dyn: DynConfig) -> dict:
    """The port's ``DynConfig`` → a flat {key: numpy int32 array} dict,
    the input of the JAX package's ``DynConfig.from_flat``."""
    return to_numpy(dyn.flat())


# ---------------------------------------------------------------------------
# Seeded simulator state
# ---------------------------------------------------------------------------

QUANTUM_T0 = 320


def random_quantum_inputs(rng, scfg, ragged=False):
    """Seeded inputs of one SM quantum at the clock ``QUANTUM_T0``:
    (warp, sm, req, stats_sm, trace) as numpy, every leaf randomized for
    ``scfg``'s shapes, with CTA barriers (every warp of the first CTA waits
    on half the SMs), warm L1s holding the addresses the warps are about to
    touch, partly filled address sets, and 0 to 2 free MSHR rows per SM;
    ``ragged`` adds an ``instr_base`` offset.  The tests feed the same
    arrays to both packages."""
    t0 = QUANTUM_T0
    ns, w, sc = scfg.n_sm, scfg.warps_per_sm, scfg.n_subcores
    m, wpc = scfg.mshr_per_sm, 4
    n_ops = 40
    pre = int(rng.integers(1, 8)) if ragged else 0
    L = int(rng.integers(8, n_ops - pre + 1))
    ops = rng.choice(np.arange(N_CLASSES), n_ops,
                     p=[.25, .15, .05, .1, .2, .15, .1]).astype(np.int32)
    trace = {"ops": ops, "dep": rng.random(n_ops) < 0.5,
             "addr_mode": rng.integers(1, 4, n_ops).astype(np.int32),
             "addr_param": rng.integers(0, 4, n_ops).astype(np.int32),
             "n_ctas": np.int32(40), "warps_per_cta": np.int32(wpc),
             "n_instr": np.int32(L)}
    if ragged:
        trace["instr_base"] = np.int32(pre)
    cta = (np.arange(w) // wpc + rng.integers(0, 6, (ns, 1))).astype(
        np.int32)
    warp = {
        "pc": rng.integers(0, L + 1, (ns, w)).astype(np.int32),
        "active": rng.random((ns, w)) < 0.85,
        "ready_at": rng.integers(t0 - 8, t0 + 12, (ns, w)).astype(np.int32),
        "pending": rng.integers(0, 3, (ns, w)).astype(np.int32),
        "wait_mem": rng.random((ns, w)) < 0.3,
        "wait_bar": rng.random((ns, w)) < 0.2,
        "cta": cta,
        "wic": (np.arange(w) % wpc + np.zeros((ns, 1), int)).astype(
            np.int32),
    }
    # on half the SMs, every warp of the first CTA waits at the barrier
    warp["wait_bar"][::2, :wpc] = True
    # warm L1: the addresses the warps are about to touch, in random ways
    gwarp = warp["cta"] * wpc + warp["wic"]
    pcs = np.clip(warp["pc"] + rng.integers(0, 3, (ns, w)), 0, L - 1)
    addr = gen_address(*(torch.as_tensor(x) for x in (
        trace["addr_mode"][pre + pcs], trace["addr_param"][pre + pcs],
        gwarp, pcs)),
        scfg.mem_blocks).numpy()
    l1_tag = rng.integers(0, 1 << 20, (ns, scfg.l1_sets, scfg.l1_ways)
                          ).astype(np.int32)
    for s in range(ns):
        for a in addr[s][rng.random(w) < 0.5]:
            l1_tag[s, a % scfg.l1_sets, rng.integers(scfg.l1_ways)] = a
    cap = scfg.addrset_cap
    addrset = np.where(rng.random((ns, cap)) < rng.random(),
                       rng.integers(0, 1 << 20, (ns, cap)), -1
                       ).astype(np.int32)
    sm = {
        "last_issued": rng.integers(-1, w, (ns, sc)).astype(np.int32),
        "unit_free": rng.integers(t0 - 4, t0 + 6, (ns, sc, N_UNITS)
                                  ).astype(np.int32),
        "l1_tag": l1_tag,
        "l1_lru": rng.integers(0, t0, l1_tag.shape).astype(np.int32),
        "addrset": addrset,
        "addrset_over": rng.integers(0, 3, ns).astype(np.int32),
    }
    # busy MSHRs: per SM 0..2 free rows at the start
    stage = rng.integers(1, 4, (ns, m)).astype(np.int32)
    for s in range(ns):
        stage[s, rng.permutation(m)[:rng.integers(0, 3)]] = 0
    req = {
        "stage": stage,
        "addr": rng.integers(0, 1 << 20, (ns, m)).astype(np.int32),
        "t": rng.integers(t0 - 4, t0 + 24, (ns, m)).astype(np.int32),
        "warp": rng.integers(0, w, (ns, m)).astype(np.int32),
        "is_store": rng.random((ns, m)) < 0.3,
    }
    stats_sm = {k: rng.integers(0, 50, ns).astype(np.int32) for k in (
        "issued", "issued_mem", "l1_hit", "l1_miss", "cycles_issue",
        "stall", "warp_cycles")}
    return warp, sm, req, stats_sm, trace


def random_lane_inputs(rng, scfg, n_lanes, ragged=False):
    """Seeded inputs of one SM quantum for ``n_lanes`` lanes, each lane
    its own: a state and trace from ``random_quantum_inputs`` (its own
    ``instr_base`` when ``ragged``), a clock ``t0`` moved 7 cycles further
    per lane (every time stamp of its state moved with it), and a dynamic
    config (scheduler, L1 hit and interconnect latencies, per-class
    tables).  Returns ((warp, sm, req, stats_sm, trace) with a leading
    lane axis, as numpy; t0 (n_lanes,) int32; per-lane flat dynamic
    overrides for ``split_config``)."""
    lanes, t0s, dyns = [], [], []
    for lane in range(n_lanes):
        warp, sm, req, stats, trace = random_quantum_inputs(rng, scfg,
                                                            ragged=ragged)
        shift = 7 * lane
        warp = dict(warp, ready_at=warp["ready_at"] + shift)
        sm = dict(sm, unit_free=sm["unit_free"] + shift,
                  l1_lru=sm["l1_lru"] + shift)
        req = dict(req, t=req["t"] + shift)
        lanes.append((warp, sm, req, stats, trace))
        t0s.append(QUANTUM_T0 + shift)
        dyns.append({
            "sched": int(rng.integers(0, 2)),
            "l1_hit_lat": int(rng.integers(8, 40)),
            "icnt_lat": int(rng.integers(scfg.quantum, 2 * scfg.quantum)),
            "lat": tuple(int(v) for v in rng.integers(1, 24, N_CLASSES)),
            "disp": tuple(int(v) for v in rng.integers(1, 5, N_CLASSES))})
    stacked = tuple(stack_lanes([lane[i] for lane in lanes])
                    for i in range(5))
    return stacked, np.asarray(t0s, np.int32), dyns


# ---------------------------------------------------------------------------
# LM parameters and cache.  The JAX tree stacks each group's layers on a
# leading axis: params["groups"][g][...] has shape (n_layers_of_g, ...).
# ---------------------------------------------------------------------------

def _flatten(prefix: str, node, out: dict, take) -> None:
    if isinstance(node, dict):
        for k, v in node.items():
            _flatten(f"{prefix}.{k}" if prefix else k, v, out, take)
    else:
        out[prefix] = take(node)


def lm_params_to_torch(tree: dict, cfg: ArchConfig, device) -> dict:
    """The JAX package's LM parameter tree → the port's state dict
    (``repro_torch.models.lm.LM.state_dict()`` keys), on ``device``."""
    def copy(a):
        return torch.tensor(np.asarray(a), device=device)

    state: dict = {}
    for key, node in tree.items():
        if key != "groups":
            _flatten(key, node, state, copy)
    plan = lm.group_plan(cfg)
    if len(tree["groups"]) != len(plan):
        raise ValueError(f"{cfg.name}: {len(tree['groups'])} parameter "
                         f"groups, the plan has {len(plan)}")
    for g, (stacked, (_, count)) in enumerate(zip(tree["groups"], plan)):
        for i in range(count):
            _flatten(f"groups.{g}.{i}", stacked, state,
                     lambda a, i=i: copy(np.asarray(a)[i]))
    return state


def _leaf_groups(params: dict, cfg: ArchConfig) -> dict:
    """The port's parameters (or any dict keyed by parameter name, such as
    an AdamW moment) grouped by the JAX package's tree path: {path tuple:
    [tensor]} for a leaf outside the groups, {("groups", g, ...): [the
    layers' tensors in order]} for a group's stacked leaf."""
    plan = lm.group_plan(cfg)
    out: dict = {}
    layers: dict = {}
    for key, t in params.items():
        parts = key.split(".")
        if parts[0] != "groups":
            out[tuple(parts)] = [t]
            continue
        g, i = int(parts[1]), int(parts[2])
        if g >= len(plan):
            raise ValueError(f"{cfg.name}: parameter group {g}, the plan "
                             f"has {len(plan)}")
        layers.setdefault(("groups", g, *parts[3:]), {})[i] = t
    for path, by_layer in layers.items():
        count = plan[path[1]][1]
        if sorted(by_layer) != list(range(count)):
            raise ValueError(f"{cfg.name}: {'.'.join(map(str, path))} has "
                             f"layers {sorted(by_layer)}, the plan {count}")
        out[path] = [by_layer[i] for i in range(count)]
    return out


def _host(t) -> np.ndarray:
    """A tensor as a numpy array (bf16 as float32: numpy has no bf16)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _leaf_array(path: tuple, tensors: list) -> np.ndarray:
    if "groups" in path:                 # a group's layers, stacked
        return np.stack([_host(t) for t in tensors])
    return _host(tensors[0])


def _nest(items) -> dict:
    """((path tuple, value), ...) → nested dicts, the "groups" level a
    list."""
    tree: dict = {}
    for path, value in items:
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value
    for node in _walk_dicts(tree):
        if "groups" in node and isinstance(node["groups"], dict):
            node["groups"] = [node["groups"][g]
                              for g in range(len(node["groups"]))]
    return tree


def _walk_dicts(tree):
    yield tree
    for v in tree.values():
        if isinstance(v, dict):
            yield from _walk_dicts(v)


def lm_params_to_numpy(params: dict, cfg: ArchConfig) -> dict:
    """The port's parameters (a state dict, or any dict keyed by parameter
    name, such as an AdamW moment) → the JAX package's LM parameter tree:
    numpy leaves of the same dtype (bf16 as f32), each group's layers
    stacked on axis 0.  The inverse of ``lm_params_to_torch``."""
    return _nest((path, _leaf_array(path, ts))
                 for path, ts in _leaf_groups(params, cfg).items())


def _state_leaves(state: dict, cfg: ArchConfig) -> dict:
    """A port train state's tensors by the JAX package's train-state path
    ("params"/"opt", "m"/..., the parameter path)."""
    out = {("params", *p): ts for p, ts in _leaf_groups(
        state["params"].state_dict(), cfg).items()}
    for k in ("m", "v"):
        out.update({("opt", k, *p): ts for p, ts in
                    _leaf_groups(state["opt"][k], cfg).items()})
    return out


def train_state_arrays(state: dict, cfg: ArchConfig):
    """A port train state (``train.train_step.init_train_state``) as the
    JAX package's train-state leaves, one at a time: ("params/groups/0/
    attn/wq", numpy array with the layers stacked), ..., ("step", int32
    scalar).  A checkpoint writes them as they come, so the host holds one
    leaf at a time."""
    for path, ts in _state_leaves(state, cfg).items():
        yield "/".join(map(str, path)), _leaf_array(path, ts)
    yield "step", np.asarray(state["step"], np.int32)


def train_state_to_numpy(state: dict, cfg: ArchConfig) -> dict:
    """A port train state → the JAX package's train-state tree:
    {"params", "opt": {"m", "v"}, "step"}, each parameter tree in the
    reference's layout, step an int32 scalar."""
    def path(key):
        return tuple(int(p) if p.isdigit() else p for p in key.split("/"))
    return _nest((path(k), a) for k, a in train_state_arrays(state, cfg))


@torch.no_grad()
def load_train_state(arrays, state: dict, cfg: ArchConfig) -> dict:
    """Copy the JAX package's train-state leaves into the port train state
    ``state``, in place, in each tensor's dtype and device; returns
    ``state``.  ``arrays`` maps "params/groups/0/attn/wq"-style keys to
    arrays (an open ``.npz`` checkpoint, or a dict): each is read once,
    and a group's stacked leaf fills its layers' tensors."""
    for path, ts in _state_leaves(state, cfg).items():
        arr = np.asarray(arrays["/".join(map(str, path))])
        stacked = "groups" in path
        if arr.shape != ((len(ts),) if stacked else ()) + tuple(ts[0].shape):
            raise ValueError(f"{'/'.join(map(str, path))}: shape "
                             f"{arr.shape} does not fit the model")
        for i, t in enumerate(ts):
            t.copy_(torch.from_numpy(np.ascontiguousarray(
                arr[i] if stacked else arr)))
    state["step"] = int(np.asarray(arrays["step"]))
    return state


def lm_cache_to_torch(cache: dict, device) -> dict:
    """The JAX package's LM decode cache → the port's, on ``device``."""
    return {"len": to_torch(cache["len"], device),
            "groups": [to_torch(g, device) for g in cache["groups"]]}


def lm_cache_to_numpy(cache: dict) -> dict:
    """The port's LM decode cache → numpy arrays in the same layout."""
    return {"len": to_numpy(cache["len"]),
            "groups": [to_numpy(g) for g in cache["groups"]]}


def seeded_lm_params(cfg: ArchConfig, seed: int) -> dict:
    """Seeded weights in the JAX package's parameter layout (numpy f32
    leaves, layers stacked on axis 0), drawn with numpy's generator at the
    reference's init scales.  Needs no JAX: the CPU tests feed the tree
    to both packages, and the chip smoke feeds it to the port."""
    rng = np.random.default_rng(seed)

    def draw(shape, std):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                * np.float32(std))

    tree = lm.init_lm_tree(draw, cfg, torch.float32, "cpu")

    def stack(layers):
        if isinstance(layers[0], dict):
            return {k: stack([lay[k] for lay in layers]) for k in layers[0]}
        return np.stack([t.numpy() for t in layers])

    out = to_numpy({k: v for k, v in tree.items() if k != "groups"})
    out["groups"] = [stack(g) for g in tree["groups"]]
    return out


# leaves that the reference initialises to a constant: norm scales and
# biases, and the QKV biases
CONSTANT_LEAVES = ("scale", "bias", "bq", "bk", "bv")


def jitter_constant_leaves(tree, seed: int, std: float = 0.1):
    """A copy of a parameter tree (nested dicts and lists of numpy f32
    arrays, the JAX layout) with seeded N(0, std) noise added to every
    ``CONSTANT_LEAVES`` leaf, so that a comparison of two models exercises
    the paths that ones and zeros would hide.  Keys are visited in sorted
    order, so the same tree and seed give the same noise."""
    rng = np.random.default_rng(seed)

    def walk(node, name=""):
        if isinstance(node, list):
            return [walk(n) for n in node]
        if isinstance(node, dict):
            out = {k: walk(node[k], k) for k in sorted(node)}
            return {k: out[k] for k in node}
        if name not in CONSTANT_LEAVES:
            return node
        a = np.asarray(node, np.float32)
        return (a + std * rng.standard_normal(a.shape, dtype=np.float32))

    return walk(tree)


def params_fingerprint(tree) -> float:
    """Sum of |w| over the leaves of a parameter tree (dicts and lists of
    arrays or tensors), in float64: tells a change of numpy's random
    stream apart from a fault of the model when a golden result does not
    match."""
    if isinstance(tree, dict):
        return sum(params_fingerprint(tree[k]) for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return sum(params_fingerprint(v) for v in tree)
    if torch.is_tensor(tree):
        tree = tree.detach().cpu().numpy()
    return float(np.abs(np.asarray(tree, np.float64)).sum())
