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
from repro_torch.sim.config import DynConfig


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
