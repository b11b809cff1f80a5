"""Carry-across functions between the JAX package's data and the port's.

The JAX package's state pytree, packed kernels and ``DynConfig`` reach
this module as numpy arrays (``numpy.asarray`` of each leaf, nested dicts
kept); these functions turn them into the port's tensors on a device, and
back.  Dtypes carry over unchanged (int32 stays int32, bool stays bool),
so identical seeded inputs can be fed to both packages and their outputs
compared bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

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
