"""Shared layer primitives: norms.  Params: {'scale': (d,)} (+ {'bias':
(d,)} for layernorm), as in the JAX package's ``models/layers/common.py``;
the sinusoidal position table; and ``ParamDict``, the module that holds
a leaf dict of parameters."""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch import nn


class ParamDict(nn.Module):
    """A module whose parameters are a dict of tensors, named as the
    leaves of the JAX package's parameter tree; a nested dict (an MLA
    norm, an MoE layer's shared FFN) becomes a child ``ParamDict`` of its
    key; a leaf that is already a parameter is registered as it is (the
    sharded train step's replicas share the placed tensors).  Serving
    needs no gradients, so the others are frozen;
    ``train.train_step.init_train_state`` makes a model trainable with
    ``model.requires_grad_(True)``."""

    def __init__(self, params: dict):
        super().__init__()
        for name, t in params.items():
            if isinstance(t, dict):
                self.add_module(name, ParamDict(t))
            elif isinstance(t, nn.Parameter):     # shared, as it is
                self.register_parameter(name, t)
            else:
                self.register_parameter(
                    name, nn.Parameter(t, requires_grad=False))

    @property
    def p(self) -> dict:
        """The parameters as the reference's (nested) dict."""
        out = dict(self.named_parameters(recurse=False))
        out.update((name, child.p) for name, child in self.named_children())
        return out


def nest_state_dict(state: dict) -> dict:
    """A state dict's dotted keys as nested dicts: {"a.b.c": t} ->
    {"a": {"b": {"c": t}}} (a module list's entries keyed "0", "1", ...)."""
    tree: dict = {}
    for key, t in state.items():
        node = tree
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t
    return tree


def init_norm(kind: str, d: int, dtype=torch.float32, device=None) -> dict:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def apply_norm(params: dict, x, *, kind: str, eps: float = 1e-5):
    """RMS or layer norm over the last axis, computed in f32 and cast
    back to ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    if kind == "rmsnorm":
        x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    else:
        mu = torch.mean(x, dim=-1, keepdim=True)
        var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
        x = (x - mu) * torch.rsqrt(var + eps)
    x = x * params["scale"].float()
    if "bias" in params:
        x = x + params["bias"].float()
    return x.to(dt)


def group_norm_heads(x, scale, bias, *, eps: float = 64e-5):
    """Per-head group norm (RWKV wkv output). x: (..., H, hs)."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    x = x * scale.float() + bias.float()
    return x.to(dt)


@lru_cache(maxsize=8)
def _sinusoid_table(length: int, dim: int) -> np.ndarray:
    pos = np.arange(length)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / dim)
    table = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    table.flags.writeable = False
    return table


def sinusoidal_embedding(length: int, dim: int, dtype=torch.float32,
                         device=None):
    """(length, dim) table [sin | cos] of position / 10000^(2i/dim),
    computed in float64 with numpy and cast last, as the reference's."""
    return torch.from_numpy(np.array(_sinusoid_table(length, dim))).to(
        device=device, dtype=dtype)
