"""Shared layer primitives: norms.  Params: {'scale': (d,)} (+ {'bias':
(d,)} for layernorm), as in the JAX package's ``models/layers/common.py``;
and ``ParamDict``, the module that holds a leaf dict of parameters."""
from __future__ import annotations

import torch
from torch import nn


class ParamDict(nn.Module):
    """A module whose parameters are a flat dict of tensors, named as the
    leaves of the JAX package's parameter tree.  Serving needs no
    gradients, so they are frozen; ``train.train_step.init_train_state``
    makes a model trainable with ``model.requires_grad_(True)``."""

    def __init__(self, params: dict):
        super().__init__()
        for name, t in params.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))

    @property
    def p(self) -> dict:
        return dict(self.named_parameters(recurse=False))


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
