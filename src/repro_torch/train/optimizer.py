"""AdamW with global-norm clipping and a warmup + cosine schedule, the JAX
package's ``train/optimizer.py``.

Parameters, gradients and moments are flat dicts keyed by the model's
parameter names (``groups.0.3.tm.mu_x``); the last part of a name is the
reference's leaf name, which the decay mask reads.  Moments may be stored
in bf16; the update maths always runs in f32, in the reference's order of
operations.  The update works in place, where the reference returns new
arrays: parameters and moments are overwritten and the gradients are
scaled by the clip factor, so a step at full width holds one copy of each.
The update is elementwise past the global norm, so ``adamw_leaf`` may
run on any slice of a parameter: the sharded train step updates each
ZeRO-1 block of the moments, and the parameter's matching slice, on its
own (train/train_step.py), with the same bits as a whole update.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"   # 'float32' | 'bfloat16'


_F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=_F32)


def lr_schedule(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (int or tensor), a 0-d f32 tensor on
    the CPU: linear warmup from 0, then a cosine down to min_lr_ratio of
    the peak."""
    step = _f32(float(step))
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def moment_dtype(cfg: OptConfig) -> torch.dtype:
    return {"float32": torch.float32,
            "bfloat16": torch.bfloat16}[cfg.moment_dtype]


def init_opt_state(params: dict, cfg: OptConfig) -> dict:
    """Zero first and second moments beside each parameter, in
    ``cfg.moment_dtype``."""
    dt = moment_dtype(cfg)
    return {name: {n: torch.zeros(p.shape, dtype=dt, device=p.device)
                   for n, p in params.items()} for name in ("m", "v")}


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(torch.stack([torch.sum(torch.square(g.to(_F32)))
                                   for g in tree.values()]).sum())


_NO_DECAY = ("scale", "bias", "mu_x", "mu", "mu_k", "mu_r", "w0", "u",
             "gn_scale", "gn_bias", "dt_bias", "conv_b", "D")


def _decay_mask(name: str) -> bool:
    """No weight decay for norms / biases / 1-d params: keyed on the leaf
    name, the last part of the parameter's name."""
    return name.rsplit(".", 1)[-1] not in _NO_DECAY


def clip_scale(cfg: OptConfig, gnorm) -> torch.Tensor:
    """The factor that clips a gradient of global norm ``gnorm``."""
    return torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                       max=1.0)


def scaled(g, scale) -> torch.Tensor:
    """A gradient times the clip factor, in f32: in place where it is f32
    already."""
    return g.mul_(scale) if g.dtype == _F32 else g.to(_F32).mul_(scale)


def step_constants(cfg: OptConfig, step) -> tuple[float, float, float]:
    """(learning rate, first and second bias corrections) of ``step``."""
    t = _f32(float(step) + 1.0)
    return (float(lr_schedule(cfg, step)),
            float(1.0 - torch.pow(_f32(cfg.b1), t)),
            float(1.0 - torch.pow(_f32(cfg.b2), t)))


@torch.no_grad()
def adamw_leaf(name: str, p, g, m, v, cfg: OptConfig,
               consts: tuple[float, float, float]) -> None:
    """AdamW on one parameter (or a slice of one), in place: ``g`` its
    clipped f32 gradient, ``m`` and ``v`` its moments, ``consts`` from
    ``step_constants``; ``name`` the parameter's, for the decay mask."""
    lr, c1, c2 = consts
    m32 = m if m.dtype == _F32 else m.to(_F32)
    v32 = v if v.dtype == _F32 else v.to(_F32)
    m32.mul_(cfg.b1).add_((1 - cfg.b1) * g)
    v32.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
    delta = torch.sqrt(v32 / c2).add_(cfg.eps)
    delta = torch.div(m32 / c1, delta)
    if _decay_mask(name):
        delta.add_(cfg.weight_decay * p.to(_F32))
    delta.mul_(lr)
    if p.dtype == _F32:
        p.sub_(delta)
    else:
        p.copy_(p.to(_F32) - delta)
    if m32 is not m:
        m.copy_(m32)
        v.copy_(v32)


@torch.no_grad()
def adamw_update(grads: dict, opt: dict, params: dict, cfg: OptConfig,
                 step):
    """One AdamW step at ``step`` (the count of steps taken so far).
    Returns (params, opt, gnorm): the same dicts, updated in place, and
    the gradients' global norm before clipping.  ``grads`` is consumed:
    each is scaled by the clip factor in place."""
    gnorm = global_norm(grads)
    scale = clip_scale(cfg, gnorm)
    consts = step_constants(cfg, step)
    for name, p in params.items():
        adamw_leaf(name, p, scaled(grads[name], scale), opt["m"][name],
                   opt["v"][name], cfg, consts)
    return params, opt, gnorm
