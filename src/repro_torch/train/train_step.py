"""Train-step construction, the JAX package's ``train/train_step.py``:
gradients of ``factory.train_loss`` by autograd, then AdamW.

A train state is {"params": the ``LM`` (trainable), "opt": {"m", "v"}
moments keyed by parameter name, "step": the count of steps taken}.  A
step updates the state in place and returns it with its metrics
(``loss``, ``ce``, ``aux``, ``grad_norm``, 0-d f32 tensors on the
model's device).

On CUDA a step runs under ``torch.use_deterministic_algorithms(True)``,
so that training is the same bits from run to run and a restart from a
checkpoint continues bit for bit (the reference's contract,
``repro/checkpointing/checkpoint.py``): the embedding's backward
(index_put with accumulate) would otherwise sum with atomics.  That
setting makes cuBLAS raise unless ``CUBLAS_WORKSPACE_CONFIG`` is
``:4096:8`` or ``:16:8`` before CUDA starts; the step raises first,
naming it.  The wkv6 and flash-attention kernels, forward and backward,
use no atomics.  Sharding (``ctx``) comes with slice 11d.
"""
from __future__ import annotations

import os
from contextlib import contextmanager

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import factory
from repro_torch.models.lm import LM
from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                         init_opt_state)

CUBLAS_CONFIGS = (":4096:8", ":16:8")


def init_train_state(model, cfg: ArchConfig, opt_cfg: OptConfig,
                     dtype=torch.float32, *, device=None) -> dict:
    """A train state over ``model``, an ``LM`` (made trainable here), or
    over fresh weights ``factory.init_params(model, cfg, ...)`` when it is
    an int seed; zero moments and step 0."""
    if not isinstance(model, LM):
        model = factory.init_params(model, cfg, dtype, device=device)
    model.requires_grad_(True)
    return {"params": model,
            "opt": init_opt_state(dict(model.named_parameters()), opt_cfg),
            "step": 0}


@contextmanager
def deterministic(device: torch.device):
    """Deterministic kernels for the duration, on a CUDA device; nothing
    on the CPU, whose kernels are."""
    if device.type != "cuda":
        yield
        return
    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") not in CUBLAS_CONFIGS:
        raise RuntimeError(
            "training on CUDA runs with deterministic kernels, which need "
            "CUBLAS_WORKSPACE_CONFIG=:4096:8 (or :16:8) in the environment "
            "before CUDA starts")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def _grads(model: LM, batch: dict, cfg: ArchConfig):
    """(loss, metrics, {name: grad}) of one batch."""
    params = dict(model.named_parameters())
    loss, metrics = factory.train_loss(model, batch, cfg=cfg)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return loss, metrics, {n: torch.zeros_like(p) if g is None else g
                           for (n, p), g in zip(params.items(), grads)}


def make_train_step(cfg: ArchConfig, opt_cfg: OptConfig,
                    accum_steps: int = 1):
    """train_step(state, batch) -> (state, metrics).  accum_steps > 1
    splits the batch's leading axis into that many microbatches and sums
    their f32 gradients before one update (the metrics are the last
    microbatch's, as the reference's scan carries them)."""
    def train_step(state: dict, batch: dict):
        model = state["params"]
        device = next(model.parameters()).device
        with deterministic(device):
            if accum_steps == 1:
                _, metrics, grads = _grads(model, batch, cfg)
            else:
                grads = None
                for i in range(accum_steps):
                    mb = {k: x.reshape((accum_steps, x.shape[0] // accum_steps)
                                       + tuple(x.shape[1:]))[i]
                          for k, x in batch.items()}
                    _, metrics, g = _grads(model, mb, cfg)
                    if grads is None:
                        grads = {n: x.float() for n, x in g.items()}
                    else:
                        for n, x in g.items():
                            grads[n].add_(x.float())
                grads = {n: x / accum_steps for n, x in grads.items()}
            _, _, gnorm = adamw_update(grads, state["opt"],
                                       dict(model.named_parameters()),
                                       opt_cfg, state["step"])
        state["step"] += 1
        metrics = {k: x.detach() for k, x in metrics.items()}
        return state, dict(metrics, grad_norm=gnorm)

    return train_step


def make_eval_step(cfg: ArchConfig):
    """eval_step(model, batch) -> metrics, with no graph recorded."""
    @torch.no_grad()
    def eval_step(model: LM, batch: dict):
        _, metrics = factory.train_loss(model, batch, cfg=cfg)
        return metrics
    return eval_step
