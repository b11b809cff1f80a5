"""Train-step construction, the JAX package's ``train/train_step.py``:
gradients of ``factory.train_loss`` by autograd, then AdamW.

A train state is {"params": the ``LM`` or ``Whisper`` (trainable),
"opt": {"m", "v"} moments keyed by parameter name, "step": the count of
steps taken}.  A step updates the state in place and returns it with
its metrics (``loss``, ``ce``, ``aux``, ``grad_norm``, 0-d f32 tensors
on the model's device).

On CUDA a step runs under ``torch.use_deterministic_algorithms(True)``,
so that training is the same bits from run to run and a restart from a
checkpoint continues bit for bit (the reference's contract,
``repro/checkpointing/checkpoint.py``): the embedding's backward
(index_put with accumulate) would otherwise sum with atomics.  That
setting makes cuBLAS raise unless ``CUBLAS_WORKSPACE_CONFIG`` is
``:4096:8`` or ``:16:8`` before CUDA starts; the step raises first,
naming it.  The wkv6 and flash-attention kernels, forward and backward,
use no atomics; the MoE layer's dispatch and combine are gathers, whose
backward sums PyTorch then orders deterministically; Mamba's scan is
products, sums and concatenations, whose backward has no scatter, and
Whisper's learned positions are read by slices (prefill, training).

With a ``ctx`` over a mesh (``launch/mesh.py:make_ctx``) the step is the
reference's sharded step on the mesh's data axes, single-controller: one
process drives every position, and a mesh may repeat one card.

  · The batch (each microbatch, under ``accum_steps``) is split by
    ``batch_pspecs``: each data position runs the forward of its
    contiguous rows on its device, the MoE layers with one token group
    each, which is the reference's group of those rows.  A batch whose
    rows the positions do not divide is replicated by the reference's
    specs; it runs once, on the first position, the MoE layers with the
    reference's groups of the global token count (``moe.moe_groups``).
    So does a batch whose MoE layers take one group (fewer tokens than
    dp · top_k): its dispatch spans the positions.
  · The positions' CE sums and counts, and each MoE layer's router
    statistics, are summed in position order on the first position's
    device (``factory.combine_parts``), and one backward gives the
    gradient.  Positions on one device share its parameters, and
    autograd sums their gradients; gradients on other devices are copied
    to the first and summed in device order.
  · The update: the global norm and the clip factor come from the whole
    gradient; AdamW runs on each ZeRO-1 block of the moments
    (``moments_pspecs``), and the parameters' matching slice, once per
    device that stores it; a device then copies the blocks it does not
    hold from their holder.  On a mesh that repeats one card, the blocks
    are views of one copy of each moment and parameter, and nothing is
    copied.
  · A sharded state adds {"ctx", "specs": the moments' specs,
    "replicas": {device: the model there}} (the first device's is
    "params"); its moments are ``sharding.Shards``.  ``plain_state``
    gathers it for a checkpoint, and ``scatter_state`` puts a restored one
    back.

A ctx with a model axis of size > 1 raises NotImplementedError: tensor
parallelism is slice 11d.5b.
"""
from __future__ import annotations

import os
from contextlib import contextmanager

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import factory
from repro_torch.models.layers.moe import moe_groups
from repro_torch.parallelism import sharding
from repro_torch.parallelism.ctx import NULL_CTX, ShardCtx
from repro_torch.train.optimizer import (OptConfig, adamw_leaf, adamw_update,
                                         clip_scale, global_norm,
                                         init_opt_state, scaled,
                                         step_constants)

CUBLAS_CONFIGS = (":4096:8", ":16:8")


def _check_ctx(ctx: ShardCtx) -> None:
    if ctx.tp_size > 1:
        raise NotImplementedError(
            f"a ctx with a model axis of size {ctx.tp_size}: tensor "
            "parallelism is ROADMAP slice 11d.5b; the sharded step covers "
            "the data axes (a model axis of size 1)")


def init_train_state(model, cfg: ArchConfig, opt_cfg: OptConfig,
                     dtype=torch.float32, *, device=None,
                     ctx: ShardCtx = NULL_CTX) -> dict:
    """A train state over ``model``, an ``LM`` or a ``Whisper`` (made
    trainable here), or over fresh weights ``factory.init_params(model,
    cfg, ...)`` when it is an int seed; zero moments and step 0.  With a
    mesh ``ctx`` the model lives on the mesh's first device (fresh
    weights are drawn there), a replica on each other distinct device,
    and the moments are placed by ``moments_pspecs``."""
    if ctx.mesh is None:
        if not isinstance(model, nn.Module):
            model = factory.init_params(model, cfg, dtype, device=device)
        model.requires_grad_(True)
        return {"params": model,
                "opt": init_opt_state(dict(model.named_parameters()),
                                      opt_cfg),
                "step": 0}
    _check_ctx(ctx)
    mesh = ctx.mesh
    home = mesh.devices.flat[0]
    if device is not None and torch.device(device) != home:
        raise ValueError(f"device={device!r}: a sharded state lives on its "
                         f"mesh's first device, {home}")
    if not isinstance(model, nn.Module):
        model = factory.init_params(model, cfg, dtype, device=home)
    if next(model.parameters()).device != home:
        raise ValueError(f"the model is on {next(model.parameters()).device}"
                         f", the mesh's first device is {home}")
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    specs = sharding.moments_pspecs(
        sharding.param_pspecs(params, cfg, ctx), params, ctx)
    replicas = {home: model}
    for dev in dict.fromkeys(mesh.devices.flat):
        if dev not in replicas:
            replicas[dev] = factory.from_state_dict(cfg, {
                k: v.detach().to(dev, copy=True)
                for k, v in model.state_dict().items()}).requires_grad_(True)
    plain = init_opt_state(params, opt_cfg)
    return {"params": model,
            "opt": {k: sharding.shard_tree(plain[k], specs, mesh)
                    for k in ("m", "v")},
            "step": 0, "ctx": ctx, "specs": specs, "replicas": replicas}


def plain_state(state: dict) -> dict:
    """A train state as ``init_train_state`` without a mesh makes it:
    a sharded state's moments gathered on its first device (the stored
    tensors themselves where that device holds them whole); any other
    state as it is."""
    if "ctx" not in state:
        return state
    mesh = state["ctx"].mesh
    return {"params": state["params"],
            "opt": {k: sharding.gather_tree(state["opt"][k], state["specs"],
                                            mesh) for k in ("m", "v")},
            "step": state["step"]}


@torch.no_grad()
def scatter_state(plain: dict, state: dict) -> dict:
    """Put ``plain`` (``plain_state(state)``, filled by a restore) back
    into the sharded ``state``: each device's moment blocks and
    parameter replica, and the step.  Returns ``state``."""
    if plain is state:
        return state
    for k in ("m", "v"):
        for name, sh in state["opt"][k].items():
            whole = plain["opt"][k][name]
            for dev, items in sh.stores.items():
                if dev in sh.wholes:
                    if sh.wholes[dev] is not whole:
                        sh.wholes[dev].copy_(whole)
                    continue
                for blk, t in items:
                    t.copy_(whole[sharding.index_of(blk)])
    home = dict(state["params"].named_parameters())
    for model in state["replicas"].values():
        if model is not state["params"]:
            for n, p in model.named_parameters():
                p.copy_(home[n])
    state["step"] = plain["step"]
    return state


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


def _grads_of(loss, models: list):
    """{name: gradient} of ``loss`` over the parameters of ``models``
    (one model, or its replicas), each on the first model's device:
    another replica's gradient is copied there and added, in order."""
    named = [dict(m.named_parameters()) for m in models]
    flat = [p for ps in named for p in ps.values()]
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    home = flat[0].device
    out, k = {}, len(named[0])
    for j, (n, p) in enumerate(named[0].items()):
        acc = None
        for r in range(len(models)):
            g = grads[r * k + j]
            if g is not None:
                g = g.to(home)
                acc = g if acc is None else acc + g
        out[n] = torch.zeros_like(p) if acc is None else acc
    return out


def _position_parts(state: dict, batch: dict, cfg: ArchConfig,
                    ctx: ShardCtx) -> list:
    """``factory.loss_parts`` of one (micro)batch on a mesh: of each data
    position's rows on its device, or of the whole batch on the first
    position (see the module's docstring for which)."""
    mesh, replicas = ctx.mesh, state["replicas"]
    devs = list(mesh.devices.flat)
    b, s = batch["labels"].shape
    dp = ctx.dp_size
    groups = 1 if cfg.moe is None else moe_groups(dp, b * s, cfg.moe.top_k)
    if b % dp or (cfg.moe is not None and groups != dp):
        whole = {k: x.to(devs[0]) for k, x in batch.items()}
        return [factory.loss_parts(replicas[devs[0]], whole, cfg=cfg,
                                   moe_groups=groups)]
    shards = sharding.shard_tree(batch, sharding.batch_pspecs(batch, ctx),
                                 mesh)
    return [factory.loss_parts(replicas[dev],
                               {k: sh.blocks[p] for k, sh in shards.items()},
                               cfg=cfg)
            for p, dev in enumerate(devs)]


def _grads(model: nn.Module, batch: dict, cfg: ArchConfig):
    """(loss, metrics, {name: grad}) of one batch."""
    loss, metrics = factory.train_loss(model, batch, cfg=cfg)
    return loss, metrics, _grads_of(loss, [model])


def _step_grads(state: dict, batch: dict, cfg: ArchConfig, ctx: ShardCtx):
    """(metrics, {name: grad}) of one batch, on the model's device."""
    if ctx.mesh is None:
        _, metrics, grads = _grads(state["params"], batch, cfg)
        return metrics, grads
    loss, metrics = factory.combine_parts(
        _position_parts(state, batch, cfg, ctx), cfg=cfg)
    return metrics, _grads_of(loss, list(state["replicas"].values()))


@torch.no_grad()
def _zero1_update(grads: dict, state: dict, opt_cfg: OptConfig):
    """AdamW on a sharded state, block by block (see the module's
    docstring); returns the gradients' global norm."""
    gnorm = global_norm(grads)
    scale = clip_scale(opt_cfg, gnorm)
    consts = step_constants(opt_cfg, state["step"])
    params = {dev: dict(m.named_parameters())
              for dev, m in state["replicas"].items()}
    for name, g in grads.items():
        g = scaled(g, scale)
        ms, vs = state["opt"]["m"][name], state["opt"]["v"][name]
        holder = {}
        for dev, items in ms.stores.items():
            p = params[dev][name].detach()
            for (blk, m), (_, v) in zip(items, vs.stores[dev]):
                idx = sharding.index_of(blk)
                adamw_leaf(name, p[idx], g[idx].to(dev), m, v, opt_cfg,
                           consts)
                holder.setdefault(blk, dev)
        for dev, ps in params.items():       # the blocks a device lacks
            held = {blk for blk, _ in ms.stores.get(dev, [])}
            for blk, src in holder.items():
                if blk not in held:
                    idx = sharding.index_of(blk)
                    ps[name].detach()[idx].copy_(
                        params[src][name].detach()[idx])
    return gnorm


def _microbatches(batch: dict, accum_steps: int):
    """The reference's split: the leading axis into accum_steps
    consecutive microbatches."""
    if accum_steps == 1:
        yield batch
        return
    for i in range(accum_steps):
        yield {k: x.reshape((accum_steps, x.shape[0] // accum_steps)
                            + tuple(x.shape[1:]))[i] for k, x in batch.items()}


def make_train_step(cfg: ArchConfig, opt_cfg: OptConfig,
                    ctx: ShardCtx = NULL_CTX, accum_steps: int = 1):
    """train_step(state, batch) -> (state, metrics).  accum_steps > 1
    splits the batch's leading axis into that many microbatches and sums
    their f32 gradients before one update (the metrics are the last
    microbatch's, as the reference's scan carries them).  With a mesh
    ``ctx`` it takes a state that ``init_train_state(..., ctx=ctx)``
    made."""
    _check_ctx(ctx)

    def train_step(state: dict, batch: dict):
        model = state["params"]
        device = next(model.parameters()).device
        if (ctx.mesh is not None) != ("ctx" in state):
            raise ValueError("the train state was not made for this step's "
                             "ctx: pass the same ctx to init_train_state")
        with deterministic(device):
            grads = None
            for mb in _microbatches(batch, accum_steps):
                metrics, g = _step_grads(state, mb, cfg, ctx)
                if accum_steps == 1:
                    grads = g
                elif grads is None:
                    grads = {n: x.float() for n, x in g.items()}
                else:
                    for n, x in g.items():
                        grads[n].add_(x.float())
            if accum_steps > 1:
                grads = {n: x / accum_steps for n, x in grads.items()}
            if ctx.mesh is None:
                _, _, gnorm = adamw_update(grads, state["opt"],
                                           dict(model.named_parameters()),
                                           opt_cfg, state["step"])
            else:
                gnorm = _zero1_update(grads, state, opt_cfg)
        state["step"] += 1
        metrics = {k: x.detach() for k, x in metrics.items()}
        return state, dict(metrics, grad_norm=gnorm)

    return train_step


def make_eval_step(cfg: ArchConfig):
    """eval_step(model, batch) -> metrics, with no graph recorded."""
    @torch.no_grad()
    def eval_step(model: nn.Module, batch: dict):
        _, metrics = factory.train_loss(model, batch, cfg=cfg)
        return metrics
    return eval_step
