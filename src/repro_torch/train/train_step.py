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
reference's sharded step, single-controller: one process drives every
position, and a mesh may repeat one card.

  · The parameters are placed by the model-axis entries of
    ``param_pspecs`` (``sharding.place_params``): a device stores each
    parameter it holds every block of whole, once, and of a parameter
    the model axis splits only its positions' blocks.  Each stored
    tensor is a leaf of autograd.
  · The batch (each microbatch, under ``accum_steps``) is split by
    ``batch_pspecs``: each data position runs the forward of its
    contiguous rows on its device, the MoE layers with one token group
    each, which is the reference's group of those rows.  A batch whose
    rows the positions do not divide is replicated by the reference's
    specs; it runs once, on the first data position, the MoE layers with
    the reference's groups of the global token count
    (``moe.moe_groups``).  So does a batch whose MoE layers take one
    group (fewer tokens than dp · top_k): its dispatch spans the
    positions.
  · A model axis of 1: each data position runs its device's replica of
    the model, a module over the stored tensors.  A model axis of tp > 1
    (the ``rwkv`` and ``std:dense`` families whose heads it splits; the
    rest raises NotImplementedError naming slice 11d.5b.2): each data
    position's rows go through each layer once per model position of its
    row of the mesh (``lm.ModelGroup``), each on its block of every split
    parameter (``sharding.param_blocks``, views taken in the forward so
    that the gradient reaches the stored tensor): attention on its
    heads, the FFN on its d_ff columns, RWKV's time mix on its heads and
    its channel mix on its d_ff columns, the embedding on its d_model
    columns and the cross-entropy on its vocab columns.  The row-split
    partials are added in model-position order
    (``parallelism/tensor.py``).  A leaf the model axis replicates (the
    norms, RWKV's token shift and decay LoRA, an FFN whose d_ff it does
    not divide) runs once per data position, on its first position.
  · The positions' CE sums and counts, and each MoE layer's router
    statistics, are summed in data-position order on the first device
    (``factory.combine_parts``), and one backward gives the gradient.
    Positions on one device share its stored tensors, and autograd sums
    their gradients; each parameter's gradient is then made whole on the
    first device, its stored tensors' gradients added in device order
    (``_grads_of``).
  · The update: the global norm and the clip factor come from the whole
    gradient; AdamW runs on each ZeRO-1 block of the moments
    (``moments_pspecs``: the parameter's model-axis split, and the data
    axes on a free dimension), and the parameters' matching slice, once
    per device that stores it; a device then copies the blocks it stores
    but did not update from their holder.  On a mesh that repeats one
    card, the blocks are views of one copy of each moment and parameter,
    and nothing is copied.
  · A sharded state adds {"ctx", "cfg", "specs": the moments' specs,
    "placed": {name: ``sharding.Shards``} of the parameters, "replicas":
    {device: the model there} for a model axis of 1}; its moments are
    ``sharding.Shards``.  Its "params" is the model on the first device
    where that device stores every parameter whole (every mesh that
    repeats one card), else None.  ``plain_state`` gathers it for a
    checkpoint, and ``scatter_state`` puts a restored one back.
"""
from __future__ import annotations

import os
from contextlib import contextmanager

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import factory, lm
from repro_torch.models.layers.attention import head_axes
from repro_torch.models.layers.moe import moe_groups
from repro_torch.parallelism import sharding
from repro_torch.parallelism.ctx import NULL_CTX, ShardCtx
from repro_torch.train.optimizer import (OptConfig, adamw_leaf, adamw_update,
                                         clip_scale, global_norm,
                                         init_opt_state, scaled,
                                         step_constants)

CUBLAS_CONFIGS = (":4096:8", ":16:8")


def _check_ctx(ctx: ShardCtx, cfg: ArchConfig) -> None:
    """Raise NotImplementedError for a model axis of size > 1 that this
    port does not split yet (ROADMAP slice 11d.5b.2)."""
    tp = ctx.tp_size
    if tp == 1:
        return
    kinds = set() if cfg.enc_dec else {k for k, _ in lm.group_plan(cfg)}
    what = None
    if cfg.enc_dec:
        what = "Whisper's encoder-decoder"
    elif "period" in kinds:
        what = "jamba's period (Mamba's d_inner split)"
    elif kinds & {"std:moe", "mla:moe"}:
        what = "the MoE layers (expert placement by ctx.ep_axes)"
    elif kinds & {"mla:dense"}:
        what = "MLA's head split"
    elif kinds == {"rwkv"}:
        if cfg.d_model % (tp * cfg.rwkv.head_size):
            what = (f"RWKV-6's d_model {cfg.d_model}, which a model axis of "
                    f"{tp} does not split into whole heads of "
                    f"{cfg.rwkv.head_size}")
    else:
        h_ax, hd_ax = head_axes(ctx, cfg.n_heads, cfg.resolved_head_dim)
        if hd_ax is not None:
            what = ("a head_dim split (sequence-parallel attention through "
                    "K3')")
        elif h_ax is None:
            what = "attention whose heads the model axis does not split"
    if what is None and cfg.tie_embeddings:
        what = "a head tied to the embedding"
    if what is not None:
        raise NotImplementedError(
            f"{cfg.name} on a model axis of size {tp}: {what} is ROADMAP "
            "slice 11d.5b.2; the model axis is ported for the rwkv and "
            "std:dense families whose heads it splits")


def init_train_state(model, cfg: ArchConfig, opt_cfg: OptConfig,
                     dtype=torch.float32, *, device=None,
                     ctx: ShardCtx = NULL_CTX) -> dict:
    """A train state over ``model``, an ``LM`` or a ``Whisper`` (made
    trainable here), or over fresh weights ``factory.init_params(model,
    cfg, ...)`` when it is an int seed; zero moments and step 0.  With a
    mesh ``ctx`` the model is made on the mesh's first device (fresh
    weights are drawn there), its parameters are placed by
    ``param_pspecs`` (``sharding.place_params``) and the moments by
    ``moments_pspecs``."""
    if ctx.mesh is None:
        if not isinstance(model, nn.Module):
            model = factory.init_params(model, cfg, dtype, device=device)
        model.requires_grad_(True)
        return {"params": model,
                "opt": init_opt_state(dict(model.named_parameters()),
                                      opt_cfg),
                "step": 0}
    _check_ctx(ctx, cfg)
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
    pspecs = sharding.param_pspecs(params, cfg, ctx)
    specs = sharding.moments_pspecs(pspecs, params, ctx)
    placed = sharding.place_params(params, pspecs, mesh)
    replicas = {}
    if ctx.tp_size == 1:
        for dev in dict.fromkeys(mesh.devices.flat):
            replicas[dev] = model if dev == home else factory.from_state_dict(
                cfg, {n: sh.wholes[dev] for n, sh in placed.items()})
    plain = init_opt_state(params, opt_cfg)
    whole = all(home in sh.wholes for sh in placed.values())
    return {"params": model if whole else None,
            "opt": {k: sharding.shard_tree(plain[k], specs, mesh)
                    for k in ("m", "v")},
            "step": 0, "ctx": ctx, "cfg": cfg, "specs": specs,
            "placed": placed, "replicas": replicas}


@torch.no_grad()
def plain_state(state: dict) -> dict:
    """A train state as ``init_train_state`` without a mesh makes it:
    a sharded state's moments gathered on its first device (the stored
    tensors themselves where that device holds them whole), and its
    parameters likewise (its model, where that device holds every
    parameter whole; else a model made of the gathered parameters); any
    other state as it is."""
    if "ctx" not in state:
        return state
    mesh = state["ctx"].mesh
    model = state["params"]
    if model is None:
        placed = state["placed"]
        model = factory.from_state_dict(state["cfg"], sharding.gather_tree(
            placed, {n: sh.spec for n, sh in placed.items()}, mesh))
    return {"params": model,
            "opt": {k: sharding.gather_tree(state["opt"][k], state["specs"],
                                            mesh) for k in ("m", "v")},
            "step": state["step"]}


@torch.no_grad()
def scatter_state(plain: dict, state: dict) -> dict:
    """Put ``plain`` (``plain_state(state)``, filled by a restore) back
    into the sharded ``state``: each device's moment and parameter blocks
    (a replica shares its device's), and the step.  Returns ``state``."""
    if plain is state:
        return state

    def scatter(placed: dict, wholes: dict):
        for name, sh in placed.items():
            whole = wholes[name]
            for dev, items in sh.stores.items():
                if dev in sh.wholes:
                    if sh.wholes[dev] is not whole:
                        sh.wholes[dev].copy_(whole)
                    continue
                for blk, t in items:
                    t.copy_(whole[sharding.index_of(blk)])

    for k in ("m", "v"):
        scatter(state["opt"][k], plain["opt"][k])
    scatter(state["placed"], dict(plain["params"].named_parameters()))
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


def _grads_of(loss, placed: dict, home) -> dict:
    """{name: gradient} of ``loss`` over a sharded state's placed
    parameters (``sharding.place_params``), each whole on ``home``: a
    parameter's stored tensors' gradients added device by device in mesh
    order, a whole tensor's over the whole, a block's over its block."""
    leaves, where = [], []
    for name, sh in placed.items():
        for dev, items in sh.stores.items():
            if dev in sh.wholes:
                leaves.append(sh.wholes[dev])
                where.append((name, None))
            else:
                leaves += [t for _, t in items]
                where += [(name, blk) for blk, _ in items]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    out = {}
    for (name, blk), g in zip(where, grads):
        if g is None:
            continue
        g = g.to(home)
        acc = out.get(name)
        if blk is None:
            out[name] = g if acc is None else acc + g
            continue
        if acc is None:
            acc = out[name] = torch.zeros(placed[name].shape, dtype=g.dtype,
                                          device=home)
        idx = sharding.index_of(blk)
        acc[idx] = acc[idx] + g
    for name, sh in placed.items():
        if name not in out:                  # a parameter the loss skips
            t = next(iter(sh.stores.values()))[0][1]
            out[name] = torch.zeros(sh.shape, dtype=t.dtype, device=home)
    return out


def _position_parts(state: dict, batch: dict, cfg: ArchConfig,
                    ctx: ShardCtx) -> list:
    """``factory.loss_parts`` of one (micro)batch on a mesh: of each data
    position's rows, on its replica of the model (a model axis of 1) or
    its ``lm.ModelGroup`` of blocks, or of the whole batch on the first
    (see the module's docstring for which)."""
    mesh = ctx.mesh
    devs = list(mesh.devices.flat)
    dp, tp = ctx.dp_size, ctx.tp_size
    if tp == 1:
        models = [state["replicas"][dev] for dev in devs]
    else:
        blocks = sharding.param_blocks(state["placed"])
        models = [lm.ModelGroup(blocks[p:p + tp], devs[p:p + tp])
                  for p in range(0, len(devs), tp)]
    b, s = batch["labels"].shape
    groups = 1 if cfg.moe is None else moe_groups(dp, b * s, cfg.moe.top_k)
    if b % dp or (cfg.moe is not None and groups != dp):
        whole = {k: x.to(devs[0]) for k, x in batch.items()}
        return [factory.loss_parts(models[0], whole, cfg=cfg,
                                   moe_groups=groups)]
    shards = sharding.shard_tree(batch, sharding.batch_pspecs(batch, ctx),
                                 mesh)
    return [factory.loss_parts(m, {k: sh.blocks[i * tp]
                                   for k, sh in shards.items()}, cfg=cfg)
            for i, m in enumerate(models)]


def _grads(model: nn.Module, batch: dict, cfg: ArchConfig):
    """(loss, metrics, {name: grad}) of one batch."""
    loss, metrics = factory.train_loss(model, batch, cfg=cfg)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()),
                                allow_unused=True)
    return loss, metrics, {n: torch.zeros_like(p) if g is None else g
                           for (n, p), g in zip(named.items(), grads)}


def _step_grads(state: dict, batch: dict, cfg: ArchConfig, ctx: ShardCtx):
    """(metrics, {name: grad}) of one batch, on the model's device."""
    if ctx.mesh is None:
        _, metrics, grads = _grads(state["params"], batch, cfg)
        return metrics, grads
    loss, metrics = factory.combine_parts(
        _position_parts(state, batch, cfg, ctx), cfg=cfg)
    return metrics, _grads_of(loss, state["placed"],
                              ctx.mesh.devices.flat[0])


@torch.no_grad()
def _zero1_update(grads: dict, state: dict, opt_cfg: OptConfig):
    """AdamW on a sharded state, block by block (see the module's
    docstring); returns the gradients' global norm."""
    gnorm = global_norm(grads)
    scale = clip_scale(opt_cfg, gnorm)
    consts = step_constants(opt_cfg, state["step"])
    for name, g in grads.items():
        g = scaled(g, scale)
        ms, vs = state["opt"]["m"][name], state["opt"]["v"][name]
        ps = state["placed"][name]
        holder = {}
        for dev, items in ms.stores.items():
            for (blk, m), (_, v) in zip(items, vs.stores[dev]):
                adamw_leaf(name, ps.region(dev, blk).detach(),
                           g[sharding.index_of(blk)].to(dev), m, v, opt_cfg,
                           consts)
                holder.setdefault(blk, dev)
        for dev in ps.stores:                # the blocks a device lacks
            held = {blk for blk, _ in ms.stores.get(dev, [])}
            for blk, src in holder.items():
                dst = None if blk in held else ps.region(dev, blk)
                if dst is not None:
                    dst.detach().copy_(ps.region(src, blk).detach())
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
    _check_ctx(ctx, cfg)

    def train_step(state: dict, batch: dict):
        device = (ctx.mesh.devices.flat[0] if ctx.mesh is not None
                  else next(state["params"].parameters()).device)
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
                _, _, gnorm = adamw_update(
                    grads, state["opt"],
                    dict(state["params"].named_parameters()), opt_cfg,
                    state["step"])
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
