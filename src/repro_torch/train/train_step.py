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

  · The parameters are placed by ``param_pspecs``
    (``sharding.place_params``): a device stores each parameter it holds
    every block of whole, once, and of a parameter the mesh splits only
    its positions' blocks: the model axis's splits, and the MoE layers'
    experts wherever ``ctx.ep_axes`` places them (over the data axes, the
    expert FFN's width over the model axis; over data and model; over
    model; replicated).  Each stored tensor is a leaf of autograd.
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
  · A model axis of 1 without MoE: each data position runs its device's
    replica of the model, a module over the stored tensors.  Otherwise
    (every family): each data position's rows go through each layer
    once per model position of its row of the mesh (``lm.ModelGroup``),
    each on its block of every split parameter
    (``sharding.param_blocks``, views taken in the forward so that the
    gradient reaches the stored tensor): attention on its heads, or on
    its head_dim columns joined into whole heads for K3' (each position
    on its slab of queries, ``attention.seqpar_attention``, on a long
    sequence), MLA on its heads from latents made once, Mamba on its
    d_inner channels (the ``wxp`` partials summed before the softplus),
    the FFN on its d_ff columns, RWKV's time mix on its heads (or its
    columns, joined where it cuts heads) and its channel mix on its d_ff
    columns, the embedding on its d_model columns and the cross-entropy
    on its vocab columns (Whisper's tied head: the joined table).  An
    MoE layer routes and dispatches the data position's tokens once,
    then runs each expert block where it is stored (``lm.Experts``: each
    stored block read by the data positions through ``shared_reads``,
    so that their gradients add in position order), on each owner's columns
    of the expert FFN's width, and combines the outputs on the data
    position's device.  The row-split partials are added in
    model-position order (``parallelism/tensor.py``).  A leaf the model
    axis replicates (the norms, the router, MLA's down-projections,
    RWKV's token shift and decay LoRA, an FFN whose d_ff it does not
    divide, attention, MLA or Mamba that it does not split, Whisper's
    ``pos_dec``) runs once per data position, on its first position.
  · The positions' CE sums and counts, and each MoE layer's router
    statistics, are summed in data-position order on the first device
    (``factory.combine_parts``), and one backward gives the gradient.
    Positions on one device share its stored tensors, and autograd sums
    their gradients; each block of each parameter's gradient then lives
    on the first device that stores it, its stored copies' gradients
    added in device order (``_grads_of``): no device holds a whole
    gradient it does not store whole.
  · The update: the global norm (each gradient block's sum of squares,
    in name and block order) and the clip factor; AdamW runs on each
    ZeRO-1 block of the moments (``moments_pspecs``: the parameter's
    split, and the data axes on a free dimension where the parameter
    does not use them already), made on its device, and the
    parameters' matching slice, once per device that stores it; a
    device then copies the blocks it stores but did not update from
    their holder.  On a mesh that repeats one card, the blocks are views
    of one copy of each moment and parameter, and nothing is copied.
  · A sharded state adds {"ctx", "cfg", "specs": the moments' specs,
    "placed": {name: ``sharding.Shards``} of the parameters, "replicas":
    {device: the model there} for a model axis of 1 without MoE, else
    empty}; its moments are ``sharding.Shards``.  Its "params" is the
    model on the first device where that device stores every parameter
    whole (every mesh that repeats one card), else None (and the model
    it was made from is emptied as it is placed).  ``plain_state``
    gathers it for a checkpoint, and ``scatter_state`` puts a restored
    one back.
"""
from __future__ import annotations

import os
from contextlib import contextmanager

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import factory, sharded
from repro_torch.parallelism import sharding
from repro_torch.parallelism.ctx import NULL_CTX, ShardCtx
from repro_torch.train.optimizer import (OptConfig, adamw_leaf, adamw_update,
                                         clip_scale, init_opt_state,
                                         moment_dtype, scaled,
                                         step_constants)

CUBLAS_CONFIGS = (":4096:8", ":16:8")


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
    placed = sharding.place_params(
        params, sharding.param_pspecs(params, cfg, ctx), mesh)
    return placed_train_state(placed, cfg, opt_cfg, ctx, model)


def placed_train_state(placed: dict, cfg: ArchConfig, opt_cfg: OptConfig,
                       ctx: ShardCtx, model=None) -> dict:
    """The sharded train state over parameters already placed by
    ``param_pspecs`` on ``ctx.mesh`` (``sharding.place_params`` of
    ``model``, or a dry run's ``sharding.zeros_tree(..., leaves=True)``,
    made from shapes): zero moments placed by ``moments_pspecs``, each
    block made on its device, and step 0.  Where a model is needed over
    the first device's stored tensors (a replica, or "params") and
    ``model`` is None, it is made of them."""
    mesh = ctx.mesh
    home = mesh.devices.flat[0]
    shapes = {n: sh.shape for n, sh in placed.items()}
    specs = sharding.moments_pspecs({n: sh.spec for n, sh in placed.items()},
                                    shapes, ctx)
    whole = all(home in sh.wholes for sh in placed.values())
    if whole and model is None:
        model = factory.from_state_dict(
            cfg, {n: sh.wholes[home] for n, sh in placed.items()})
    replicas = {}
    if ctx.tp_size == 1 and cfg.moe is None:
        for dev in dict.fromkeys(mesh.devices.flat):
            replicas[dev] = model if dev == home else factory.from_state_dict(
                cfg, {n: sh.wholes[dev] for n, sh in placed.items()})
    dt = moment_dtype(opt_cfg)
    return {"params": model if whole else None,
            "opt": {k: sharding.zeros_tree(shapes, specs, mesh, dt)
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


def _grads_of(loss, placed: dict) -> dict:
    """{name: {block: gradient}} of ``loss`` over a sharded state's placed
    parameters (``sharding.place_params``): for each distinct block of a
    parameter (``Shards.where``, in position order), its gradient on the
    first device that stores it, the stored tensors' gradients over it
    added there device by device in mesh order (a whole tensor's by the
    view of it).  No device holds more of a gradient than its blocks."""
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
    out = {name: dict.fromkeys(b for b in dict.fromkeys(sh.where)
                               if b is not None)
           for name, sh in placed.items()}
    for (name, blk), g in zip(where, grads):
        if g is None:
            continue
        acc = out[name]
        parts = ([(blk, g)] if blk is not None else
                 [(b, g[sharding.index_of(b)]) for b in acc])
        for b, part in parts:
            acc[b] = part if acc[b] is None else \
                acc[b] + part.to(acc[b].device)
    for name, sh in placed.items():        # a block the loss skips
        for b, g in out[name].items():
            if g is None:
                dev = next(d for d in sh.stores
                           if sh.region(d, b) is not None)
                out[name][b] = torch.zeros_like(sh.region(dev, b))
    return out


def _position_parts(state: dict, batch: dict, cfg: ArchConfig,
                    ctx: ShardCtx) -> list:
    """``factory.loss_parts`` of one (micro)batch on a mesh: of each data
    position's rows, on its replica of the model (a model axis of 1,
    without MoE) or its ``lm.ModelGroup`` of blocks, or of the whole batch
    on the first (see the module's docstring for which)."""
    mesh = ctx.mesh
    devs = list(mesh.devices.flat)
    dp, tp = ctx.dp_size, ctx.tp_size
    b, s = batch["labels"].shape
    groups, spread = sharded.row_split(cfg, ctx, b, b * s)
    n = dp if spread else 1
    if state["replicas"]:
        models = [state["replicas"][dev] for dev in devs]
    else:
        models = sharded.model_groups(state["placed"], ctx, n)
    if not spread:
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
    """(metrics, gradients) of one batch: {name: grad} on the model's
    device, or on a mesh ``_grads_of``'s {name: {block: grad}}."""
    if ctx.mesh is None:
        _, metrics, grads = _grads(state["params"], batch, cfg)
        return metrics, grads
    loss, metrics = factory.combine_parts(
        _position_parts(state, batch, cfg, ctx), cfg=cfg)
    return metrics, _grads_of(loss, state["placed"])


def _block_norm(grads: dict, home) -> torch.Tensor:
    """The global norm of ``_grads_of``'s gradients: each block's sum of
    squares in f32 (a view of a whole gradient made contiguous first, so
    that it sums as a stored block does), added on ``home`` in name and
    block order."""
    return torch.sqrt(torch.stack([
        torch.sum(torch.square(g.to(torch.float32).contiguous())).to(home)
        for blocks in grads.values() for g in blocks.values()]).sum())


@torch.no_grad()
def _zero1_update(grads: dict, state: dict, opt_cfg: OptConfig):
    """AdamW on a sharded state, block by block (see the module's
    docstring), from ``_grads_of``'s gradients; returns their global
    norm."""
    home = state["ctx"].mesh.devices.flat[0]
    gnorm = _block_norm(grads, home)
    scale = clip_scale(opt_cfg, gnorm)
    consts = step_constants(opt_cfg, state["step"])
    for name, gblocks in grads.items():
        gblocks = [(b, scaled(g, scale.to(g.device)))
                   for b, g in gblocks.items()]
        ms, vs = state["opt"]["m"][name], state["opt"]["v"][name]
        ps = state["placed"][name]
        holder = {}
        for dev, items in ms.stores.items():
            for (blk, m), (_, v) in zip(items, vs.stores[dev]):
                g = next(g[idx] for b, g in gblocks
                         if (idx := sharding.inside(blk, b)) is not None)
                adamw_leaf(name, ps.region(dev, blk).detach(), g.to(dev), m,
                           v, opt_cfg, consts)
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


def _map_grads(fn, grads: dict, *more) -> dict:
    """fn over the gradients' tensors, a {name: grad} dict's or a sharded
    step's {name: {block: grad}}, with the same tensors of ``more``."""
    if isinstance(next(iter(grads.values())), dict):
        return {n: {b: fn(g, *(m[n][b] for m in more))
                    for b, g in blocks.items()} for n, blocks in
                grads.items()}
    return {n: fn(g, *(m[n] for m in more)) for n, g in grads.items()}


def make_train_step(cfg: ArchConfig, opt_cfg: OptConfig,
                    ctx: ShardCtx = NULL_CTX, accum_steps: int = 1):
    """train_step(state, batch) -> (state, metrics).  accum_steps > 1
    splits the batch's leading axis into that many microbatches and sums
    their f32 gradients before one update (the metrics are the last
    microbatch's, as the reference's scan carries them).  With a mesh
    ``ctx`` it takes a state that ``init_train_state(..., ctx=ctx)``
    made."""

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
                    grads = _map_grads(lambda x: x.float(), g)
                else:
                    _map_grads(lambda acc, x: acc.add_(x.float()), grads, g)
            if accum_steps > 1:
                grads = _map_grads(lambda x: x / accum_steps, grads)
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


def make_eval_step(cfg: ArchConfig, ctx: ShardCtx = NULL_CTX):
    """eval_step(model, batch) -> metrics ({"loss", "ce", "aux"}), with no
    graph recorded.  With a mesh ``ctx`` it is eval_step(state, batch)
    for a state that ``init_train_state(..., ctx=ctx)`` made: the train
    step's forward (``combine_parts`` of ``_position_parts``), so that
    its metrics are the next step's."""
    @torch.no_grad()
    def eval_step(model, batch: dict):
        if ctx.mesh is None:
            return factory.train_loss(model, batch, cfg=cfg)[1]
        if "ctx" not in model:
            raise ValueError("eval on a mesh takes the train state that "
                             "init_train_state(..., ctx=ctx) made")
        return factory.combine_parts(_position_parts(model, batch, cfg, ctx),
                                     cfg=cfg)[1]
    return eval_step
