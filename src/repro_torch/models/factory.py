"""Model factory: the JAX package's ``models/factory.py`` API for every
architecture: the decoder LMs (RWKV-6, the dense GQA models, the MoE and
MLA + MoE models, jamba's hybrid periods) and Whisper's
encoder-decoder.

  init_params(seed, cfg, dtype, device, max_seq)  -> LM or Whisper module
  from_state_dict(cfg, state)                     -> the same, given weights
  train_loss(model, batch, cfg)                   -> (loss, metrics)
  loss_parts(model, batch, cfg, moe_groups)       -> a batch's CE sum and
                                                     count, MoE statistics
  combine_parts([parts, ...], cfg)                -> (loss, metrics)
  param_shapes(cfg, dtype, max_seq)               -> {name: shape}
  prefill(model, batch, cfg, max_len, ctx)        -> (logits, cache)
  decode(model, cache, batch, cfg, ctx)           -> (logits, cache)
  init_cache(cfg, batch, max_len, dtype, device, ctx) -> zeroed cache
  make_batch(seed, cfg, shape, device)            -> dummy batch
  make_decode_batch(seed, cfg, batch, device)     -> one step's input
  generate(model, cfg, prompts, max_new, ctx)     -> greedy tokens
  place_model(model, cfg, ctx)                    -> the model on a mesh
  init_placed(seed, cfg, ctx)                     -> fresh weights, placed

Entry points run on the CUDA card unless the caller names another device.
Random draws come from an explicit ``torch.Generator`` on the device,
seeded by the caller; they are not the JAX package's draws, so tests that
compare the two carry the same weights across with ``repro_torch.convert``.
Whisper's batches carry ``frames`` (B, ENC_LEN, d), the stubbed audio
frontend's output, beside ``tokens``; ``generate`` takes token prompts
only, as the reference's does.  The training loss takes no ``ctx``:
the sharded train step (train/train_step.py) runs ``loss_parts`` on each
data position's rows and combines them with ``combine_parts``, which is
what ``train_loss`` does for one batch; under a model axis it passes
``loss_parts`` the data position's ``lm.ModelGroup`` in place of a
model (Whisper's too), whose blocks compute the embedding, the layers
and the cross-entropy: vocab-parallel for a split head, whole-vocab over
the joined table for Whisper's tied one.
Serving (``prefill``, ``decode``, ``generate``) records no autograd
graph, so a model made trainable serves as a frozen one does.  It takes
the reference's ``ctx``: with ``ctx.mesh`` None it is the unsharded path
(its MoE layers in ``moe_groups`` token groups, 1 by default); over a
mesh it takes the ``sharded.PlacedModel`` that ``place_model`` (or
``init_placed``) makes, stores the cache in ``cache_pspecs``' blocks and
returns the logits in ``logits_pspec``'s (``models/sharded.py``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.convert import _flatten
from repro_torch.device import resolve_device
from repro_torch.models import lm, sharded, whisper
from repro_torch.models.layers import moe as moe_mod
from repro_torch.models.loss import chunked_cross_entropy
from repro_torch.parallelism import sharding
from repro_torch.parallelism.ctx import NULL_CTX, ShardCtx

AUX_WEIGHT = 0.01


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def init_params(seed: int, cfg: ArchConfig, dtype=torch.float32, *,
                device=None, max_seq: int = 4096) -> lm.LM | whisper.Whisper:
    """Random weights at the JAX package's init scales, drawn on the
    device from a ``torch.Generator`` seeded with ``seed``; Whisper's
    learned decoder positions are sized for max_seq tokens."""
    device = resolve_device(device)
    gen = _generator(seed, device)

    def draw(shape, std):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device).mul_(std)

    if cfg.enc_dec:
        return whisper.init_whisper(draw, cfg, dtype, device,
                                    max_dec_len=max_seq)
    return lm.init_lm(draw, cfg, dtype, device)


def from_state_dict(cfg: ArchConfig, state: dict):
    """The model (``LM``, or ``Whisper`` for the encoder-decoder) whose
    ``state_dict()`` is ``state``: the weights ``convert`` carries over
    from the JAX package's tree."""
    cls = whisper.Whisper if cfg.enc_dec else lm.LM
    return cls.from_state_dict(cfg, state)


def param_shapes(cfg: ArchConfig, dtype=torch.float32, *,
                 max_seq: int = 4096) -> dict:
    """{parameter name: shape} of the model ``init_params`` builds, from
    a model on the ``meta`` device: no memory and no random draws, so the
    published configs of every size fit."""
    def draw(shape, std):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    dev = torch.device("meta")
    model = (whisper.init_whisper(draw, cfg, dtype, dev, max_dec_len=max_seq)
             if cfg.enc_dec else lm.init_lm(draw, cfg, dtype, dev))
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def loss_parts(model, batch: dict, *, cfg: ArchConfig,
               moe_groups: int = 1) -> dict:
    """The pieces of ``train_loss`` of one batch, to be combined over
    data positions by ``combine_parts``: {"ce": the cross-entropy summed
    over the valid labels (0-d f32), "count": their number (0-d int32),
    "stats": the MoE layers' router statistics in layer order (each (2,
    E) f32; none without MoE), "tokens": the batch's B·S}.  The MoE
    layers split the tokens into ``moe_groups`` groups.  ``model`` may be
    an ``lm.ModelGroup`` (the sharded step's model axis)."""
    if cfg.enc_dec:
        enc_out = whisper.encode(model, batch["frames"], cfg=cfg)
        hidden = whisper.decoder_train(model, batch["tokens"], enc_out,
                                       cfg=cfg)
        stats = []
    else:
        x = lm._inputs(model, batch)
        b, s = x.shape[0], x.shape[1]
        positions = lm.make_positions(cfg, b, s, device=x.device)
        hidden, stats = lm.forward_hidden(model, x, cfg=cfg,
                                          positions=positions,
                                          moe_groups=moe_groups)
    labels = batch["labels"]
    ce, count = chunked_cross_entropy(hidden, lm.head_weight(model, cfg),
                                      labels)
    return {"ce": ce, "count": count, "stats": stats,
            "tokens": labels.shape[0] * labels.shape[1]}


def combine_parts(parts: list, *, cfg: ArchConfig):
    """(loss, {"loss", "ce", "aux"}) of ``loss_parts`` of one or more
    data positions, on the first one's device: ce the sum of their CE
    sums over the sum of their counts (at least 1), aux the sum over the
    MoE layers of each layer's balance loss from its statistics summed
    over the positions (0 without MoE).  Sums run in position order."""
    home = parts[0]["ce"].device

    def total(xs):
        acc = xs[0]
        for x in xs[1:]:
            acc = acc + x.to(home)
        return acc

    ce = (total([p["ce"] for p in parts])
          / torch.clamp(total([p["count"] for p in parts]), min=1).float())
    aux = torch.zeros((), dtype=torch.float32, device=home)
    n = sum(p["tokens"] for p in parts)
    for layer in zip(*(p["stats"] for p in parts)):
        aux = aux + moe_mod.balance_loss(total(list(layer)), n,
                                         cfg.moe.n_experts)
    loss = ce + AUX_WEIGHT * aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}


def train_loss(model, batch: dict, *, cfg: ArchConfig):
    """(loss, {"loss", "ce", "aux"}) of a batch of ``tokens`` (or the
    vision frontend's ``embeds``; for Whisper ``frames`` and decoder
    ``tokens``) and ``labels``: the chunked cross-entropy of the head's
    logits plus AUX_WEIGHT times the MoE layers' balance loss (0 without
    MoE)."""
    return combine_parts([loss_parts(model, batch, cfg=cfg)], cfg=cfg)


def prefill(model, batch: dict, *, cfg: ArchConfig, max_len: int = 0,
            ctx: ShardCtx = NULL_CTX, moe_groups: int = 1):
    """(last-token logits, cache) of a prompt; over a mesh ``model`` is a
    ``sharded.PlacedModel`` and both come back placed (the MoE groups then
    follow the data positions, ``moe_groups`` is not read)."""
    if ctx.mesh is not None:
        return sharded.prefill(_placed(model, ctx), batch, cfg=cfg,
                               max_len=max_len)
    if cfg.enc_dec:
        return whisper.whisper_prefill(model, batch, cfg=cfg,
                                       max_len=max_len)
    return lm.lm_prefill(model, batch, cfg=cfg, max_len=max_len,
                         moe_groups=moe_groups)


def decode(model, cache: dict, batch: dict, *, cfg: ArchConfig,
           ctx: ShardCtx = NULL_CTX, moe_groups: int = 1):
    """One decode step: (logits, new cache), as ``prefill``'s."""
    if ctx.mesh is not None:
        return sharded.decode(_placed(model, ctx), cache, batch, cfg=cfg)
    if cfg.enc_dec:
        return whisper.whisper_decode(model, cache, batch, cfg=cfg)
    return lm.lm_decode(model, cache, batch, cfg=cfg, moe_groups=moe_groups)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.float32, *, device=None,
               ctx: ShardCtx = NULL_CTX) -> dict:
    """The zero cache; over a mesh placed by ``cache_pspecs``, each block
    made on its holder."""
    if ctx.mesh is not None:
        return sharded.init_cache(cfg, batch, max_len, ctx, dtype)
    device = resolve_device(device)
    if cfg.enc_dec:
        return whisper.init_whisper_cache(cfg, batch, max_len, dtype, device)
    return lm.init_cache(cfg, batch, max_len, dtype, device)


def _placed(model, ctx: ShardCtx) -> sharded.PlacedModel:
    if not isinstance(model, sharded.PlacedModel):
        raise TypeError("serving on a mesh takes the model that "
                        "place_model(model, cfg, ctx) returns")
    if model.ctx != ctx:
        raise ValueError("the model was placed for another ctx")
    return model


def place_model(model, cfg: ArchConfig, ctx: ShardCtx) -> sharded.PlacedModel:
    """``model`` (an ``LM`` or ``Whisper``) placed on ``ctx.mesh`` by
    ``param_pspecs`` (``sharding.place_params``: the experts by
    ``ctx.ep_axes``), for ``prefill``, ``decode`` and ``generate`` under
    ``ctx``.  A parameter that the mesh's first device does not store
    whole is released from ``model`` once placed."""
    params = dict(model.named_parameters())
    return sharded.PlacedModel(sharding.place_params(
        params, sharding.param_pspecs(params, cfg, ctx), ctx.mesh), ctx)


def init_placed(seed: int, cfg: ArchConfig, ctx: ShardCtx,
                dtype=torch.float32) -> sharded.PlacedModel:
    """``place_model(init_params(seed, cfg, dtype, device=first))``, the
    same weights, drawn on the mesh's first device and placed one part at
    a time (``lm.init_lm_parts``: a block, a period's sublayer), so that
    no device ever holds more of the model than its blocks and one part:
    a model larger than any card.  Whisper is drawn whole."""
    home = ctx.mesh.devices.flat[0]
    if cfg.enc_dec:
        return place_model(init_params(seed, cfg, dtype, device=home), cfg,
                           ctx)
    gen = _generator(seed, home)

    def draw(shape, std):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=home).mul_(std)

    shapes = param_shapes(cfg, dtype)
    specs = sharding.param_pspecs(shapes, cfg, ctx)
    layers = sharding.leaf_layers(shapes)
    placed = {}
    for prefix, part in lm.init_lm_parts(draw, cfg, dtype, home):
        flat = {}
        _flatten(prefix, part, flat, lambda t: t)
        placed.update(sharding.place_params(
            flat, {n: specs[n] for n in flat}, ctx.mesh, layers=layers))
        del flat, part
    return sharded.PlacedModel({n: placed[n] for n in shapes}, ctx)


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

def _draws(seed: int, device):
    """(generator, device) for a batch's random draws."""
    device = resolve_device(device)
    return _generator(seed, device), device


def _tokens(gen, cfg: ArchConfig, shape: tuple, device) -> torch.Tensor:
    return torch.randint(0, cfg.vocab_size, shape, generator=gen,
                         dtype=torch.int32, device=device)


def _embeds(gen, shape: tuple, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device)


def make_batch(seed: int, cfg: ArchConfig, shape: ShapeSpec, *,
               device=None) -> dict:
    """Random token ids (or, for the vision frontend, f32 patch embeddings
    (global_batch, seq_len, d_model)) and labels, each (global_batch,
    seq_len) int32; for Whisper also f32 frames (global_batch, ENC_LEN,
    d_model)."""
    gen, device = _draws(seed, device)
    b, s = shape.global_batch, shape.seq_len
    if cfg.enc_dec:
        frames = _embeds(gen, (b, whisper.ENC_LEN, cfg.d_model), device)
        toks = _tokens(gen, cfg, (2, b, s), device)
        return {"frames": frames, "tokens": toks[0], "labels": toks[1]}
    if cfg.frontend == "vision":
        return {"embeds": _embeds(gen, (b, s, cfg.d_model), device),
                "labels": _tokens(gen, cfg, (b, s), device)}
    toks = _tokens(gen, cfg, (2, b, s), device)
    return {"tokens": toks[0], "labels": toks[1]}


def make_decode_batch(seed: int, cfg: ArchConfig, batch: int, *,
                      device=None) -> dict:
    gen, device = _draws(seed, device)
    if cfg.frontend == "vision":
        return {"embeds": _embeds(gen, (batch, 1, cfg.d_model), device)}
    return {"tokens": _tokens(gen, cfg, (batch, 1), device)}


@torch.no_grad()
def generate(model, cfg: ArchConfig, prompts, *, max_new: int = 16,
             ctx: ShardCtx = NULL_CTX):
    """prompts: (B, S) int32. Greedy decode max_new tokens; argmax ties go
    to the first index, as ``jnp.argmax``'s do (over a mesh, across the
    logits' vocab blocks too: ``sharded.greedy``).  A token-prompt batch
    only, as the reference's: Whisper's prefill needs frames (drive it
    through ``prefill`` and ``decode``).  Over a mesh ``model`` is a
    ``sharded.PlacedModel``, as ``prefill``'s."""
    if ctx.mesh is not None:
        return sharded.generate(_placed(model, ctx), cfg, prompts,
                                max_new=max_new)
    b, s = prompts.shape
    logits, cache = prefill(model, {"tokens": prompts}, cfg=cfg,
                            max_len=s + max_new)
    toks = [torch.argmax(logits, -1).to(torch.int32)[:, None]]
    for _ in range(max_new - 1):
        logits, cache = decode(model, cache, {"tokens": toks[-1]}, cfg=cfg)
        toks.append(torch.argmax(logits, -1).to(torch.int32)[:, None])
    return torch.cat(toks, dim=1)
