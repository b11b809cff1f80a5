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
  prefill(model, batch, cfg, max_len)             -> (logits, cache)
  decode(model, cache, batch, cfg)                -> (logits, cache)
  init_cache(cfg, batch, max_len, dtype, device)  -> zeroed cache
  make_batch(seed, cfg, shape, device)            -> dummy batch
  make_decode_batch(seed, cfg, batch, device)     -> one step's input
  generate(model, cfg, prompts, max_new)          -> greedy tokens

Entry points run on the CUDA card unless the caller names another device.
Random draws come from an explicit ``torch.Generator`` on the device,
seeded by the caller; they are not the JAX package's draws, so tests that
compare the two carry the same weights across with ``repro_torch.convert``.
Whisper's batches carry ``frames`` (B, ENC_LEN, d), the stubbed audio
frontend's output, beside ``tokens``; ``generate`` takes token prompts
only, as the reference's does.  The reference's ``ctx`` is not an
argument here: the sharded train step (train/train_step.py) runs
``loss_parts`` on each data position's rows and combines them with
``combine_parts``, which is what ``train_loss`` does for one batch;
under a model axis it passes ``loss_parts`` the data position's
``lm.ModelGroup`` in place of a model, whose blocks compute the
embedding, the layers and the vocab-parallel cross-entropy.
Serving
(``prefill``, ``decode``, ``generate``) records no autograd graph, so a
model made trainable serves as a frozen one does.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.device import resolve_device
from repro_torch.models import lm, whisper
from repro_torch.models.layers import moe as moe_mod
from repro_torch.models.loss import chunked_cross_entropy

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
        w = model.embed.emb.T
    else:
        x = lm._inputs(model, batch)
        b, s = x.shape[0], x.shape[1]
        positions = lm.make_positions(cfg, b, s, device=x.device)
        hidden, stats = lm.forward_hidden(model, x, cfg=cfg,
                                          positions=positions,
                                          moe_groups=moe_groups)
        w = lm.head_weight(model, cfg)
    labels = batch["labels"]
    ce, count = chunked_cross_entropy(hidden, w, labels)
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


def prefill(model, batch: dict, *, cfg: ArchConfig, max_len: int = 0):
    if cfg.enc_dec:
        return whisper.whisper_prefill(model, batch, cfg=cfg,
                                       max_len=max_len)
    return lm.lm_prefill(model, batch, cfg=cfg, max_len=max_len)


def decode(model, cache: dict, batch: dict, *, cfg: ArchConfig):
    if cfg.enc_dec:
        return whisper.whisper_decode(model, cache, batch, cfg=cfg)
    return lm.lm_decode(model, cache, batch, cfg=cfg)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.float32, *, device=None) -> dict:
    device = resolve_device(device)
    if cfg.enc_dec:
        return whisper.init_whisper_cache(cfg, batch, max_len, dtype, device)
    return lm.init_cache(cfg, batch, max_len, dtype, device)


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
def generate(model, cfg: ArchConfig, prompts, *, max_new: int = 16):
    """prompts: (B, S) int32. Greedy decode max_new tokens; argmax ties go
    to the first index, as ``jnp.argmax``'s do.  A token-prompt batch
    only, as the reference's: Whisper's prefill needs frames (drive it
    through ``prefill`` and ``decode``)."""
    b, s = prompts.shape
    logits, cache = prefill(model, {"tokens": prompts}, cfg=cfg,
                            max_len=s + max_new)
    toks = [torch.argmax(logits, -1).to(torch.int32)[:, None]]
    for _ in range(max_new - 1):
        logits, cache = decode(model, cache, {"tokens": toks[-1]}, cfg=cfg)
        toks.append(torch.argmax(logits, -1).to(torch.int32)[:, None])
    return torch.cat(toks, dim=1)
