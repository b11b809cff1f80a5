"""Model factory: the JAX package's ``models/factory.py`` API for every
architecture: the decoder LMs (RWKV-6, the dense GQA models, the MoE and
MLA + MoE models, jamba's hybrid periods) and Whisper's
encoder-decoder.

  init_params(seed, cfg, dtype, device, max_seq)  -> LM or Whisper module
  from_state_dict(cfg, state)                     -> the same, given weights
  train_loss(model, batch, cfg)                   -> (loss, metrics)
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
only, as the reference's does.  Sharding (``ctx``) comes with ROADMAP
slice 11d.5, on the simulator's mesh (core/distribute.py).  Serving
(``prefill``, ``decode``, ``generate``) records no autograd graph, so a
model made trainable serves as a frozen one does.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.device import resolve_device
from repro_torch.models import lm, whisper
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


def train_loss(model, batch: dict, *, cfg: ArchConfig):
    """(loss, {"loss", "ce", "aux"}) of a batch of ``tokens`` (or the
    vision frontend's ``embeds``; for Whisper ``frames`` and decoder
    ``tokens``) and ``labels``: the chunked cross-entropy of the head's
    logits plus AUX_WEIGHT times the MoE layers' balance loss (0 without
    MoE)."""
    if cfg.enc_dec:
        enc_out = whisper.encode(model, batch["frames"], cfg=cfg)
        hidden = whisper.decoder_train(model, batch["tokens"], enc_out,
                                       cfg=cfg)
        aux = torch.zeros((), dtype=torch.float32, device=hidden.device)
        w = model.embed.emb.T
    else:
        x = lm._inputs(model, batch)
        b, s = x.shape[0], x.shape[1]
        positions = lm.make_positions(cfg, b, s, device=x.device)
        hidden, aux = lm.forward_hidden(model, x, cfg=cfg,
                                        positions=positions)
        w = lm.head_weight(model, cfg)
    ce = chunked_cross_entropy(hidden, w, batch["labels"])
    loss = ce + AUX_WEIGHT * aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}


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
