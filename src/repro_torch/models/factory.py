"""Model factory: the JAX package's ``models/factory.py`` API for the
architectures the port runs (RWKV-6 so far).

  init_params(seed, cfg, dtype, device)           -> LM module
  prefill(model, batch, cfg)                      -> (logits, cache)
  decode(model, cache, batch, cfg)                -> (logits, cache)
  init_cache(cfg, batch, dtype, device)           -> zeroed cache
  make_batch(seed, cfg, shape, device)            -> dummy token batch
  make_decode_batch(seed, cfg, batch, device)     -> one token per row
  generate(model, cfg, prompts, max_new)          -> greedy tokens

Entry points run on the CUDA card unless the caller names another device.
Random draws come from an explicit ``torch.Generator`` on the device,
seeded by the caller; they are not the JAX package's draws, so tests that
compare the two carry the same weights across with ``repro_torch.convert``.
Sharding (``ctx``) comes with ROADMAP slice 10; ``train_loss`` with the
training slice (11c); the caches and frontends of other families, and
the arguments that size them, with their slices.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.device import resolve_device
from repro_torch.models import lm


def _check_ported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError, naming the ROADMAP slice, for a family
    the port does not run yet."""
    if cfg.enc_dec:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder model is not ported to "
            "repro_torch yet; ROADMAP slice 11d (MoE, MLA, Mamba and "
            "Whisper)")
    lm.group_plan(cfg)


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def init_params(seed: int, cfg: ArchConfig, dtype=torch.float32, *,
                device=None) -> lm.LM:
    """Random weights at the JAX package's init scales, drawn on the
    device from a ``torch.Generator`` seeded with ``seed``."""
    _check_ported(cfg)
    device = resolve_device(device)
    gen = _generator(seed, device)

    def draw(shape, std):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device).mul_(std)

    return lm.init_lm(draw, cfg, dtype, device)


def prefill(model: lm.LM, batch: dict, *, cfg: ArchConfig):
    return lm.lm_prefill(model, batch, cfg=cfg)


def decode(model: lm.LM, cache: dict, batch: dict, *, cfg: ArchConfig):
    return lm.lm_decode(model, cache, batch, cfg=cfg)


def init_cache(cfg: ArchConfig, batch: int, dtype=torch.float32, *,
               device=None) -> dict:
    _check_ported(cfg)
    return lm.init_cache(cfg, batch, dtype, resolve_device(device))


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

def _tokens(seed: int, cfg: ArchConfig, shape: tuple, device) -> torch.Tensor:
    _check_ported(cfg)
    device = resolve_device(device)
    return torch.randint(0, cfg.vocab_size, shape,
                         generator=_generator(seed, device),
                         dtype=torch.int32, device=device)


def make_batch(seed: int, cfg: ArchConfig, shape: ShapeSpec, *,
               device=None) -> dict:
    """Random token ids and labels, each (global_batch, seq_len) int32."""
    b, s = shape.global_batch, shape.seq_len
    toks = _tokens(seed, cfg, (2, b, s), device)
    return {"tokens": toks[0], "labels": toks[1]}


def make_decode_batch(seed: int, cfg: ArchConfig, batch: int, *,
                      device=None) -> dict:
    return {"tokens": _tokens(seed, cfg, (batch, 1), device)}


def generate(model: lm.LM, cfg: ArchConfig, prompts, *, max_new: int = 16):
    """prompts: (B, S) int32. Greedy decode max_new tokens; argmax ties go
    to the first index, as ``jnp.argmax``'s do."""
    logits, cache = prefill(model, {"tokens": prompts}, cfg=cfg)
    toks = [torch.argmax(logits, -1).to(torch.int32)[:, None]]
    for _ in range(max_new - 1):
        logits, cache = decode(model, cache, {"tokens": toks[-1]}, cfg=cfg)
        toks.append(torch.argmax(logits, -1).to(torch.int32)[:, None])
    return torch.cat(toks, dim=1)
