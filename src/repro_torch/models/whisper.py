"""Whisper-style encoder-decoder backbone (audio frontend stubbed), the JAX
package's ``models/whisper.py``.

The batch supplies precomputed mel-frame embeddings ``frames`` (B, Senc,
d): the conv1d frontend is a stub, as in the reference.  The encoder adds
the sinusoidal position table and runs non-causal self-attention; the
decoder uses a learned position table ``pos_dec`` sized at init
(``max_dec_len``), causal self-attention with a KV cache, and cross
attention over the encoder's output.  Embeddings are tied (logits =
h @ emb.T).

The parameters keep the reference's names; its ``enc_blocks`` and
``dec_blocks`` trees, stacked on a layer axis there, are module lists
here (state-dict keys such as ``dec_blocks.2.cross_attn.wq`` for layer
2's ``params["dec_blocks"]["cross_attn"]["wq"]``).  Every full-sequence
attention goes through the flash-attention wrapper (the kernel on the
card): the encoder's self-attention non-causal, the decoder's causal,
and the cross attention non-causal, in training and in the prefill, so a
prefill launches it n_enc + 2 n_dec times.  The one-token decode steps
attend plain, as every decode in the port does.  Training runs each
block under non-reentrant ``torch.utils.checkpoint``, as the reference's
under ``jax.checkpoint``; serving runs under ``torch.no_grad()`` and
decode is functional (a step returns a new cache).  The cache keeps the
reference's layout: ``k``/``v`` (n_dec, B, max_len, KV, hd), the cross
entries ``ck``/``cv`` (n_dec, B, ENC_LEN, KV, hd) and ``len`` (B,) int32.

Under the sharded train step's model axis ``encode`` and
``decoder_train`` take a data position's ``lm.ModelGroup`` in place of
the model, as the reference's take a ``ctx``: each block's model
positions run on their blocks of its parameters inside one checkpoint of
that block (``lm.run_checkpointed``, not ``torch.utils.checkpoint``),
the attention in the layout the rules give it (``attention.
attention_group``: the encoder's non-causal, the decoder's causal self
attention and its cross attention over the encoder's output), the FFN
on its d_ff columns where the model axis splits them
(``lm.ffn_group``).  The norms and ``pos_dec``, which it replicates, run
once per data position; the decoder embeds its tokens from each
position's d_model block of ``emb`` (``lm.embed_tokens``), and the tied
head is the joined table (``lm.head_weight``).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import attention as attn
from repro_torch.models.layers.common import (ParamDict, apply_norm,
                                              init_norm, nest_state_dict,
                                              sinusoidal_embedding)
from repro_torch.models.layers.ffn import apply_ffn, init_ffn
from repro_torch.models import lm
from repro_torch.models.lm import VOCAB_PAD, ModelGroup, _pad_seq

ENC_LEN = 1500  # 30 s of audio at 50 Hz after the (stubbed) conv frontend


# ---------------------------------------------------------------------------
# parameters.  draw(shape, std) returns f32 normal draws times std, called
# in a fixed order; the scales are the reference's.
# ---------------------------------------------------------------------------

def _init_enc_block(draw, cfg: ArchConfig, dtype, device) -> dict:
    d = cfg.d_model
    return {"attn_norm": init_norm(cfg.norm, d, dtype, device),
            "attn": attn.init_attention(draw, cfg, dtype, device),
            "mlp_norm": init_norm(cfg.norm, d, dtype, device),
            "mlp": init_ffn(draw, d, cfg.d_ff, cfg.act, dtype)}


def _init_dec_block(draw, cfg: ArchConfig, dtype, device) -> dict:
    d = cfg.d_model
    return {"self_norm": init_norm(cfg.norm, d, dtype, device),
            "self_attn": attn.init_attention(draw, cfg, dtype, device),
            "cross_norm": init_norm(cfg.norm, d, dtype, device),
            "cross_attn": attn.init_attention(draw, cfg, dtype, device,
                                              cross=True),
            "mlp_norm": init_norm(cfg.norm, d, dtype, device),
            "mlp": init_ffn(draw, d, cfg.d_ff, cfg.act, dtype)}


def init_whisper_tree(draw, cfg: ArchConfig, dtype=torch.float32,
                      device=None, max_dec_len: int = 4096) -> dict:
    """The parameter tree, one dict per layer: {"embed": {"emb"},
    "pos_dec", "enc_blocks": [block, ...], "enc_norm", "dec_blocks":
    [block, ...], "dec_norm"}."""
    vp = cfg.padded_vocab(VOCAB_PAD)
    d = cfg.d_model
    enc = [_init_enc_block(draw, cfg, dtype, device)
           for _ in range(cfg.n_enc_layers)]
    dec = [_init_dec_block(draw, cfg, dtype, device)
           for _ in range(cfg.n_layers)]
    return {"embed": {"emb": draw((vp, d), 0.02).to(dtype)},
            "pos_dec": draw((max_dec_len, d), 0.01).to(dtype),
            "enc_blocks": enc,
            "enc_norm": init_norm(cfg.norm, d, dtype, device),
            "dec_blocks": dec,
            "dec_norm": init_norm(cfg.norm, d, dtype, device)}


class _Block(nn.Module):
    """An encoder or decoder block: one ``ParamDict`` per child of the
    reference's block dict."""

    def __init__(self, p: dict):
        super().__init__()
        for name, leaves in p.items():
            self.add_module(name, ParamDict(leaves))


class Whisper(nn.Module):
    """The model's parameters; ``encode``, ``decoder_train``,
    ``whisper_prefill`` and ``whisper_decode`` run it."""

    def __init__(self, cfg: ArchConfig, tree: dict):
        super().__init__()
        if (len(tree["enc_blocks"]) != cfg.n_enc_layers
                or len(tree["dec_blocks"]) != cfg.n_layers):
            raise ValueError(
                f"{cfg.name}: {len(tree['enc_blocks'])} encoder and "
                f"{len(tree['dec_blocks'])} decoder blocks; the config has "
                f"{cfg.n_enc_layers} and {cfg.n_layers}")
        self.cfg = cfg
        self.embed = ParamDict(tree["embed"])
        pos = tree["pos_dec"]
        self.pos_dec = (pos if isinstance(pos, nn.Parameter)    # as ParamDict
                        else nn.Parameter(pos, requires_grad=False))
        self.enc_blocks = nn.ModuleList(_Block(p) for p in tree["enc_blocks"])
        self.enc_norm = ParamDict(tree["enc_norm"])
        self.dec_blocks = nn.ModuleList(_Block(p) for p in tree["dec_blocks"])
        self.dec_norm = ParamDict(tree["dec_norm"])

    @classmethod
    def from_state_dict(cls, cfg: ArchConfig, state: dict) -> "Whisper":
        """The model whose ``state_dict()`` is ``state``."""
        tree = nest_state_dict(state)
        for name in ("enc_blocks", "dec_blocks"):
            blocks = tree.get(name, {})
            tree[name] = [blocks[str(i)] for i in range(len(blocks))]
        return cls(cfg, tree)


def init_whisper(draw, cfg: ArchConfig, dtype=torch.float32, device=None,
                 max_dec_len: int = 4096) -> Whisper:
    return Whisper(cfg, init_whisper_tree(draw, cfg, dtype, device,
                                          max_dec_len))


def _remat(fn, *args):
    """fn(*args), under non-reentrant checkpoint where a graph is being
    recorded (training); the blocks draw no random numbers."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def _enc_block(blk: _Block, x, cfg: ArchConfig, positions):
    nk, eps = cfg.norm, cfg.norm_eps
    h = apply_norm(blk.attn_norm.p, x, kind=nk, eps=eps)
    x = x + attn.attention_train(blk.attn.p, h, cfg=cfg, positions=positions,
                                 causal=False)
    h = apply_norm(blk.mlp_norm.p, x, kind=nk, eps=eps)
    return x + apply_ffn(blk.mlp.p, h, act=cfg.act)


def _enc_block_group(group: ModelGroup, blocks: list, x, cfg: ArchConfig,
                     positions):
    nk, eps = cfg.norm, cfg.norm_eps
    b0 = blocks[0]
    x = x + lm.attention_block(group, blocks, apply_norm(
        b0["attn_norm"], x, kind=nk, eps=eps), cfg=cfg, positions=positions,
        causal=False)
    return x + lm.ffn_group(group, blocks, apply_norm(
        b0["mlp_norm"], x, kind=nk, eps=eps), cfg=cfg)


def encode(model, frames, *, cfg: ArchConfig):
    """frames: (B, Senc, d) precomputed embeddings -> (B, Senc, d).
    ``model`` is a ``Whisper`` or a data position's ``lm.ModelGroup``."""
    b, s, d = frames.shape
    x = frames + sinusoidal_embedding(s, d, frames.dtype,
                                      frames.device)[None]
    positions = torch.arange(s, dtype=torch.int32,
                             device=frames.device)[None].expand(b, s)
    if isinstance(model, ModelGroup):
        for i in range(cfg.n_enc_layers):
            x = lm.run_checkpointed(
                model, f"enc_blocks.{i}.",
                lambda x_, blocks: _enc_block_group(model, blocks, x_, cfg,
                                                    positions), x)
        return lm.norm_group(model, "enc_norm", x, cfg)
    for blk in model.enc_blocks:
        x = _remat(lambda blk_, x_: _enc_block(blk_, x_, cfg, positions),
                   blk, x)
    return apply_norm(model.enc_norm.p, x, kind=cfg.norm, eps=cfg.norm_eps)


# ---------------------------------------------------------------------------
# decoder: train / prefill / decode
# ---------------------------------------------------------------------------

def _dec_embed(model, tokens, offset: int):
    s = tokens.shape[1]
    if isinstance(model, ModelGroup):
        x = lm.embed_tokens(model, tokens)
        pos = model.blocks[0]["pos_dec"]
    else:
        x, pos = model.embed.emb[tokens.long()], model.pos_dec
    return x + pos[offset:offset + s][None].to(x.dtype)


def _dec_block(blk: _Block, x, enc_out, cfg: ArchConfig, positions,
               return_kv: bool = False):
    """A decoder block over the whole sequence; with return_kv also its
    cache entry (k, v, ck, cv), unpadded."""
    nk, eps = cfg.norm, cfg.norm_eps
    h = apply_norm(blk.self_norm.p, x, kind=nk, eps=eps)
    y = attn.attention_train(blk.self_attn.p, h, cfg=cfg,
                             positions=positions, causal=True,
                             return_kv=return_kv)
    y, kv = y if return_kv else (y, None)
    x = x + y
    h = apply_norm(blk.cross_norm.p, x, kind=nk, eps=eps)
    y = attn.cross_attention_train(blk.cross_attn.p, h, enc_out, cfg=cfg,
                                   return_kv=return_kv)
    y, ckv = y if return_kv else (y, None)
    x = x + y
    h = apply_norm(blk.mlp_norm.p, x, kind=nk, eps=eps)
    x = x + apply_ffn(blk.mlp.p, h, act=cfg.act)
    return (x, kv + ckv) if return_kv else x


def _dec_block_group(group: ModelGroup, blocks: list, x, enc_out,
                     cfg: ArchConfig, positions,
                     mix: lm.GroupMixers = lm.TRAIN_MIXERS):
    """A decoder block over a group, its attentions ``mix``'s
    (``lm._block_group``)."""
    nk, eps = cfg.norm, cfg.norm_eps
    b0 = blocks[0]
    x = x + mix.attention(group, blocks, apply_norm(
        b0["self_norm"], x, kind=nk, eps=eps), cfg=cfg, positions=positions,
        name="self_attn")
    x = x + mix.attention(group, blocks, apply_norm(
        b0["cross_norm"], x, kind=nk, eps=eps), cfg=cfg, positions=positions,
        name="cross_attn", causal=False, kv=enc_out)
    return x + lm.ffn_group(group, blocks, apply_norm(
        b0["mlp_norm"], x, kind=nk, eps=eps), cfg=cfg)


def decoder_train(model, tokens, enc_out, *, cfg: ArchConfig):
    """tokens: (B, Sd) -> hidden (B, Sd, d) after the final norm.
    ``model`` is a ``Whisper`` or a data position's ``lm.ModelGroup``."""
    b, s = tokens.shape
    x = _dec_embed(model, tokens, 0)
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    if isinstance(model, ModelGroup):
        for i in range(cfg.n_layers):
            x = lm.run_checkpointed(
                model, f"dec_blocks.{i}.",
                lambda x_, e_, blocks: _dec_block_group(
                    model, blocks, x_, e_, cfg, positions), x, enc_out)
        return lm.norm_group(model, "dec_norm", x, cfg)
    for blk in model.dec_blocks:
        x = _remat(lambda blk_, x_, e_: _dec_block(blk_, x_, e_, cfg,
                                                   positions),
                   blk, x, enc_out)
    return apply_norm(model.dec_norm.p, x, kind=cfg.norm, eps=cfg.norm_eps)


def init_whisper_cache(cfg: ArchConfig, batch: int, max_len: int,
                       dtype=torch.float32, device=None) -> dict:
    n, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim

    def zeros(length):
        return torch.zeros((n, batch, length, kv, hd), dtype=dtype,
                           device=device)

    return {"len": torch.zeros((batch,), dtype=torch.int32, device=device),
            "k": zeros(max_len), "v": zeros(max_len),
            "ck": zeros(ENC_LEN), "cv": zeros(ENC_LEN)}


def _logits(model: Whisper, x, cfg: ArchConfig):
    x = apply_norm(model.dec_norm.p, x, kind=cfg.norm, eps=cfg.norm_eps)
    return (x[:, -1] @ model.embed.emb.T.to(x.dtype)).float()


@torch.no_grad()
def whisper_prefill(model: Whisper, batch: dict, *, cfg: ArchConfig,
                    max_len: int = 0):
    """batch: {'frames': (B,Senc,d), 'tokens': (B,Sd)}.  Returns (last
    logits, cache); the self-attention cache is sized for max_len tokens
    (the prompt's length if 0)."""
    enc_out = encode(model, batch["frames"], cfg=cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    max_len = max_len or s
    x = _dec_embed(model, tokens, 0)
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    entries = {"k": [], "v": [], "ck": [], "cv": []}
    for blk in model.dec_blocks:
        x, (kc, vc, ck, cv) = _dec_block(blk, x, enc_out, cfg, positions,
                                         return_kv=True)
        entries["k"].append(_pad_seq(kc, max_len).to(x.dtype))
        entries["v"].append(_pad_seq(vc, max_len).to(x.dtype))
        entries["ck"].append(ck.to(x.dtype))
        entries["cv"].append(cv.to(x.dtype))
    cache = {"len": torch.full((b,), s, dtype=torch.int32, device=x.device),
             **{k: torch.stack(v) for k, v in entries.items()}}
    return _logits(model, x, cfg), cache


@torch.no_grad()
def whisper_decode(model: Whisper, cache: dict, batch: dict, *,
                   cfg: ArchConfig):
    """One decode step. batch['tokens']: (B,1).  Returns (logits, cache);
    the cache given is left unchanged."""
    nk, eps = cfg.norm, cfg.norm_eps
    tokens = batch["tokens"]
    cache_len = cache["len"]
    x = model.embed.emb[tokens.long()]
    x = x + model.pos_dec[cache_len.long()][:, None].to(x.dtype)
    new_k, new_v = [], []
    for i, blk in enumerate(model.dec_blocks):
        h = apply_norm(blk.self_norm.p, x, kind=nk, eps=eps)
        y, kc, vc = attn.attention_decode(blk.self_attn.p, h, cache["k"][i],
                                          cache["v"][i], cfg=cfg,
                                          cache_len=cache_len)
        new_k.append(kc)
        new_v.append(vc)
        x = x + y
        h = apply_norm(blk.cross_norm.p, x, kind=nk, eps=eps)
        x = x + attn.cross_attention_decode(blk.cross_attn.p, h,
                                            cache["ck"][i], cache["cv"][i],
                                            cfg=cfg)
        h = apply_norm(blk.mlp_norm.p, x, kind=nk, eps=eps)
        x = x + apply_ffn(blk.mlp.p, h, act=cfg.act)
    new_cache = {"len": cache_len + 1, "k": torch.stack(new_k),
                 "v": torch.stack(new_v), "ck": cache["ck"],
                 "cv": cache["cv"]}
    return _logits(model, x, cfg), new_cache
