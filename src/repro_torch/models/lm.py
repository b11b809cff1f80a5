"""Decoder-LM assembly: the training and serving paths of the JAX
package's ``models/lm.py`` for the RWKV-6, dense GQA, MoE (arctic) and
MLA + MoE (deepseek-v3) families.

An architecture is a list of *groups*; each group is `count` structurally
identical blocks.  The JAX package stacks a group's parameters on a
leading layer axis and runs it with ``lax.scan``; here a group is an
``nn.ModuleList`` of blocks run by a Python loop, and a block's
parameters keep the JAX names (state-dict keys such as
``groups.0.3.tm.mu_x`` for layer 3's ``params["groups"][0]["tm"]["mu_x"]``).
The decode cache keeps the JAX layout: per group ``S`` (n, B, H, hs, hs)
f32 and ``tm``/``cm`` (n, B, d) for ``rwkv``, ``k``/``v`` (n, B, max_len,
KV, hd) for ``std:*``, ``ckv`` (n, B, max_len, kv_lora_rank) and ``kr``
(n, B, max_len, qk_rope_head_dim) for ``mla:*``, and ``len`` (B,) int32.

The ``rwkv``, ``std:dense``, ``std:moe``, ``mla:dense`` and ``mla:moe``
group kinds are ported; ``period`` (jamba) raises
``NotImplementedError`` naming the ROADMAP slice that ports it.
``forward_hidden`` is the training forward: each block runs under
non-reentrant ``torch.utils.checkpoint``, as the reference's under
``jax.checkpoint``, so its activations are recomputed in the backward;
the MoE layers' balance losses are summed through the blocks, as the
reference's scan carries them.  Serving drops them, as the reference
does.
Prefill and decode run under ``torch.no_grad()``: a model made trainable
records no graph while it serves.  Decode is functional, as the
reference's: a step returns a new cache and leaves the one it was given
unchanged, so a dense step copies every layer's KV cache
(``attention_decode``, then the stack of the layers).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import attention as attn
from repro_torch.models.layers import mla as mla_mod
from repro_torch.models.layers import moe as moe_mod
from repro_torch.models.layers import rwkv6 as rwkv
from repro_torch.models.layers.common import ParamDict, apply_norm, init_norm
from repro_torch.models.layers.ffn import apply_ffn, init_ffn
from repro_torch.models.layers.rope import text_mrope_positions

VOCAB_PAD = 32

# group kinds of the reference that later slices port (ROADMAP §1)
_LATER_SLICE = {"period": "slice 11d.3 (Mamba and the jamba period)"}


# ---------------------------------------------------------------------------
# architecture -> group plan
# ---------------------------------------------------------------------------

def _reference_plan(cfg: ArchConfig) -> list[tuple[str, int]]:
    if cfg.block_pattern is not None:
        period = len(cfg.block_pattern)
        assert cfg.n_layers % period == 0
        return [("period", cfg.n_layers // period)]
    if cfg.family == "ssm":
        return [("rwkv", cfg.n_layers)]
    attn_kind = "mla" if cfg.mla is not None else "std"
    if cfg.moe is None:
        return [(f"{attn_kind}:dense", cfg.n_layers)]
    if cfg.moe.layer_mode == "after_prefix":
        return [(f"{attn_kind}:dense", cfg.n_dense_prefix),
                (f"{attn_kind}:moe", cfg.n_layers - cfg.n_dense_prefix)]
    return [(f"{attn_kind}:moe", cfg.n_layers)]


def group_plan(cfg: ArchConfig) -> list[tuple[str, int]]:
    """The reference's group plan; raises for a kind not ported yet."""
    plan = _reference_plan(cfg)
    for kind, _ in plan:
        if kind in _LATER_SLICE:
            raise NotImplementedError(
                f"{cfg.name}: group kind {kind!r} is not ported to "
                f"repro_torch yet; ROADMAP {_LATER_SLICE[kind]}")
    return plan


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _init_block(draw, kind: str, cfg: ArchConfig, dtype, device) -> dict:
    if kind == "rwkv":
        return {
            "ln1": init_norm(cfg.norm, cfg.d_model, dtype, device),
            "tm": rwkv.init_time_mix(draw, cfg, dtype, device),
            "ln2": init_norm(cfg.norm, cfg.d_model, dtype, device),
            "cm": rwkv.init_channel_mix(draw, cfg, dtype, device),
        }
    attn_kind, mlp_kind = kind.split(":")
    # the reference's keys; the mixer draws first, then the FFN
    mixer = (mla_mod.init_mla(draw, cfg, dtype, device) if attn_kind == "mla"
             else attn.init_attention(draw, cfg, dtype, device))
    mlp = (moe_mod.init_moe(draw, cfg, dtype) if mlp_kind == "moe"
           else init_ffn(draw, cfg.d_model, cfg.d_ff, cfg.act, dtype))
    return {
        "attn_norm": init_norm(cfg.norm, cfg.d_model, dtype, device),
        ("attn" if attn_kind == "std" else "mla"): mixer,
        "mlp_norm": init_norm(cfg.norm, cfg.d_model, dtype, device),
        ("moe" if mlp_kind == "moe" else "mlp"): mlp,
    }


def init_lm_tree(draw, cfg: ArchConfig, dtype=torch.float32,
                 device=None) -> dict:
    """The parameter tree with the reference's init scales, one dict per
    layer: {"embed": {"emb"}, "final_norm", ["head": {"w"}], "groups":
    [[block, ...], ...]}.  draw(shape, std) returns f32 normal draws times
    std; it is called in a fixed order."""
    vp = cfg.padded_vocab(VOCAB_PAD)
    plan = group_plan(cfg)
    tree = {"embed": {"emb": draw((vp, cfg.d_model), 0.02).to(dtype)},
            "final_norm": init_norm(cfg.norm, cfg.d_model, dtype, device)}
    if not cfg.tie_embeddings:
        tree["head"] = {"w": draw((cfg.d_model, vp),
                                  cfg.d_model ** -0.5).to(dtype)}
    tree["groups"] = [[_init_block(draw, kind, cfg, dtype, device)
                       for _ in range(count)] for kind, count in plan]
    return tree


class RWKVBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, p: dict):
        super().__init__()
        self.ln1 = ParamDict(p["ln1"])
        self.tm = rwkv.TimeMix(cfg, p["tm"])
        self.ln2 = ParamDict(p["ln2"])
        self.cm = rwkv.ChannelMix(cfg, p["cm"])


class AttnBlock(nn.Module):
    """The ``std:*`` and ``mla:*`` kinds: GQA attention (``attn``) or MLA
    (``mla``), then a dense FFN (``mlp``) or an MoE layer (``moe``), each
    after its norm."""

    def __init__(self, cfg: ArchConfig, p: dict):
        super().__init__()
        for name, leaves in p.items():
            self.add_module(name, ParamDict(leaves))


_BLOCKS = {"rwkv": RWKVBlock, "std:dense": AttnBlock, "std:moe": AttnBlock,
           "mla:dense": AttnBlock, "mla:moe": AttnBlock}


class LM(nn.Module):
    """The model's parameters; ``lm_prefill`` and ``lm_decode`` run it."""

    def __init__(self, cfg: ArchConfig, tree: dict):
        super().__init__()
        plan = group_plan(cfg)
        if len(tree["groups"]) != len(plan) or any(
                len(g) != count for g, (_, count) in zip(tree["groups"],
                                                         plan)):
            raise ValueError(f"{cfg.name}: parameter groups of sizes "
                             f"{[len(g) for g in tree['groups']]} do not "
                             f"match the plan {plan}")
        self.cfg = cfg
        self.embed = ParamDict(tree["embed"])
        self.final_norm = ParamDict(tree["final_norm"])
        if not cfg.tie_embeddings:
            self.head = ParamDict(tree["head"])
        self.groups = nn.ModuleList(
            nn.ModuleList(_BLOCKS[kind](cfg, p) for p in g)
            for g, (kind, _) in zip(tree["groups"], plan))

    @classmethod
    def from_state_dict(cls, cfg: ArchConfig, state: dict) -> "LM":
        """The model whose ``state_dict()`` is ``state``."""
        tree: dict = {}
        for key, t in state.items():
            node = tree
            *path, leaf = key.split(".")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = t
        tree["groups"] = [[g[str(i)] for i in range(len(g))]
                          for _, g in sorted(tree["groups"].items(),
                                             key=lambda kv: int(kv[0]))]
        return cls(cfg, tree)


def init_lm(draw, cfg: ArchConfig, dtype=torch.float32, device=None) -> LM:
    return LM(cfg, init_lm_tree(draw, cfg, dtype, device))


def embed_tokens(model: LM, tokens):
    return model.embed.emb[tokens.long()]


def head_weight(model: LM, cfg: ArchConfig):
    if cfg.tie_embeddings:
        return model.embed.emb.T
    return model.head.w


def make_positions(cfg: ArchConfig, b: int, s: int, offset=0, device=None):
    """(B,S) int32 positions offset..offset+S-1, or M-RoPE's (3,B,S)."""
    pos = torch.arange(s, dtype=torch.int32, device=device)[None].expand(
        b, s) + offset
    if cfg.rope_mode == "mrope":
        return text_mrope_positions(pos)
    return pos


# ---------------------------------------------------------------------------
# block apply — train (no cache)
# ---------------------------------------------------------------------------

def _mixer(blk: AttnBlock, h, *, cfg: ArchConfig, positions,
           return_cache: bool = False):
    """The block's attention (GQA or MLA) on its normed input."""
    if hasattr(blk, "mla"):
        return mla_mod.mla_train(blk.mla.p, h, cfg=cfg, positions=positions,
                                 return_cache=return_cache)
    return attn.attention_train(blk.attn.p, h, cfg=cfg, positions=positions,
                                return_kv=return_cache)


def _mlp_or_moe(blk: AttnBlock, h, *, cfg: ArchConfig):
    """(y, aux): the block's FFN on its normed input, and the MoE
    layer's balance loss (None for a dense FFN)."""
    if hasattr(blk, "moe"):
        return moe_mod.apply_moe(blk.moe.p, h, cfg=cfg)
    return apply_ffn(blk.mlp.p, h, act=cfg.act), None


def _block_train(blk, x, aux, *, cfg: ArchConfig, positions):
    """One block of the training forward, from the zero shift and wkv
    states (the sequence start); returns (x, aux plus the block's MoE
    balance loss)."""
    nk, eps = cfg.norm, cfg.norm_eps
    if isinstance(blk, AttnBlock):
        x = x + _mixer(blk, apply_norm(blk.attn_norm.p, x, kind=nk,
                                       eps=eps), cfg=cfg, positions=positions)
        y, a = _mlp_or_moe(blk, apply_norm(blk.mlp_norm.p, x, kind=nk,
                                           eps=eps), cfg=cfg)
        return x + y, aux if a is None else aux + a
    b, _, d = x.shape
    h, hs = cfg.d_model // cfg.rwkv.head_size, cfg.rwkv.head_size
    zshift = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    zstate = torch.zeros((b, h, hs, hs), dtype=torch.float32,
                         device=x.device)
    y, _, _ = blk.tm(apply_norm(blk.ln1.p, x, kind=nk, eps=eps), zshift,
                     zstate)
    x = x + y
    y, _ = blk.cm(apply_norm(blk.ln2.p, x, kind=nk, eps=eps), zshift)
    return x + y, aux


def forward_hidden(model: LM, embeds, *, cfg: ArchConfig, positions):
    """embeds: (B,S,d) -> (hidden (B,S,d) after the final norm, aux).
    Each block is checkpointed (its forward runs again in the backward);
    aux is the sum of the MoE layers' balance losses, 0 without MoE."""
    x = embeds
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blocks in model.groups:
        for blk in blocks:
            # the blocks draw no random numbers: no RNG state to keep
            x, aux = checkpoint(_block_train, blk, x, aux, cfg=cfg,
                                positions=positions, use_reentrant=False,
                                preserve_rng_state=False)
    x = apply_norm(model.final_norm.p, x, kind=cfg.norm, eps=cfg.norm_eps)
    return x, aux


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.float32, device=None) -> dict:
    """Zeroed decode cache sized for `max_len` tokens (the rwkv cache does
    not grow with the sequence and ignores it)."""
    groups = []
    for kind, n in group_plan(cfg):
        if kind.startswith("std"):
            groups.append(attn.init_kv_cache(cfg, n, batch, max_len, dtype,
                                             device))
            continue
        if kind.startswith("mla"):
            groups.append(mla_mod.init_latent_cache(cfg, n, batch, max_len,
                                                    dtype, device))
            continue
        h = cfg.d_model // cfg.rwkv.head_size
        hs = cfg.rwkv.head_size
        groups.append({
            "S": torch.zeros((n, batch, h, hs, hs), dtype=torch.float32,
                             device=device),
            "tm": torch.zeros((n, batch, cfg.d_model), dtype=dtype,
                              device=device),
            "cm": torch.zeros((n, batch, cfg.d_model), dtype=dtype,
                              device=device)})
    return {"len": torch.zeros((batch,), dtype=torch.int32, device=device),
            "groups": groups}


def _pad_seq(a, max_len: int):
    """Zero-pad the sequence axis (axis 1) of `a` to max_len."""
    if a.shape[1] == max_len:
        return a
    out = a.new_zeros((a.shape[0], max_len) + tuple(a.shape[2:]))
    out[:, :a.shape[1]] = a
    return out


def _block_prefill(blk, x, *, cfg: ArchConfig, positions, max_len: int):
    """Returns (x, cache_entry) matching init_cache leaf layout (minus n)."""
    nk, eps = cfg.norm, cfg.norm_eps
    if isinstance(blk, AttnBlock):
        y, cache = _mixer(blk, apply_norm(blk.attn_norm.p, x, kind=nk,
                                          eps=eps), cfg=cfg,
                          positions=positions, return_cache=True)
        names = ("ckv", "kr") if hasattr(blk, "mla") else ("k", "v")
        entry = {n: _pad_seq(c, max_len).to(x.dtype)
                 for n, c in zip(names, cache)}
        x = x + y
        y, _ = _mlp_or_moe(blk, apply_norm(blk.mlp_norm.p, x, kind=nk,
                                           eps=eps), cfg=cfg)
        return x + y, entry
    b, _, d = x.shape
    h, hs = cfg.d_model // cfg.rwkv.head_size, cfg.rwkv.head_size
    zshift = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    zstate = torch.zeros((b, h, hs, hs), dtype=torch.float32,
                         device=x.device)
    y, tm_shift, S = blk.tm(apply_norm(blk.ln1.p, x, kind=nk, eps=eps),
                            zshift, zstate)
    x = x + y
    y, cm_shift = blk.cm(apply_norm(blk.ln2.p, x, kind=nk, eps=eps), zshift)
    return x + y, {"S": S, "tm": tm_shift.to(x.dtype),
                   "cm": cm_shift.to(x.dtype)}


def _block_decode(blk, x, cache: dict, *, cfg: ArchConfig, cache_len):
    nk, eps = cfg.norm, cfg.norm_eps
    if isinstance(blk, AttnBlock):
        h = apply_norm(blk.attn_norm.p, x, kind=nk, eps=eps)
        if hasattr(blk, "mla"):
            y, ckv, kr = mla_mod.mla_decode(blk.mla.p, h, cache["ckv"],
                                            cache["kr"], cfg=cfg,
                                            cache_len=cache_len)
            entry = {"ckv": ckv, "kr": kr}
        else:
            y, kc, vc = attn.attention_decode(blk.attn.p, h, cache["k"],
                                              cache["v"], cfg=cfg,
                                              cache_len=cache_len)
            entry = {"k": kc, "v": vc}
        x = x + y
        y, _ = _mlp_or_moe(blk, apply_norm(blk.mlp_norm.p, x, kind=nk,
                                           eps=eps), cfg=cfg)
        return x + y, entry
    y, tm_shift, S = blk.tm.decode(
        apply_norm(blk.ln1.p, x, kind=nk, eps=eps),
        cache["tm"].to(x.dtype), cache["S"])
    x = x + y
    y, cm_shift = blk.cm(apply_norm(blk.ln2.p, x, kind=nk, eps=eps),
                         cache["cm"].to(x.dtype))
    return x + y, {"S": S, "tm": tm_shift.to(x.dtype),
                   "cm": cm_shift.to(x.dtype)}


def _stack(entries: list[dict]) -> dict:
    return {k: torch.stack([e[k] for e in entries]) for k in entries[0]}


def _logits(model: LM, x, cfg: ArchConfig):
    x = apply_norm(model.final_norm.p, x, kind=cfg.norm, eps=cfg.norm_eps)
    return (x[:, -1] @ head_weight(model, cfg).to(x.dtype)).float()


def _inputs(model: LM, batch: dict):
    """The batch's precomputed embeddings (``embeds``, the vision
    frontend's stub) or its embedded ``tokens``."""
    if "embeds" in batch:
        return batch["embeds"]
    return embed_tokens(model, batch["tokens"])


@torch.no_grad()
def lm_prefill(model: LM, batch: dict, *, cfg: ArchConfig, max_len: int = 0):
    """Run the full prompt, return (last-token logits, filled cache); the
    KV caches are sized for max_len tokens (the prompt's length if 0)."""
    x = _inputs(model, batch)
    b, s = x.shape[0], x.shape[1]
    max_len = max_len or s
    positions = make_positions(cfg, b, s, device=x.device)
    groups_cache = []
    for blocks in model.groups:
        entries = []
        for blk in blocks:
            x, entry = _block_prefill(blk, x, cfg=cfg, positions=positions,
                                      max_len=max_len)
            entries.append(entry)
        groups_cache.append(_stack(entries))
    cache = {"len": torch.full((b,), s, dtype=torch.int32, device=x.device),
             "groups": groups_cache}
    return _logits(model, x, cfg), cache


@torch.no_grad()
def lm_decode(model: LM, cache: dict, batch: dict, *, cfg: ArchConfig):
    """One decode step. batch['tokens'] or ['embeds']: (B,1)[,d].  Returns
    (logits, cache)."""
    x = _inputs(model, batch)
    cache_len = cache["len"]
    new_groups = []
    for blocks, gcache in zip(model.groups, cache["groups"]):
        entries = []
        for i, blk in enumerate(blocks):
            x, entry = _block_decode(blk, x, {k: v[i]
                                              for k, v in gcache.items()},
                                     cfg=cfg, cache_len=cache_len)
            entries.append(entry)
        new_groups.append(_stack(entries))
    return _logits(model, x, cfg), {"len": cache_len + 1,
                                    "groups": new_groups}
