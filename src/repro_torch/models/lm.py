"""Decoder-LM assembly: the RWKV-6 serving path of the JAX package's
``models/lm.py``.

An architecture is a list of *groups*; each group is `count` structurally
identical blocks.  The JAX package stacks a group's parameters on a
leading layer axis and runs it with ``lax.scan``; here a group is an
``nn.ModuleList`` of blocks run by a Python loop, and a block's
parameters keep the JAX names (state-dict keys such as
``groups.0.3.tm.mu_x`` for layer 3's ``params["groups"][0]["tm"]["mu_x"]``).
The decode cache keeps the JAX layout: per group ``S`` (n, B, H, hs, hs)
f32 and ``tm``/``cm`` (n, B, d), and ``len`` (B,) int32.

Only the ``rwkv`` group kind is ported; the others raise
``NotImplementedError`` naming the ROADMAP slice that ports them.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import rwkv6 as rwkv
from repro_torch.models.layers.common import ParamDict, apply_norm, init_norm

VOCAB_PAD = 32

# group kinds of the reference that later slices port (ROADMAP §1)
_LATER_SLICE = {
    "std:dense": "slice 11b (dense-attention serving, with K3)",
    "std:moe": "slice 11d (MoE, MLA, Mamba and Whisper)",
    "mla:dense": "slice 11d (MoE, MLA, Mamba and Whisper)",
    "mla:moe": "slice 11d (MoE, MLA, Mamba and Whisper)",
    "period": "slice 11d (MoE, MLA, Mamba and Whisper)",
}


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
        if kind != "rwkv":
            raise NotImplementedError(
                f"{cfg.name}: group kind {kind!r} is not ported to "
                f"repro_torch yet; ROADMAP {_LATER_SLICE[kind]}")
    return plan


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _init_block(draw, kind: str, cfg: ArchConfig, dtype, device) -> dict:
    assert kind == "rwkv", kind
    return {
        "ln1": init_norm(cfg.norm, cfg.d_model, dtype, device),
        "tm": rwkv.init_time_mix(draw, cfg, dtype, device),
        "ln2": init_norm(cfg.norm, cfg.d_model, dtype, device),
        "cm": rwkv.init_channel_mix(draw, cfg, dtype, device),
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
            nn.ModuleList(RWKVBlock(cfg, p) for p in g)
            for g in tree["groups"])

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


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, dtype=torch.float32,
               device=None) -> dict:
    """Zeroed decode cache.  The rwkv cache does not grow with the
    sequence, so it takes no max_len."""
    groups = []
    for kind, n in group_plan(cfg):
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


def _block_prefill(blk: RWKVBlock, x, *, cfg: ArchConfig):
    """Returns (x, cache_entry) matching init_cache leaf layout (minus n)."""
    nk, eps = cfg.norm, cfg.norm_eps
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


def _block_decode(blk: RWKVBlock, x, cache: dict, *, cfg: ArchConfig):
    nk, eps = cfg.norm, cfg.norm_eps
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


def lm_prefill(model: LM, batch: dict, *, cfg: ArchConfig):
    """Run the full prompt, return (last-token logits, filled cache).  The
    rwkv cache does not grow with the sequence, so it needs no max_len."""
    x = embed_tokens(model, batch["tokens"])
    b, s = x.shape[0], x.shape[1]
    groups_cache = []
    for blocks in model.groups:
        entries = []
        for blk in blocks:
            x, entry = _block_prefill(blk, x, cfg=cfg)
            entries.append(entry)
        groups_cache.append(_stack(entries))
    cache = {"len": torch.full((b,), s, dtype=torch.int32, device=x.device),
             "groups": groups_cache}
    return _logits(model, x, cfg), cache


def lm_decode(model: LM, cache: dict, batch: dict, *, cfg: ArchConfig):
    """One decode step. batch['tokens']: (B,1). Returns (logits, cache)."""
    x = embed_tokens(model, batch["tokens"])
    new_groups = []
    for blocks, gcache in zip(model.groups, cache["groups"]):
        entries = []
        for i, blk in enumerate(blocks):
            x, entry = _block_decode(blk, x, {k: v[i]
                                              for k, v in gcache.items()},
                                     cfg=cfg)
            entries.append(entry)
        new_groups.append(_stack(entries))
    return _logits(model, x, cfg), {"len": cache["len"] + 1,
                                    "groups": new_groups}
