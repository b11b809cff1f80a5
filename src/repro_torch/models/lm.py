"""Decoder-LM assembly: the serving paths of the JAX package's
``models/lm.py`` for the RWKV-6 and dense GQA families.

An architecture is a list of *groups*; each group is `count` structurally
identical blocks.  The JAX package stacks a group's parameters on a
leading layer axis and runs it with ``lax.scan``; here a group is an
``nn.ModuleList`` of blocks run by a Python loop, and a block's
parameters keep the JAX names (state-dict keys such as
``groups.0.3.tm.mu_x`` for layer 3's ``params["groups"][0]["tm"]["mu_x"]``).
The decode cache keeps the JAX layout: per group ``S`` (n, B, H, hs, hs)
f32 and ``tm``/``cm`` (n, B, d) for ``rwkv``, ``k``/``v`` (n, B, max_len,
KV, hd) for ``std:dense``, and ``len`` (B,) int32.

The ``rwkv`` and ``std:dense`` group kinds are ported; the others raise
``NotImplementedError`` naming the ROADMAP slice that ports them.
Decode is functional, as the reference's: a step returns a new cache and
leaves the one it was given unchanged, so a dense step copies every
layer's KV cache (``attention_decode``, then the stack of the layers).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import attention as attn
from repro_torch.models.layers import rwkv6 as rwkv
from repro_torch.models.layers.common import ParamDict, apply_norm, init_norm
from repro_torch.models.layers.ffn import apply_ffn, init_ffn
from repro_torch.models.layers.rope import text_mrope_positions

VOCAB_PAD = 32

# group kinds of the reference that later slices port (ROADMAP §1)
_LATER_SLICE = {
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
        if kind not in ("rwkv", "std:dense"):
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
    assert kind == "std:dense", kind
    return {
        "attn_norm": init_norm(cfg.norm, cfg.d_model, dtype, device),
        "attn": attn.init_attention(draw, cfg, dtype, device),
        "mlp_norm": init_norm(cfg.norm, cfg.d_model, dtype, device),
        "mlp": init_ffn(draw, cfg.d_model, cfg.d_ff, cfg.act, dtype),
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


class DenseBlock(nn.Module):
    """GQA attention and a dense FFN, each after its norm."""

    def __init__(self, cfg: ArchConfig, p: dict):
        super().__init__()
        self.attn_norm = ParamDict(p["attn_norm"])
        self.attn = ParamDict(p["attn"])
        self.mlp_norm = ParamDict(p["mlp_norm"])
        self.mlp = ParamDict(p["mlp"])


_BLOCKS = {"rwkv": RWKVBlock, "std:dense": DenseBlock}


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
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.float32, device=None) -> dict:
    """Zeroed decode cache sized for `max_len` tokens (the rwkv cache does
    not grow with the sequence and ignores it)."""
    groups = []
    for kind, n in group_plan(cfg):
        if kind == "std:dense":
            groups.append(attn.init_kv_cache(cfg, n, batch, max_len, dtype,
                                             device))
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
    if isinstance(blk, DenseBlock):
        y, (kc, vc) = attn.attention_train(
            blk.attn.p, apply_norm(blk.attn_norm.p, x, kind=nk, eps=eps),
            cfg=cfg, positions=positions, return_kv=True)
        entry = {"k": _pad_seq(kc, max_len).to(x.dtype),
                 "v": _pad_seq(vc, max_len).to(x.dtype)}
        x = x + y
        y = apply_ffn(blk.mlp.p, apply_norm(blk.mlp_norm.p, x, kind=nk,
                                            eps=eps), act=cfg.act)
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
    if isinstance(blk, DenseBlock):
        y, kc, vc = attn.attention_decode(
            blk.attn.p, apply_norm(blk.attn_norm.p, x, kind=nk, eps=eps),
            cache["k"], cache["v"], cfg=cfg, cache_len=cache_len)
        x = x + y
        y = apply_ffn(blk.mlp.p, apply_norm(blk.mlp_norm.p, x, kind=nk,
                                            eps=eps), act=cfg.act)
        return x + y, {"k": kc, "v": vc}
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
