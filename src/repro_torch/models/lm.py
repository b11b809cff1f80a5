"""Decoder-LM assembly: the training and serving paths of the JAX
package's ``models/lm.py`` for every decoder family: RWKV-6, the dense
GQA models, the MoE (arctic) and MLA + MoE (deepseek-v3) families, and
jamba's hybrid period.

An architecture is a list of *groups*; each group is `count` structurally
identical blocks.  The JAX package stacks a group's parameters on a
leading layer axis and runs it with ``lax.scan``; here a group is an
``nn.ModuleList`` of blocks run by a Python loop, and a block's
parameters keep the JAX names (state-dict keys such as
``groups.0.3.tm.mu_x`` for layer 3's ``params["groups"][0]["tm"]["mu_x"]``,
``groups.0.1.sub4.attn.wq`` for a period's sublayer 4).
The decode cache keeps the JAX layout: per group ``S`` (n, B, H, hs, hs)
f32 and ``tm``/``cm`` (n, B, d) for ``rwkv``, ``k``/``v`` (n, B, max_len,
KV, hd) for ``std:*``, ``ckv`` (n, B, max_len, kv_lora_rank) and ``kr``
(n, B, max_len, qk_rope_head_dim) for ``mla:*``, ``k``/``v`` beside ``h``
(n, n_mamba, B, di, ds) f32 and ``conv`` (n, n_mamba, B, K-1, di) for
``period``, and ``len`` (B,) int32.

Group kinds: ``rwkv``, ``std:dense``, ``std:moe``, ``mla:dense``,
``mla:moe`` and ``period`` (jamba: 8 sublayers, attention at index 4 of
its pattern and Mamba elsewhere, an MoE layer on every odd sublayer).
``forward_hidden`` is the training forward: each block (a whole period
for ``period``) runs under non-reentrant ``torch.utils.checkpoint``, as
the reference's under ``jax.checkpoint``, so its activations are
recomputed in the backward; it returns the MoE layers' router
statistics layer by layer (``moe.moe_layer``), which the factory turns
into the balance loss, summed over the layers as the reference's scan
carries it, after the sharded step has summed them over its data
positions.  Under the sharded step's model axis ``forward_hidden`` takes
a data position's ``ModelGroup`` (the ``rwkv`` and ``std:dense`` kinds):
each block's model positions run on their blocks of the parameters
inside one checkpoint of that block (``_GroupCheckpoint``).  Serving drops them, as the reference does.
Prefill and decode run under ``torch.no_grad()``: a model made trainable
records no graph while it serves.  Decode is functional, as the
reference's: a step returns a new cache and leaves the one it was given
unchanged, so a dense step copies every layer's KV cache
(``attention_decode``, then the stack of the layers).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import attention as attn
from repro_torch.models.layers import mamba as mam
from repro_torch.models.layers import mla as mla_mod
from repro_torch.models.layers import moe as moe_mod
from repro_torch.models.layers import rwkv6 as rwkv
from repro_torch.models.layers.common import (ParamDict, apply_norm,
                                              init_norm, nest_state_dict)
from repro_torch.models.layers.ffn import apply_ffn, init_ffn
from repro_torch.models.layers.rope import text_mrope_positions
from repro_torch.parallelism.tensor import col_cat, fan_out, row_sum

VOCAB_PAD = 32


# ---------------------------------------------------------------------------
# architecture -> group plan
# ---------------------------------------------------------------------------

def group_plan(cfg: ArchConfig) -> list[tuple[str, int]]:
    """[(group kind, blocks), ...], the reference's plan."""
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
    if kind == "period":
        # per sublayer the mixer draws first, then the FFN
        p = {}
        for i, sub in enumerate(cfg.block_pattern):
            mixer = (attn.init_attention(draw, cfg, dtype, device)
                     if sub == "attn"
                     else mam.init_mamba(draw, cfg, dtype, device))
            # MoE on odd sublayers, whatever the MoE config's layer_mode
            is_moe = cfg.moe is not None and i % 2 == 1
            mlp = (moe_mod.init_moe(draw, cfg, dtype) if is_moe
                   else init_ffn(draw, cfg.d_model, cfg.d_ff, cfg.act,
                                 dtype))
            p[f"sub{i}"] = {
                "norm": init_norm(cfg.norm, cfg.d_model, dtype, device),
                ("attn" if sub == "attn" else "mamba"): mixer,
                "mlp_norm": init_norm(cfg.norm, cfg.d_model, dtype, device),
                ("moe" if is_moe else "mlp"): mlp,
            }
        return p
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


class PeriodSub(nn.Module):
    """A period's sublayer: ``norm``, its mixer (``attn``, GQA, or
    ``mamba``), ``mlp_norm`` and its FFN (``moe`` or ``mlp``)."""

    def __init__(self, cfg: ArchConfig, p: dict):
        super().__init__()
        for name, leaves in p.items():
            self.add_module(name, mam.Mamba(cfg, leaves) if name == "mamba"
                            else ParamDict(leaves))


class PeriodBlock(nn.Module):
    """The ``period`` kind (jamba): sublayers ``sub0`` ... ``sub{n-1}``
    of ``cfg.block_pattern``, its children in that order."""

    def __init__(self, cfg: ArchConfig, p: dict):
        super().__init__()
        for i in range(len(cfg.block_pattern)):
            self.add_module(f"sub{i}", PeriodSub(cfg, p[f"sub{i}"]))


_BLOCKS = {"rwkv": RWKVBlock, "std:dense": AttnBlock, "std:moe": AttnBlock,
           "mla:dense": AttnBlock, "mla:moe": AttnBlock,
           "period": PeriodBlock}


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
        tree = nest_state_dict(state)
        tree["groups"] = [[g[str(i)] for i in range(len(g))]
                          for _, g in sorted(tree["groups"].items(),
                                             key=lambda kv: int(kv[0]))]
        return cls(cfg, tree)


def init_lm(draw, cfg: ArchConfig, dtype=torch.float32, device=None) -> LM:
    return LM(cfg, init_lm_tree(draw, cfg, dtype, device))


class ModelGroup(NamedTuple):
    """The model-axis group of one data position of the sharded train
    step: ``blocks[j]`` is model position j's {parameter name: its block}
    (``parallelism/sharding.py:param_blocks``), on ``devices[j]``.  The
    activations between the layers live on ``devices[0]``."""
    blocks: list
    devices: list

    @property
    def tp(self) -> int:
        return len(self.blocks)

    def split(self, n: int) -> bool:
        """Whether the model axis splits a dimension of n (the rules'
        ``tp_if``)."""
        return n % self.tp == 0

    def layer(self, prefix: str) -> list:
        """Each position's leaves under ``prefix`` ("groups.0.3."), by
        their remaining names ("attn.wq")."""
        n = len(prefix)
        return [{k[n:]: t for k, t in bj.items() if k.startswith(prefix)}
                for bj in self.blocks]


def embed_tokens(model, tokens):
    """The rows of ``emb`` for ``tokens``: of the whole table, or for a
    ``ModelGroup`` each model position's d_model block of it (the rules'
    (None, tp(d_model))), joined by ``col_cat``, on the group's first
    device."""
    if not isinstance(model, ModelGroup):
        return model.embed.emb[tokens.long()]
    ids = tokens.long()
    embs = [bj["embed.emb"] for bj in model.blocks]
    d_model = model.blocks[0]["final_norm.scale"].shape[0]
    if embs[0].shape[1] == d_model:          # replicated: looked up once
        return embs[0][ids]
    return col_cat([e[ids.to(e.device)] for e in embs], model.devices)[0]


def head_weight(model, cfg: ArchConfig):
    """The head (d, V); for a ``ModelGroup`` whose model axis splits the
    vocab (the rules' (None, tp(padded_vocab))), the list of its
    positions' column blocks, which ``loss.chunked_cross_entropy`` takes
    vocab-parallel."""
    if isinstance(model, ModelGroup):        # untied (train_step checks)
        ws = [bj["head.w"] for bj in model.blocks]
        return ws if ws[0].shape[1] < cfg.padded_vocab(VOCAB_PAD) else ws[0]
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


def _mlp_or_moe(blk: AttnBlock, h, *, cfg: ArchConfig, moe_groups=1):
    """(y, stats): the block's FFN on its normed input, and the MoE
    layer's router statistics (None for a dense FFN)."""
    if hasattr(blk, "moe"):
        return moe_mod.moe_layer(blk.moe.p, h, cfg=cfg, groups=moe_groups)
    return apply_ffn(blk.mlp.p, h, act=cfg.act), None


def _zero_mamba_states(cfg: ArchConfig, x):
    """The sequence start's conv state (B, K-1, di) in x's dtype and SSM
    state (B, di, ds) f32."""
    b = x.shape[0]
    di = cfg.ssm.expand * cfg.d_model
    return (torch.zeros((b, cfg.ssm.d_conv - 1, di), dtype=x.dtype,
                        device=x.device),
            torch.zeros((b, di, cfg.ssm.d_state), dtype=torch.float32,
                        device=x.device))


def _period(blk: PeriodBlock, x, *, cfg: ArchConfig, positions, max_len=0,
            cache: dict | None = None, cache_len=None, stats=None,
            moe_groups=1):
    """A period's sublayers in order.  Training and prefill (``cache``
    None) start every Mamba from the zero states and attention from
    position 0; prefill (max_len > 0) also returns the cache entry
    {"k", "v", "h", "conv"} with k/v padded to max_len.  Decode steps
    from ``cache``.  The MoE layers' router statistics are appended to
    ``stats`` when it is a list.  Returns (x, cache entry or None)."""
    nk, eps = cfg.norm, cfg.norm_eps
    hs, convs, kv = [], [], None
    midx = 0
    for sp in blk.children():
        h = apply_norm(sp.norm.p, x, kind=nk, eps=eps)
        if hasattr(sp, "attn"):
            if cache is not None:
                y, kc, vc = attn.attention_decode(
                    sp.attn.p, h, cache["k"], cache["v"], cfg=cfg,
                    cache_len=cache_len)
                kv = (kc, vc)
            elif max_len:
                y, (kc, vc) = attn.attention_train(
                    sp.attn.p, h, cfg=cfg, positions=positions,
                    return_kv=True)
                kv = (_pad_seq(kc, max_len).to(x.dtype),
                      _pad_seq(vc, max_len).to(x.dtype))
            else:
                y = attn.attention_train(sp.attn.p, h, cfg=cfg,
                                         positions=positions)
        else:
            if cache is not None:
                y, conv_s, h_s = sp.mamba.decode(
                    h, cache["conv"][midx].to(x.dtype), cache["h"][midx])
            else:
                y, conv_s, h_s = sp.mamba(h, *_zero_mamba_states(cfg, x))
            hs.append(h_s)
            convs.append(conv_s.to(x.dtype))
            midx += 1
        x = x + y
        y, st = _mlp_or_moe(sp, apply_norm(sp.mlp_norm.p, x, kind=nk,
                                           eps=eps), cfg=cfg,
                            moe_groups=moe_groups)
        x = x + y
        if st is not None and stats is not None:
            stats.append(st)
    if cache is None and not max_len:
        return x, None
    return x, {"k": kv[0], "v": kv[1], "h": torch.stack(hs),
               "conv": torch.stack(convs)}


def _block_train(blk, x, *, cfg: ArchConfig, positions, moe_groups=1):
    """One block of the training forward, from the zero shift, wkv, conv
    and SSM states (the sequence start); returns (x, the block's MoE
    router statistics as a tuple, empty without MoE)."""
    nk, eps = cfg.norm, cfg.norm_eps
    if isinstance(blk, PeriodBlock):
        stats = []
        x, _ = _period(blk, x, cfg=cfg, positions=positions, stats=stats,
                       moe_groups=moe_groups)
        return x, tuple(stats)
    if isinstance(blk, AttnBlock):
        x = x + _mixer(blk, apply_norm(blk.attn_norm.p, x, kind=nk,
                                       eps=eps), cfg=cfg, positions=positions)
        y, st = _mlp_or_moe(blk, apply_norm(blk.mlp_norm.p, x, kind=nk,
                                            eps=eps), cfg=cfg,
                            moe_groups=moe_groups)
        return x + y, () if st is None else (st,)
    b, _, d = x.shape
    h, hs = cfg.d_model // cfg.rwkv.head_size, cfg.rwkv.head_size
    zshift = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    zstate = torch.zeros((b, h, hs, hs), dtype=torch.float32,
                         device=x.device)
    y, _, _ = blk.tm(apply_norm(blk.ln1.p, x, kind=nk, eps=eps), zshift,
                     zstate)
    x = x + y
    y, _ = blk.cm(apply_norm(blk.ln2.p, x, kind=nk, eps=eps), zshift)
    return x + y, ()


def _split(group: ModelGroup, blocks: list, fn, *args):
    """fn(block, *args) once per model position, each on its block and
    its copy of ``args`` (``fan_out``), the partials added by
    ``row_sum``: the column- and row-split leaves.  Returns the sum on
    the first device."""
    fanned = [fan_out(a, group.devices) for a in args]
    parts = [fn(bj, *(f[j] for f in fanned)) for j, bj in enumerate(blocks)]
    return row_sum(parts, group.devices)[0]


def _block_train_group(kind: str, group: ModelGroup, blocks: list, x, *,
                       cfg: ArchConfig, positions):
    """One block of the training forward over the model-axis group of
    one data position: ``blocks[j]`` is the layer's leaves at model
    position j (``ModelGroup.layer``), ``x`` on the group's first device.
    The leaves the model axis replicates (the norms, RWKV's token shift
    and decay LoRA, its channel mix's receptance, an FFN whose d_ff it
    does not divide) run once, on position 0's copy; the split ones run
    once per position, their partials added in position order."""
    nk, eps = cfg.norm, cfg.norm_eps
    b0 = blocks[0]
    if kind == "rwkv":
        b, _, d = x.shape
        hs = cfg.rwkv.head_size
        zshift = torch.zeros((b, d), dtype=x.dtype, device=x.device)
        inputs = rwkv.time_mix_inputs(b0["tm"], apply_norm(
            b0["ln1"], x, kind=nk, eps=eps), zshift)

        def heads(bj, *inp):
            h = bj["tm"]["wr"].shape[1] // hs
            zstate = torch.zeros((b, h, hs, hs), dtype=torch.float32,
                                 device=inp[0].device)
            return rwkv.time_mix_heads(bj["tm"], inp, zstate, cfg=cfg)[0]

        x = x + _split(group, blocks, heads, *inputs)
        xk, xr = rwkv.channel_mix_inputs(b0["cm"], apply_norm(
            b0["ln2"], x, kind=nk, eps=eps), zshift)
        if group.split(cfg.d_ff):
            kv = _split(group, blocks,
                        lambda bj, a: rwkv.channel_mix_kv(bj["cm"], a), xk)
        else:
            kv = rwkv.channel_mix_kv(b0["cm"], xk)
        return x + rwkv.channel_mix_gate(b0["cm"], xr, kv)
    hl = b0["attn"]["wq"].shape[1]
    hs = fan_out(apply_norm(b0["attn_norm"], x, kind=nk, eps=eps),
                 group.devices)
    parts = [attn.attention_heads(bj["attn"], h, cfg=cfg,
                                  positions=positions.to(h.device),
                                  head0=j * hl)
             for j, (bj, h) in enumerate(zip(blocks, hs))]
    x = x + row_sum(parts, group.devices)[0]
    h = apply_norm(b0["mlp_norm"], x, kind=nk, eps=eps)
    if group.split(cfg.d_ff):
        y = _split(group, blocks,
                   lambda bj, a: apply_ffn(bj["mlp"], a, act=cfg.act), h)
    else:
        y = apply_ffn(b0["mlp"], h, act=cfg.act)
    return x + y


class _GroupCheckpoint(torch.autograd.Function):
    """One block of a ``ModelGroup``'s forward, checkpointed: ``fn(x,
    blocks)`` runs without a graph, and the backward runs it again, once,
    on the thread that receives the block's output gradient, then
    differentiates that run.  (``torch.utils.checkpoint`` recomputes from
    whichever autograd device thread first unpacks a saved tensor, and the
    threads of two cards race there when one block spans them.)  The
    layer's leaves come flat, ``keys[i]`` = (model position, name) of
    ``tensors[i]``."""

    @staticmethod
    def forward(ctx, fn, keys, x, *tensors):
        ctx.fn, ctx.keys = fn, keys
        ctx.save_for_backward(x, *tensors)
        with torch.no_grad():
            return fn(x, _nested_blocks(keys, tensors))

    @staticmethod
    def backward(ctx, dout):
        need = ctx.needs_input_grad[2:]
        ins = [t.detach().requires_grad_(n)
               for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            out = ctx.fn(ins[0], _nested_blocks(ctx.keys, ins[1:]))
        got = iter(torch.autograd.grad(out, [t for t, n in zip(ins, need)
                                             if n], dout, allow_unused=True))
        return (None, None) + tuple(next(got) if n else None for n in need)


def _nested_blocks(keys, tensors) -> list:
    """Each model position's leaves, nested by name ({"attn": {"wq":
    ...}}), from ``_GroupCheckpoint``'s flat keys and tensors."""
    flat = [{} for _ in range(keys[-1][0] + 1)]
    for (j, name), t in zip(keys, tensors):
        flat[j][name] = t
    return [nest_state_dict(f) for f in flat]


def _forward_hidden_group(group: ModelGroup, embeds, *, cfg: ArchConfig,
                          positions):
    """``forward_hidden`` of a ``ModelGroup``: every block's model
    positions inside one checkpoint of that block (``_GroupCheckpoint``),
    so its recompute in the backward repeats the same sums in the same
    order."""
    x = embeds
    for gi, (kind, count) in enumerate(group_plan(cfg)):
        for i in range(count):
            flat = group.layer(f"groups.{gi}.{i}.")
            keys = [(j, n) for j, f in enumerate(flat) for n in f]

            def block(x, blocks, kind=kind):
                return _block_train_group(kind, group, blocks, x, cfg=cfg,
                                          positions=positions)

            x = _GroupCheckpoint.apply(block, keys, x,
                                       *(flat[j][n] for j, n in keys))
    final = group.layer("final_norm.")[0]
    return apply_norm(nest_state_dict(final), x, kind=cfg.norm,
                      eps=cfg.norm_eps), []


def forward_hidden(model, embeds, *, cfg: ArchConfig, positions,
                   moe_groups: int = 1):
    """embeds: (B,S,d) -> (hidden (B,S,d) after the final norm, stats).
    Each block is checkpointed (its forward runs again in the backward);
    stats lists the MoE layers' router statistics in layer order, each
    (2, E) f32 (``moe.moe_layer``, its tokens in ``moe_groups`` groups),
    and is empty without MoE.  ``model`` is an ``LM``, or the
    ``ModelGroup`` of one data position of the sharded train step (the
    ``rwkv`` and ``std:dense`` kinds, heads split by the model axis)."""
    if isinstance(model, ModelGroup):
        return _forward_hidden_group(model, embeds, cfg=cfg,
                                     positions=positions)
    x = embeds
    stats = []
    for blocks in model.groups:
        for blk in blocks:
            # the blocks draw no random numbers: no RNG state to keep
            x, st = checkpoint(_block_train, blk, x, cfg=cfg,
                               positions=positions, moe_groups=moe_groups,
                               use_reentrant=False,
                               preserve_rng_state=False)
            stats.extend(st)
    x = apply_norm(model.final_norm.p, x, kind=cfg.norm, eps=cfg.norm_eps)
    return x, stats


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.float32, device=None) -> dict:
    """Zeroed decode cache sized for `max_len` tokens (the rwkv cache does
    not grow with the sequence and ignores it)."""
    groups = []
    for kind, n in group_plan(cfg):
        if kind == "period":
            nm = sum(sub == "mamba" for sub in cfg.block_pattern)
            di = cfg.ssm.expand * cfg.d_model
            g = attn.init_kv_cache(cfg, n, batch, max_len, dtype, device)
            g["h"] = torch.zeros((n, nm, batch, di, cfg.ssm.d_state),
                                 dtype=torch.float32, device=device)
            g["conv"] = torch.zeros((n, nm, batch, cfg.ssm.d_conv - 1, di),
                                    dtype=dtype, device=device)
            groups.append(g)
            continue
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
    if isinstance(blk, PeriodBlock):
        x, entry = _period(blk, x, cfg=cfg, positions=positions,
                           max_len=max_len)
        return x, entry
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
    if isinstance(blk, PeriodBlock):
        x, entry = _period(blk, x, cfg=cfg, positions=None, cache=cache,
                           cache_len=cache_len)
        return x, entry
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
