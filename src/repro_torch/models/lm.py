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
positions.  Under the sharded step's mesh ``forward_hidden`` takes a
data position's ``ModelGroup`` (every kind, whatever the model axis does
to its heads, MLA's heads, Mamba's d_inner and the FFNs' widths; the MoE
layers' experts wherever the rules place them, ``Experts``; Whisper's
blocks run the same way, ``models/whisper.py``): each block's model
positions run on their blocks of the parameters inside one checkpoint of
that block (``_GroupCheckpoint``, ``run_checkpointed``).  Serving drops
them, as the reference does.
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
from repro_torch.parallelism.tensor import fan_out, join, row_sum

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

def _init_period_sub(draw, cfg: ArchConfig, i: int, dtype, device) -> dict:
    """Sublayer i of a period: its mixer draws first, then its FFN."""
    sub = cfg.block_pattern[i]
    mixer = (attn.init_attention(draw, cfg, dtype, device) if sub == "attn"
             else mam.init_mamba(draw, cfg, dtype, device))
    # MoE on odd sublayers, whatever the MoE config's layer_mode
    is_moe = cfg.moe is not None and i % 2 == 1
    mlp = (moe_mod.init_moe(draw, cfg, dtype) if is_moe
           else init_ffn(draw, cfg.d_model, cfg.d_ff, cfg.act, dtype))
    return {"norm": init_norm(cfg.norm, cfg.d_model, dtype, device),
            ("attn" if sub == "attn" else "mamba"): mixer,
            "mlp_norm": init_norm(cfg.norm, cfg.d_model, dtype, device),
            ("moe" if is_moe else "mlp"): mlp}


def _init_block(draw, kind: str, cfg: ArchConfig, dtype, device) -> dict:
    if kind == "rwkv":
        return {
            "ln1": init_norm(cfg.norm, cfg.d_model, dtype, device),
            "tm": rwkv.init_time_mix(draw, cfg, dtype, device),
            "ln2": init_norm(cfg.norm, cfg.d_model, dtype, device),
            "cm": rwkv.init_channel_mix(draw, cfg, dtype, device),
        }
    if kind == "period":
        return {f"sub{i}": _init_period_sub(draw, cfg, i, dtype, device)
                for i in range(len(cfg.block_pattern))}
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


def init_lm_parts(draw, cfg: ArchConfig, dtype=torch.float32, device=None):
    """``init_lm_tree``'s parameters in the order it draws them, one part
    at a time: (name prefix, subtree) pairs, the embedding, the final
    norm, the head, then each block in order (a period sublayer by
    sublayer), so that a caller can place each part before the next is
    drawn."""
    vp = cfg.padded_vocab(VOCAB_PAD)
    yield "embed", {"emb": draw((vp, cfg.d_model), 0.02).to(dtype)}
    yield "final_norm", init_norm(cfg.norm, cfg.d_model, dtype, device)
    if not cfg.tie_embeddings:
        yield "head", {"w": draw((cfg.d_model, vp),
                                 cfg.d_model ** -0.5).to(dtype)}
    for g, (kind, count) in enumerate(group_plan(cfg)):
        for i in range(count):
            if kind == "period":
                for k in range(len(cfg.block_pattern)):
                    yield (f"groups.{g}.{i}.sub{k}",
                           _init_period_sub(draw, cfg, k, dtype, device))
            else:
                yield f"groups.{g}.{i}", _init_block(draw, kind, cfg, dtype,
                                                     device)


def init_lm_tree(draw, cfg: ArchConfig, dtype=torch.float32,
                 device=None) -> dict:
    """The parameter tree with the reference's init scales, one dict per
    layer: {"embed": {"emb"}, "final_norm", ["head": {"w"}], "groups":
    [[block, ...], ...]}.  draw(shape, std) returns f32 normal draws times
    std; it is called in a fixed order (``init_lm_parts``')."""
    tree = {"groups": [[{} for _ in range(count)]
                       for _, count in group_plan(cfg)]}
    for prefix, sub in init_lm_parts(draw, cfg, dtype, device):
        parts = prefix.split(".")
        if parts[0] != "groups":
            tree[prefix] = sub
        else:
            blk = tree["groups"][int(parts[1])][int(parts[2])]
            blk.update(sub if len(parts) == 3 else {parts[3]: sub})
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


class Experts(NamedTuple):
    """The MoE layers' expert leaves (``moe.wi_gate``, ``moe.wi_up``,
    ``moe.wo``) as one data position's group reads them, where the rules
    place them over the whole mesh (``ctx.ep_axes``): ``blocks[q]`` is
    mesh position q's {parameter name: its block}, each read through
    ``shared_reads`` so that the data positions' gradients of a block add
    in their order; ``owners[k]`` the positions that run expert block k,
    one for each block of the expert FFN's width in its order
    (``sharding.expert_owners``)."""
    blocks: list
    devices: list
    owners: list


class ModelGroup(NamedTuple):
    """The model-axis group of one data position of the sharded train
    step: ``blocks[j]`` is model position j's {parameter name: its block}
    (``parallelism/sharding.py:param_blocks``), on ``devices[j]``, and
    ``experts`` the MoE layers' expert leaves over the mesh (None without
    MoE; with it, the row's ``blocks`` lack them).  The activations between
    the layers live on ``devices[0]``."""
    blocks: list
    devices: list
    experts: Experts | None = None

    @property
    def tp(self) -> int:
        return len(self.blocks)

    def split(self, n: int) -> bool:
        """Whether the model axis splits a dimension of n (the rules'
        ``tp_if``)."""
        return n % self.tp == 0

    @property
    def d_model(self) -> int:
        """The model's width, read from its final norm (``final_norm``, or
        Whisper's ``dec_norm``), which every position holds whole."""
        b0 = self.blocks[0]
        key = "final_norm.scale" if "final_norm.scale" in b0 else \
            "dec_norm.scale"
        return b0[key].shape[-1]

    def layer(self, prefix: str) -> list:
        """Each position's leaves under ``prefix`` ("groups.0.3."), by
        their remaining names ("attn.wq"); with ``experts``, each mesh
        position's expert leaves under it follow, [] for a position that
        runs no expert block of this group."""
        n = len(prefix)

        def under(bj):
            return {k[n:]: t for k, t in bj.items() if k.startswith(prefix)}

        row = [under(bj) for bj in self.blocks]
        if self.experts is None:
            return row
        used = {q for qs in self.experts.owners for q in qs}
        return row + [under(eb) if q in used else {}
                      for q, eb in enumerate(self.experts.blocks)]


def _embed_table(model: ModelGroup):
    """The blocks of ``emb`` of a ``ModelGroup``, one per model position,
    and whether they are its d_model blocks (the rules' (None,
    tp(d_model))) or each the whole table (replicated)."""
    embs = [bj["embed.emb"] for bj in model.blocks]
    return embs, embs[0].shape[1] < model.d_model


def embed_tokens(model, tokens):
    """The rows of ``emb`` for ``tokens``: of the whole table, or for a
    ``ModelGroup`` each model position's d_model block of it, joined in
    position order on the group's first device."""
    if not isinstance(model, ModelGroup):
        return model.embed.emb[tokens.long()]
    ids = tokens.long()
    embs, split = _embed_table(model)
    if not split:                            # replicated: looked up once
        return embs[0][ids]
    return join([e[ids.to(e.device)] for e in embs], model.devices[0])


def head_weight(model, cfg: ArchConfig):
    """The head (d, V): ``head.w``, or ``emb.T`` where it is tied to the
    embedding (Whisper).  For a ``ModelGroup`` whose model axis splits
    the vocab (the rules' (None, tp(padded_vocab))), the list of its
    positions' column blocks, which ``loss.chunked_cross_entropy`` takes
    vocab-parallel; a tied head is the embedding's d_model blocks joined
    into the whole table on the first device (exact), whose whole-vocab
    cross-entropy runs there."""
    if isinstance(model, ModelGroup):
        if cfg.tie_embeddings:
            embs, split = _embed_table(model)
            return (join(embs, model.devices[0]) if split else embs[0]).T
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


def ffn_group(group: ModelGroup, blocks: list, h, *, cfg: ArchConfig,
              name: str = "mlp", d_ff: int | None = None):
    """The dense FFN ``name`` (of width ``d_ff``, by default cfg's) of one
    data position's group on its normed input ``h``: on each position's
    d_ff columns, the partials summed, where the model axis splits d_ff;
    else once, on position 0."""
    if group.split(d_ff or cfg.d_ff):
        return _split(group, blocks,
                      lambda bj, a: apply_ffn(bj[name], a, act=cfg.act), h)
    return apply_ffn(blocks[0][name], h, act=cfg.act)


def attention_block(group: ModelGroup, blocks: list, h, *, cfg: ArchConfig,
                    positions, name: str = "attn", causal: bool = True,
                    kv=None):
    """The attention ``name`` of one data position's group on its normed
    input ``h`` (keys and values from ``kv`` where given: cross
    attention), in any layout of the model axis
    (``attention.attention_group``)."""
    devs = group.devices
    return attn.attention_group(
        [bj[name] for bj in blocks], fan_out(h, devs), cfg=cfg,
        positions=positions, devices=devs, causal=causal,
        kv_xs=None if kv is None else fan_out(kv, devs))


def _time_mix_group(group: ModelGroup, blocks: list, inputs, *,
                    cfg: ArchConfig, states=None):
    """RWKV's time mix over one data position's group from
    ``time_mix_inputs``'s ``inputs`` on its first device, by the layout
    of ``tm.wr``'s columns: whole heads per position (each position's
    heads, the partials summed); heads the model axis cuts (each
    position's columns of r, k, v, g and the decay, joined with ``u``
    and the group norm's blocks, then the wkv, group norm and gate once
    on all heads, each position's columns of the result through its rows
    of ``wo``, summed); or replicated (once, on position 0).  Returns
    (out, [((h0, h1), the new wkv state of heads [h0, h1)), ...]) for the
    heads each position ran (all of them, on the first device, where the
    axis cuts or replicates them); ``states(h0, h1, device)`` gives the
    state of heads [h0, h1) before the step, None the zero state."""
    b0 = blocks[0]["tm"]
    b, _, d = inputs[1].shape
    hs, dl = cfg.rwkv.head_size, b0["wr"].shape[1]
    devs = group.devices

    def state(h0, h1, dev):
        if states is not None:
            return states(h0, h1, dev)
        return torch.zeros((b, h1 - h0, hs, hs), dtype=torch.float32,
                           device=dev)

    if dl == d:                                      # replicated
        o, st = rwkv.time_mix_heads(b0, inputs, state(0, d // hs, devs[0]),
                                    cfg=cfg)
        return o, [((0, d // hs), st)]
    if dl % hs == 0:                                 # whole heads
        hl = dl // hs
        fanned = [fan_out(a, devs) for a in inputs]
        outs = [rwkv.time_mix_heads(bj["tm"], [f[j] for f in fanned],
                                    state(j * hl, (j + 1) * hl, devs[j]),
                                    cfg=cfg)
                for j, bj in enumerate(blocks)]
        return (row_sum([o for o, _ in outs], devs)[0],
                [((j * hl, (j + 1) * hl), st)
                 for j, (_, st) in enumerate(outs)])
    fanned = [fan_out(a, devs) for a in inputs]      # cut heads
    cols = [rwkv.time_mix_columns(bj["tm"], [f[j] for f in fanned])
            for j, bj in enumerate(blocks)]
    whole = [join([c[i] for c in cols], devs[0]) for i in range(5)]
    vecs = {n: join([bj["tm"][n] for bj in blocks], devs[0])
            for n in ("u", "gn_scale", "gn_bias")}
    o, st = rwkv.time_mix_wkv(whole, vecs, state(0, d // hs, devs[0]),
                              cfg=cfg)
    parts = [oj[..., j * dl:(j + 1) * dl] @ bj["tm"]["wo"].to(oj.dtype)
             for j, (bj, oj) in enumerate(zip(blocks, fan_out(o, devs)))]
    return row_sum(parts, devs)[0], [((0, d // hs), st)]


def moe_block(group: ModelGroup, blocks: list, experts: list, h, *,
              cfg: ArchConfig, moe_groups: int = 1):
    """(y, stats) of the MoE layer ``moe`` of one data position's group on
    its normed input ``h``: the router, dispatch and combine once, with
    position 0's copy of the router (``moe.moe_routed``, ``moe_groups``
    token groups); the experts where they are placed
    (``moe.experts_group`` over ``experts[q]``, mesh position q's expert
    leaves of this layer); the shared experts and the dense residual
    through ``ffn_group``."""
    p0, e = blocks[0]["moe"], group.experts
    y, stats = moe_mod.moe_routed(
        p0, h, cfg=cfg, groups=moe_groups,
        ffn=lambda buf: moe_mod.experts_group(
            [eb.get("moe") for eb in experts], e.devices, e.owners, buf))
    m = cfg.moe
    moes = [bj["moe"] for bj in blocks]
    if "shared" in p0:
        y = y + ffn_group(group, moes, h, cfg=cfg, name="shared",
                          d_ff=m.n_shared_experts * m.d_ff_expert)
    if "dense" in p0:
        y = y + ffn_group(group, moes, h, cfg=cfg, name="dense")
    return y, stats


def _ffn_or_moe(group: ModelGroup, blocks: list, experts: list, h, *,
                cfg: ArchConfig, moe_groups: int):
    """(y, stats or None): the FFN or the MoE layer of a block (or a
    period's sublayer) over a group."""
    if "moe" in blocks[0]:
        return moe_block(group, blocks, experts, h, cfg=cfg,
                         moe_groups=moe_groups)
    return ffn_group(group, blocks, h, cfg=cfg), None


class GroupMixers:
    """The token mixers of a block over a group, as ``_block_group``,
    ``_period_group`` and Whisper's ``_dec_block_group`` call them: the
    training forward's, from the sequence start, with no cache.  Serving
    (``sharded.ServeMixers``) passes mixers that start from a layer's
    cache blocks and keep its new cache entries, through the same block
    wiring."""

    def shift(self, name: str, h):
        """RWKV's token shift ``name`` ("tm", "cm") before ``h``'s first
        token: zeros."""
        return torch.zeros((h.shape[0], h.shape[2]), dtype=h.dtype,
                           device=h.device)

    def attention(self, group: ModelGroup, blocks: list, h, *,
                  cfg: ArchConfig, positions, name: str = "attn",
                  causal: bool = True, kv=None):
        return attention_block(group, blocks, h, cfg=cfg,
                               positions=positions, name=name,
                               causal=causal, kv=kv)

    def mla(self, group: ModelGroup, blocks: list, h, *, cfg: ArchConfig,
            positions):
        return mla_mod.mla_group(blocks, h, cfg=cfg, positions=positions,
                                 devices=group.devices)

    def mamba(self, group: ModelGroup, blocks: list, h, *, cfg: ArchConfig):
        return mam.mamba_group(blocks, h, cfg=cfg, devices=group.devices)

    def time_mix(self, group: ModelGroup, blocks: list, inputs, *,
                 cfg: ArchConfig):
        return _time_mix_group(group, blocks, inputs, cfg=cfg)[0]


TRAIN_MIXERS = GroupMixers()


def _period_group(group: ModelGroup, blocks: list, experts: list, x, *,
                  cfg: ArchConfig, positions, moe_groups: int,
                  mix: GroupMixers = TRAIN_MIXERS):
    """``_period`` over a group: each sublayer's mixer (Mamba by
    ``mix.mamba``, attention by ``mix.attention``) and its FFN or MoE
    layer.  Returns (x, the MoE layers' statistics)."""
    nk, eps = cfg.norm, cfg.norm_eps
    stats = []
    for i, sub in enumerate(cfg.block_pattern):
        key = f"sub{i}"
        sb = [bj[key] for bj in blocks]
        h = apply_norm(sb[0]["norm"], x, kind=nk, eps=eps)
        if sub == "attn":
            x = x + mix.attention(group, sb, h, cfg=cfg, positions=positions)
        else:
            x = x + mix.mamba(group, [bj["mamba"] for bj in sb], h, cfg=cfg)
        y, st = _ffn_or_moe(group, sb, [eb.get(key, {}) for eb in experts],
                            apply_norm(sb[0]["mlp_norm"], x, kind=nk,
                                       eps=eps), cfg=cfg,
                            moe_groups=moe_groups)
        x = x + y
        if st is not None:
            stats.append(st)
    return x, stats


def _block_group(kind: str, group: ModelGroup, blocks: list, x, *,
                 cfg: ArchConfig, positions, moe_groups: int = 1,
                 mix: GroupMixers = TRAIN_MIXERS):
    """One block over the model-axis group of one data position, its
    token mixers ``mix``'s (training's by default, serving's from
    ``sharded``): ``blocks[:tp]`` are the layer's leaves at each model
    position (``ModelGroup.layer``) and ``blocks[tp:]``, with MoE, each
    mesh position's expert leaves; ``x`` on the group's first device.
    The leaves the model axis replicates (the norms, RWKV's token shift
    and decay LoRA, its channel mix's receptance, MLA's down projections,
    the router, an FFN whose d_ff it does not divide, attention, MLA or
    Mamba that it does not split) run once, on position 0's copy; the
    split ones run once per position, their partials added in position
    order.  Returns (x, the block's MoE statistics)."""
    nk, eps = cfg.norm, cfg.norm_eps
    blocks, experts = blocks[:group.tp], blocks[group.tp:]
    b0 = blocks[0]
    if kind == "rwkv":
        h = apply_norm(b0["ln1"], x, kind=nk, eps=eps)
        inputs = rwkv.time_mix_inputs(b0["tm"], h, mix.shift("tm", h))
        x = x + mix.time_mix(group, blocks, inputs, cfg=cfg)
        h = apply_norm(b0["ln2"], x, kind=nk, eps=eps)
        xk, xr = rwkv.channel_mix_inputs(b0["cm"], h, mix.shift("cm", h))
        if group.split(cfg.d_ff):
            kv = _split(group, blocks,
                        lambda bj, a: rwkv.channel_mix_kv(bj["cm"], a), xk)
        else:
            kv = rwkv.channel_mix_kv(b0["cm"], xk)
        return x + rwkv.channel_mix_gate(b0["cm"], xr, kv), []
    if kind == "period":
        return _period_group(group, blocks, experts, x, cfg=cfg,
                             positions=positions, moe_groups=moe_groups,
                             mix=mix)
    h = apply_norm(b0["attn_norm"], x, kind=nk, eps=eps)
    if "mla" in b0:
        x = x + mix.mla(group, [bj["mla"] for bj in blocks], h, cfg=cfg,
                        positions=positions)
    else:
        x = x + mix.attention(group, blocks, h, cfg=cfg, positions=positions)
    y, st = _ffn_or_moe(group, blocks, experts, apply_norm(
        b0["mlp_norm"], x, kind=nk, eps=eps), cfg=cfg, moe_groups=moe_groups)
    return x + y, [] if st is None else [st]


class _GroupCheckpoint(torch.autograd.Function):
    """One block of a ``ModelGroup``'s forward, checkpointed: ``fn(*xs,
    blocks)`` runs without a graph, and the backward runs it again, once,
    on the thread that receives the block's output gradients, then
    differentiates that run.  (``torch.utils.checkpoint`` recomputes from
    whichever autograd device thread first unpacks a saved tensor, and the
    threads of two cards race there when one block spans them.)  The
    first ``n_in`` tensors are the block's inputs ``xs``; the layer's
    leaves follow, flat, ``keys[i]`` = (position, name) of the i-th of
    them, among ``n_pos`` positions.  ``fn`` returns a tensor, or a tuple
    of them (the block's output, then its MoE statistics)."""

    @staticmethod
    def forward(ctx, fn, keys, n_in, n_pos, *tensors):
        ctx.fn, ctx.keys, ctx.n_in, ctx.n_pos = fn, keys, n_in, n_pos
        ctx.save_for_backward(*tensors)
        with torch.no_grad():
            return fn(*tensors[:n_in],
                      _nested_blocks(keys, tensors[n_in:], n_pos))

    @staticmethod
    def backward(ctx, *douts):
        need = ctx.needs_input_grad[4:]
        ins = [t.detach().requires_grad_(n)
               for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            out = ctx.fn(*ins[:ctx.n_in],
                         _nested_blocks(ctx.keys, ins[ctx.n_in:], ctx.n_pos))
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [(o, d) for o, d in zip(outs, douts) if o.requires_grad]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], [t for t, n in zip(ins, need) if n],
            [d for _, d in pairs], allow_unused=True))
        return (None,) * 4 + tuple(next(got) if n else None for n in need)


def _nested_blocks(keys, tensors, n_pos: int) -> list:
    """Each position's leaves, nested by name ({"attn": {"wq": ...}}),
    from ``_GroupCheckpoint``'s flat keys and tensors."""
    flat = [{} for _ in range(n_pos)]
    for (j, name), t in zip(keys, tensors):
        flat[j][name] = t
    return [nest_state_dict(f) for f in flat]


def run_checkpointed(group: ModelGroup, prefix: str, fn, *xs):
    """``fn(*xs, blocks)`` over the leaves under ``prefix``
    ("groups.0.3.") of each model position (and, with MoE, each mesh
    position's expert leaves: ``ModelGroup.layer``), checkpointed as one
    block (``_GroupCheckpoint``), so that its recompute in the backward
    repeats the same sums in the same order; with no graph being recorded
    (serving, eval), ``fn`` runs directly."""
    flat = group.layer(prefix)
    if not torch.is_grad_enabled():                  # serving, eval
        return fn(*xs, [nest_state_dict(f) for f in flat])
    keys = [(j, n) for j, f in enumerate(flat) for n in f]
    return _GroupCheckpoint.apply(fn, keys, len(xs), len(flat), *xs,
                                  *(flat[j][n] for j, n in keys))


def norm_group(group: ModelGroup, name: str, x, cfg: ArchConfig):
    """The norm ``name`` ("final_norm"), which the model axis replicates,
    applied once with position 0's copy."""
    return apply_norm(nest_state_dict(group.layer(f"{name}.")[0]), x,
                      kind=cfg.norm, eps=cfg.norm_eps)


def _forward_hidden_group(group: ModelGroup, embeds, *, cfg: ArchConfig,
                          positions, moe_groups: int = 1):
    """``forward_hidden`` of a ``ModelGroup``: every block's model
    positions inside one checkpoint of that block."""
    x, stats = embeds, []
    for gi, (kind, count) in enumerate(group_plan(cfg)):
        for i in range(count):
            def block(x, blocks, kind=kind):
                x, st = _block_group(kind, group, blocks, x, cfg=cfg,
                                     positions=positions,
                                     moe_groups=moe_groups)
                return (x, *st)

            x, *st = run_checkpointed(group, f"groups.{gi}.{i}.", block, x)
            stats.extend(st)
    return norm_group(group, "final_norm", x, cfg), stats


def forward_hidden(model, embeds, *, cfg: ArchConfig, positions,
                   moe_groups: int = 1):
    """embeds: (B,S,d) -> (hidden (B,S,d) after the final norm, stats).
    Each block is checkpointed (its forward runs again in the backward);
    stats lists the MoE layers' router statistics in layer order, each
    (2, E) f32 (``moe.moe_layer``, its tokens in ``moe_groups`` groups),
    and is empty without MoE.  ``model`` is an ``LM``, or the
    ``ModelGroup`` of one data position of the sharded train step (every
    kind: heads split, head_dim split or cut by the model axis, or
    replicated; MLA's heads and Mamba's d_inner split; the experts where
    ``ctx.ep_axes`` places them)."""
    if isinstance(model, ModelGroup):
        return _forward_hidden_group(model, embeds, cfg=cfg,
                                     positions=positions,
                                     moe_groups=moe_groups)
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


def _block_prefill(blk, x, *, cfg: ArchConfig, positions, max_len: int,
                   moe_groups: int = 1):
    """Returns (x, cache_entry) matching init_cache leaf layout (minus n)."""
    nk, eps = cfg.norm, cfg.norm_eps
    if isinstance(blk, PeriodBlock):
        x, entry = _period(blk, x, cfg=cfg, positions=positions,
                           max_len=max_len, moe_groups=moe_groups)
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
                                           eps=eps), cfg=cfg,
                           moe_groups=moe_groups)
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


def _block_decode(blk, x, cache: dict, *, cfg: ArchConfig, cache_len,
                  moe_groups: int = 1):
    nk, eps = cfg.norm, cfg.norm_eps
    if isinstance(blk, PeriodBlock):
        x, entry = _period(blk, x, cfg=cfg, positions=None, cache=cache,
                           cache_len=cache_len, moe_groups=moe_groups)
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
                                           eps=eps), cfg=cfg,
                           moe_groups=moe_groups)
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
def lm_prefill(model: LM, batch: dict, *, cfg: ArchConfig, max_len: int = 0,
               moe_groups: int = 1):
    """Run the full prompt, return (last-token logits, filled cache); the
    KV caches are sized for max_len tokens (the prompt's length if 0).
    The MoE layers split the B·S tokens into ``moe_groups`` groups, as
    the reference's under a ctx of that many data shards."""
    x = _inputs(model, batch)
    b, s = x.shape[0], x.shape[1]
    max_len = max_len or s
    positions = make_positions(cfg, b, s, device=x.device)
    groups_cache = []
    for blocks in model.groups:
        entries = []
        for blk in blocks:
            x, entry = _block_prefill(blk, x, cfg=cfg, positions=positions,
                                      max_len=max_len, moe_groups=moe_groups)
            entries.append(entry)
        groups_cache.append(_stack(entries))
    cache = {"len": torch.full((b,), s, dtype=torch.int32, device=x.device),
             "groups": groups_cache}
    return _logits(model, x, cfg), cache


@torch.no_grad()
def lm_decode(model: LM, cache: dict, batch: dict, *, cfg: ArchConfig,
              moe_groups: int = 1):
    """One decode step. batch['tokens'] or ['embeds']: (B,1)[,d].  Returns
    (logits, cache); the MoE layers' B tokens in ``moe_groups`` groups."""
    x = _inputs(model, batch)
    cache_len = cache["len"]
    new_groups = []
    for blocks, gcache in zip(model.groups, cache["groups"]):
        entries = []
        for i, blk in enumerate(blocks):
            x, entry = _block_decode(blk, x, {k: v[i]
                                              for k, v in gcache.items()},
                                     cfg=cfg, cache_len=cache_len,
                                     moe_groups=moe_groups)
            entries.append(entry)
        new_groups.append(_stack(entries))
    return _logits(model, x, cfg), {"len": cache_len + 1,
                                    "groups": new_groups}
