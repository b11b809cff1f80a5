"""A model placed on a ('data', 'model') mesh, and serving it: the JAX
package's ``factory.prefill``/``decode`` under a ``ctx``
(``src/repro/models/lm.py:lm_prefill``/``lm_decode``,
``whisper.py:whisper_prefill``/``whisper_decode``), single-controller.

``PlacedModel`` holds a model's parameters placed by ``param_pspecs``
(``sharding.place_params``: a split leaf stored only in its positions'
blocks, the MoE layers' experts wherever ``ctx.ep_axes`` puts them), and
``model_groups`` gives each data position its ``lm.ModelGroup`` over
them, as the sharded train step does.

A served cache is the unsharded cache's tree ({"len", "groups": [...]},
or Whisper's flat dict) whose leaves are ``sharding.Shards`` placed by
``cache_pspecs``: each block stored once per distinct device, so a mesh
that repeats one card holds one cache, and no device holds a block it
does not own between steps.  Logits come back as a ``Shards`` placed by
``logits_pspec``: rows over the data axes, the padded vocabulary over the
model axis, each position's block made from its block of the head.

A step splits the batch's rows over the data positions by
``batch_pspecs``; each data position's rows run through the training
path's blocks over its ``ModelGroup`` (``lm._block_group``, Whisper's
``_dec_block_group``), with no graph recorded and serving's token mixers
(``ServeMixers``), the MoE layers with one token group each, which is the
reference's group of those rows.  A batch whose rows the positions do
not divide, or whose MoE layers take fewer groups than data positions
(``moe.moe_groups`` of the step's token count), runs once, on the first
data position, in the reference's groups.  The layers compute their
cache entries as pieces [(box, tensor)] (``box`` the (start, stop)
ranges the piece covers in a layer's slice of the leaf, rows global):
each position's KV heads (or Mamba channels, or RWKV heads) on its
device where the layer splits them, else the whole entry on the group's
first device; ``sharding.place_pieces`` cuts the cache's blocks from
them on their holders.  A decode step reads each layer's blocks where
they are stored (``attention.attention_decode_group``: sequence slabs
merged by log-sum-exp, head_dim partials added before the softmax;
``mla.mla_decode_group``: the slabs joined for the step), and writes the
new token into the block that holds its index by a mask.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm, whisper
from repro_torch.models.layers import attention as attn
from repro_torch.models.layers import mamba as mam
from repro_torch.models.layers import mla as mla_mod
from repro_torch.models.layers.common import nest_state_dict
from repro_torch.models.layers.moe import moe_groups
from repro_torch.parallelism import sharding
from repro_torch.parallelism.ctx import ShardCtx
from repro_torch.parallelism.tensor import fan_out, shared_reads


class PlacedModel:
    """A model's parameters placed on ``ctx.mesh``: ``placed`` {name:
    ``sharding.Shards``} (``sharding.place_params``); the data positions'
    ``lm.ModelGroup`` over them are built once and kept, every block
    detached, so that a block computes alike whether it is a stored leaf
    of its own (a device that holds only its blocks) or a view of a whole
    one (PyTorch's matmul takes another path for an operand that
    requires grad, even under ``no_grad``)."""

    def __init__(self, placed: dict, ctx: ShardCtx):
        self.placed, self.ctx = placed, ctx
        self._groups: dict = {}

    def groups(self, n: int) -> list:
        if n not in self._groups:
            with torch.no_grad():
                self._groups[n] = [_detached(g) for g in model_groups(
                    self.placed, self.ctx, n)]
        return self._groups[n]


def _detached(group: lm.ModelGroup) -> lm.ModelGroup:
    def det(blocks):
        return [{k: t.detach() for k, t in b.items()} for b in blocks]

    ex = group.experts
    if ex is not None:
        ex = ex._replace(blocks=det(ex.blocks))
    return group._replace(blocks=det(group.blocks), experts=ex)


def _expert_reads(placed: dict, blocks: list, ctx: ShardCtx, n: int) -> list:
    """For each of the first ``n`` data positions, the ``lm.Experts`` its
    group reads: every mesh position's expert leaves (from
    ``param_blocks``'s ``blocks``), each block read by the n groups
    through ``shared_reads``, and the positions that run each expert
    block for that data position's row (``sharding.expert_owners``)."""
    devs = list(ctx.mesh.devices.flat)
    tp = ctx.tp_size
    names = [k for k in placed if sharding.is_expert_leaf(k)]
    reads = {(q, k): shared_reads(blocks[q][k], n)
             for q in range(len(devs)) for k in names}
    where = placed[names[0]].where
    return [lm.Experts([{k: reads[q, k][i] for k in names}
                        for q in range(len(devs))], devs,
                       sharding.expert_owners(
                           where, range(i * tp, (i + 1) * tp)))
            for i in range(n)]


def model_groups(placed: dict, ctx: ShardCtx, n: int) -> list:
    """The ``lm.ModelGroup`` of each of the first ``n`` data positions over
    placed parameters (``sharding.place_params``): its row's blocks
    (``param_blocks``, views taken now), and with MoE the experts over
    the whole mesh (``_expert_reads``)."""
    devs = list(ctx.mesh.devices.flat)
    tp = ctx.tp_size
    blocks = sharding.param_blocks(placed)
    experts = [None] * n
    if any(sharding.is_expert_leaf(k) for k in placed):
        experts = _expert_reads(placed, blocks, ctx, n)
        blocks = [{k: t for k, t in bq.items()
                   if not sharding.is_expert_leaf(k)} for bq in blocks]
    return [lm.ModelGroup(blocks[i * tp:(i + 1) * tp],
                          devs[i * tp:(i + 1) * tp], experts[i])
            for i in range(n)]


def row_split(cfg: ArchConfig, ctx: ShardCtx, b: int, n_tokens: int):
    """(MoE token groups of the step, whether each data position runs its
    own rows): the train step's rule (``train_step._position_parts``)."""
    dp = ctx.dp_size
    g = 1 if cfg.moe is None else moe_groups(dp, n_tokens, cfg.moe.top_k)
    return g, not (b % dp or (cfg.moe is not None and g != dp))


def _parts(pm: PlacedModel, batch: dict, cfg: ArchConfig, b: int,
           n_tokens: int) -> list:
    """[(group, its batch, its rows (r0, r1), its MoE token groups)] of one
    step (see the module's docstring)."""
    ctx = pm.ctx
    mesh, tp = ctx.mesh, ctx.tp_size
    g, spread = row_split(cfg, ctx, b, n_tokens)
    if not spread:
        home = mesh.devices.flat[0]
        return [(pm.groups(1)[0], {k: x.to(home) for k, x in batch.items()},
                 (0, b), g)]
    shards = sharding.shard_tree(batch, sharding.batch_pspecs(batch, ctx),
                                 mesh)
    rb = b // ctx.dp_size
    return [(grp, {k: sh.blocks[i * tp] for k, sh in shards.items()},
             (i * rb, (i + 1) * rb), 1)
            for i, grp in enumerate(pm.groups(ctx.dp_size))]


# ---------------------------------------------------------------------------
# the cache tree
# ---------------------------------------------------------------------------

def _leaves(tree, path=()):
    """(path, leaf) of a cache tree, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _rebuild(tree, fn, path=()):
    """The tree with each leaf replaced by fn(path, leaf)."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def cache_layout(cfg: ArchConfig, ctx: ShardCtx, batch: int, max_len: int,
                 dtype=torch.float32):
    """(the unsharded cache's tree of shapes, on ``meta``, and its specs,
    ``cache_pspecs``)."""
    meta = torch.device("meta")
    tree = (whisper.init_whisper_cache(cfg, batch, max_len, dtype, meta)
            if cfg.enc_dec else lm.init_cache(cfg, batch, max_len, dtype,
                                              meta))
    return tree, sharding.cache_pspecs(tree, cfg, ctx)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, ctx: ShardCtx,
               dtype=torch.float32) -> dict:
    """The zero cache placed by ``cache_pspecs``: each block made on its
    holder (``sharding.zeros_tree``)."""
    tree, specs = cache_layout(cfg, ctx, batch, max_len, dtype)
    paths = dict(_leaves(tree))
    spec_of = dict(_leaves(specs))
    names = {p: "/".join(map(str, p)) for p in paths}
    shards = sharding.zeros_tree(
        {names[p]: tuple(t.shape) for p, t in paths.items()},
        {names[p]: spec_of[p] for p in paths}, ctx.mesh, dtype)
    shards[names[("len",)]] = sharding._place(
        (batch,), spec_of[("len",)], None, ctx.mesh,
        lambda dev: torch.zeros((batch,), dtype=torch.int32, device=dev),
        lambda b, dev: torch.zeros((b[0][1] - b[0][0],), dtype=torch.int32,
                                   device=dev))
    return _rebuild(tree, lambda p, _: shards[names[p]])


def gather_cache(cache: dict, device) -> dict:
    """The whole cache on ``device`` (``sharding.gather`` of each leaf)."""
    return _rebuild(cache, lambda _, sh: sharding.gather(sh, device))


def _place_cache(tree, specs, mesh, entries: dict, keep: dict) -> dict:
    """The cache tree's leaves (anything with the leaf's ``shape``) placed
    from ``entries`` {path: [a layer's pieces, ...]} (or taken from
    ``keep`` {path: Shards})."""
    spec_of = dict(_leaves(specs))

    def leaf(path, t):
        if path in keep:
            return keep[path]
        return sharding.place_pieces(t.shape, spec_of[path], mesh,
                                     entries[path], stacked=True)
    return _rebuild(tree, leaf)


def _length(b: int, value, ctx: ShardCtx, spec) -> sharding.Shards:
    """The cache's ``len`` (B,) int32, replicated."""
    return sharding.place_pieces((b,), spec, ctx.mesh, [(((0, b),), value)])


# ---------------------------------------------------------------------------
# one layer over a group: its output and its cache entry's pieces
# ---------------------------------------------------------------------------

class ServeMixers(lm.GroupMixers):
    """The token mixers of serving one layer over a group, through the
    training path's block wiring (``lm._block_group``, Whisper's
    ``_dec_block_group``): a prefill where ``state`` is None, else a
    decode step from the layer's blocks ``state`` {leaf: [(box,
    tensor)]}.  Each mixer keeps its cache entry's pieces; ``pieces()``
    gives them {leaf: [(box, tensor)]}, ``rows`` the group's rows in the
    batch."""

    def __init__(self, rows, state=None, cache_len=None):
        self.rows, self.state, self.cache_len = rows, state, cache_len
        self.ent: dict = {}
        self.mambas: list = []

    def shift(self, name, h):
        """The shift state before ``h`` (the cache's ``name`` or zeros);
        ``h``'s last token is the new one."""
        b, _, d = h.shape
        home = h.device
        self.ent[name] = [((self.rows, (0, d)), h[:, -1])]
        if self.state is None:
            return torch.zeros((b, d), dtype=h.dtype, device=home)
        return sharding.cut((self.rows, (0, d)), self.state[name],
                            home).to(h.dtype)

    def attention(self, group, blocks, h, *, cfg, positions, name="attn",
                  causal=True, kv=None):
        """A prefill through ``attention_group`` (K3'), its cache entry
        each position's KV heads or the whole on the first device; a
        decode step over the blocks of ``state``.  Not ``causal``
        (Whisper's cross attention, cache ``ck``/``cv``), the keys come
        from ``kv`` in a prefill, and a decode step writes nothing."""
        devs, rows = group.devices, self.rows
        keys = ("k", "v") if causal else ("ck", "cv")
        blocks = [bj[name] for bj in blocks]
        xs = fan_out(h, devs)
        if self.state is None:
            y, kvs = attn.attention_group(
                blocks, xs, cfg=cfg, positions=positions, devices=devs,
                causal=causal, kv_xs=None if causal else fan_out(kv, devs),
                return_kv=True)
            for key in keys:
                self.ent[key] = []
            for lo, k, v in kvs:
                box = (rows, (0, k.shape[1]), (lo, lo + k.shape[2]),
                       (0, k.shape[3]))
                self.ent[keys[0]].append((box, k.to(h.dtype)))
                self.ent[keys[1]].append((box, v.to(h.dtype)))
            return y
        y, new = attn.attention_decode_group(
            blocks, xs, {"k": self.state[keys[0]], "v": self.state[keys[1]]},
            cfg=cfg, cache_len=self.cache_len, devices=devs, rows=rows,
            cross=not causal)
        if causal:
            self.ent.update({"k": new["k"], "v": new["v"]})
        return y

    def mla(self, group, blocks, h, *, cfg, positions):
        if self.state is None:
            y, (ckv, kr) = mla_mod.mla_group(
                blocks, h, cfg=cfg, positions=positions,
                devices=group.devices, return_cache=True)
            self.ent.update({n: [((self.rows, (0, t.shape[1]),
                                   (0, t.shape[2])), t.to(h.dtype))]
                             for n, t in (("ckv", ckv), ("kr", kr))})
            return y
        y, ent = mla_mod.mla_decode_group(
            blocks, h, self.state, cfg=cfg, cache_len=self.cache_len,
            devices=group.devices, rows=self.rows)
        self.ent.update(ent)
        return y

    def mamba(self, group, blocks, h, *, cfg):
        """A period's next Mamba sublayer, from its states in the
        cache's ``h`` and ``conv`` (a prefill: chunks of 64 from zeros)."""
        s, m, rows = cfg.ssm, len(self.mambas), self.rows
        states = None if self.state is None else (
            lambda c0, c1, dev: (
                sharding.cut(((m, m + 1), rows, (0, s.d_conv - 1),
                              (c0, c1)), self.state["conv"], dev)[0],
                sharding.cut(((m, m + 1), rows, (c0, c1),
                              (0, s.d_state)), self.state["h"], dev)[0]))
        y, st = mam.mamba_group_states(
            blocks, h, cfg=cfg, devices=group.devices,
            chunk=64 if self.state is None else 1, states=states)
        self.mambas.append([(sp, conv.to(h.dtype), hs)
                            for sp, conv, hs in st])
        return y

    def time_mix(self, group, blocks, inputs, *, cfg):
        hs, rows = cfg.rwkv.head_size, self.rows
        states = None if self.state is None else (
            lambda h0, h1, dev: sharding.cut(
                (rows, (h0, h1), (0, hs), (0, hs)), self.state["S"], dev))
        y, S = lm._time_mix_group(group, blocks, inputs, cfg=cfg,
                                  states=states)
        self.ent["S"] = [((rows, hr, (0, hs), (0, hs)), st) for hr, st in S]
        return y

    def pieces(self, cfg) -> dict:
        """{leaf: [(box, tensor)]} of the layer's new cache entry; a
        period's Mamba states stacked over its sublayers."""
        if not self.mambas:
            return self.ent
        s, nm, rows = cfg.ssm, len(self.mambas), self.rows
        spans = [sp for sp, _, _ in self.mambas[0]]
        return {**self.ent,
                "h": [(((0, nm), rows, sp, (0, s.d_state)),
                       torch.stack([ms[j][2] for ms in self.mambas]))
                      for j, sp in enumerate(spans)],
                "conv": [(((0, nm), rows, (0, s.d_conv - 1), sp),
                          torch.stack([ms[j][1] for ms in self.mambas]))
                         for j, sp in enumerate(spans)]}


def _layer(group: lm.ModelGroup, prefix: str) -> list:
    """Each position's nested leaves under ``prefix`` (the model
    positions', then with MoE each mesh position's experts)."""
    return [nest_state_dict(f) for f in group.layer(prefix)]


def _logit_pieces(group, x, cfg: ArchConfig, rows, norm: str) -> list:
    """The last position's logits of the group's rows as pieces (rows,
    vocab range): each position's block of a split head on its device,
    else the whole vocab on the first."""
    x = lm.norm_group(group, norm, x, cfg)[:, -1]
    w = lm.head_weight(group, cfg)
    if not isinstance(w, list):
        return [((rows, (0, w.shape[1])), (x @ w.to(x.dtype)).float())]
    out, v0 = [], 0
    for xj, wj in zip(fan_out(x, [t.device for t in w]), w):
        out.append(((rows, (v0, v0 + wj.shape[1])),
                    (xj @ wj.to(xj.dtype)).float()))
        v0 += wj.shape[1]
    return out


def _row_dim(path) -> int:
    """The batch dimension of a cache leaf's layer slice."""
    return 1 if path[-1] in ("h", "conv") else 0


def _layer_state(regs: dict, i: int) -> dict:
    """{leaf: [(box, layer i's block)]} from ``regs`` {leaf: [(box with
    the layer axis, block)]}."""
    return {leaf: [(box[1:], t[i]) for box, t in items]
            for leaf, items in regs.items()}


def _group_regions(cache, rows) -> dict:
    """{path: [(box, block)]}: each leaf's distinct blocks whose rows lie
    inside ``rows``, from their first holders."""
    out = {}
    for path, sh in _leaves(cache):
        if path == ("len",):
            continue
        d = _row_dim(path) + 1
        out[path] = [(box, t) for box, t in sharding.regions(sh)
                     if rows[0] <= box[d][0] and box[d][1] <= rows[1]]
    return out


# ---------------------------------------------------------------------------
# the decoder LMs
# ---------------------------------------------------------------------------

def _lm_step(group, batch, *, cfg, rows, moe_groups, regs=None,
             cache_len=None):
    """The LM's prefill (``regs`` None) or decode step over one group:
    (logit pieces, {path: [a layer's pieces, ...]})."""
    x = lm._inputs(group, batch)
    b, s = x.shape[0], x.shape[1]
    if regs is None:
        positions = lm.make_positions(cfg, b, s, device=x.device)
    else:
        positions = None
    ent: dict = {}
    for gi, (kind, count) in enumerate(lm.group_plan(cfg)):
        mine = None if regs is None else {
            p[-1]: v for p, v in regs.items() if p[:2] == ("groups", gi)}
        for i in range(count):
            mix = ServeMixers(rows, None if mine is None
                              else _layer_state(mine, i), cache_len)
            x, _ = lm._block_group(kind, group, _layer(
                group, f"groups.{gi}.{i}."), x, cfg=cfg, positions=positions,
                moe_groups=moe_groups, mix=mix)
            for leaf, p in mix.pieces(cfg).items():
                ent.setdefault(("groups", gi, leaf), []).append(p)
    return _logit_pieces(group, x, cfg, rows, "final_norm"), ent


# ---------------------------------------------------------------------------
# Whisper
# ---------------------------------------------------------------------------

def _whisper_step(group, batch, *, cfg, rows, moe_groups, regs=None,
                  cache_len=None):
    """Whisper's prefill (``regs`` None: the encoder, then the decoder
    over the prompt) or decode step over one group: (logit pieces,
    {path: [a layer's pieces, ...]}); a decode step leaves ``ck`` and
    ``cv`` as they are."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    if regs is None:
        enc = whisper.encode(group, batch["frames"], cfg=cfg)
        x = whisper._dec_embed(group, tokens, 0)
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
    else:
        enc = positions = None
        x = lm.embed_tokens(group, tokens)
        pos = group.blocks[0]["pos_dec"]
        x = x + pos[cache_len.long().to(pos.device)][:, None].to(
            x.dtype).to(x.device)
    ent: dict = {}
    for i in range(cfg.n_layers):
        mix = ServeMixers(rows, None if regs is None else _layer_state(
            {p[-1]: v for p, v in regs.items()}, i), cache_len)
        x = whisper._dec_block_group(group, _layer(group, f"dec_blocks.{i}."),
                                     x, enc, cfg, positions, mix=mix)
        for k, v in mix.pieces(cfg).items():
            ent.setdefault((k,), []).append(v)
    return _logit_pieces(group, x, cfg, rows, "dec_norm"), ent


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _rows_of(batch: dict) -> tuple:
    x = batch["tokens"] if "tokens" in batch else batch["embeds"]
    return x.shape[0], x.shape[1]


def _steps(pm, batch, cfg, b, n_tokens, cache=None, cache_len=None):
    """Each group's prefill (``cache`` None) or decode step: (the logits
    placed by ``logits_pspec``, {path: [each layer's pieces from every
    group]})."""
    step = _whisper_step if cfg.enc_dec else _lm_step
    logit_pieces, entries = [], {}
    for group, bt, rows, g in _parts(pm, batch, cfg, b, n_tokens):
        kw = {} if cache is None else {
            "regs": _group_regions(cache, rows),
            "cache_len": cache_len[rows[0]:rows[1]].to(group.devices[0])}
        lp, ent = step(group, bt, cfg=cfg, rows=rows, moe_groups=g, **kw)
        logit_pieces += lp
        for path, layers in ent.items():
            mine = entries.setdefault(path, [[] for _ in layers])
            for acc, p in zip(mine, layers):
                acc += p
    logits = sharding.place_pieces(
        (b, cfg.padded_vocab(lm.VOCAB_PAD)),
        sharding.logits_pspec(cfg, pm.ctx, b), pm.ctx.mesh, logit_pieces)
    return logits, entries


@torch.no_grad()
def prefill(pm: PlacedModel, batch: dict, *, cfg: ArchConfig,
            max_len: int = 0):
    """(logits, cache) of the prompt on the mesh: logits a ``Shards`` of
    (B, padded vocab) placed by ``logits_pspec``, the cache a tree of
    ``Shards`` placed by ``cache_pspecs`` (see the module's docstring)."""
    b, s = _rows_of(batch)
    logits, entries = _steps(pm, batch, cfg, b, b * s)
    tree, specs = cache_layout(cfg, pm.ctx, b, max_len or s)
    home = pm.ctx.mesh.devices.flat[0]
    keep = {("len",): _length(b, torch.full((b,), s, dtype=torch.int32,
                                            device=home), pm.ctx,
                              specs["len"])}
    return logits, _place_cache(tree, specs, pm.ctx.mesh, entries, keep)


@torch.no_grad()
def decode(pm: PlacedModel, cache: dict, batch: dict, *, cfg: ArchConfig):
    """One decode step on the mesh from a placed cache: (logits, the new
    cache), placed as ``prefill``'s; the cache given is left unchanged."""
    ctx = pm.ctx
    cache_len = sharding.gather(cache["len"], ctx.mesh.devices.flat[0])
    b = cache_len.shape[0]
    logits, entries = _steps(pm, batch, cfg, b, b, cache, cache_len)
    keep = {("len",): _length(b, cache_len + 1, ctx, cache["len"].spec)}
    if cfg.enc_dec:
        keep.update({(k,): cache[k] for k in ("ck", "cv")})
    specs = _rebuild(cache, lambda _, sh: sh.spec)
    return logits, _place_cache(cache, specs, ctx.mesh, entries, keep)


def greedy(logits: sharding.Shards):
    """The greedy tokens (B, 1) int32 on the mesh's first device from
    logits placed in vocab blocks: each block's max and its first index,
    then the first block that holds the largest max, in vocab order:
    ``jnp.argmax``'s first index on a tie, across the blocks too."""
    home = logits.devices[0]
    by_rows: dict = {}
    for (rb, vb), t in sharding.regions(logits):
        by_rows.setdefault(rb, []).append((vb, t))
    out = []
    for rb in sorted(by_rows):
        best = idx = None
        for (v0, _), t in sorted(by_rows[rb], key=lambda e: e[0]):
            i = torch.argmax(t, dim=-1)
            m = torch.gather(t, -1, i[:, None])[:, 0].to(home)
            i = (i + v0).to(home)
            if best is None:
                best, idx = m, i
            else:
                take = m > best
                best = torch.where(take, m, best)
                idx = torch.where(take, i, idx)
        out.append(idx)
    return torch.cat(out).to(torch.int32)[:, None]


@torch.no_grad()
def generate(pm: PlacedModel, cfg: ArchConfig, prompts, *,
             max_new: int = 16):
    """Greedy decode of ``max_new`` tokens on the mesh: (B, max_new)
    int32 on its first device."""
    b, s = prompts.shape
    logits, cache = prefill(pm, {"tokens": prompts}, cfg=cfg,
                            max_len=s + max_new)
    toks = [greedy(logits)]
    for _ in range(max_new - 1):
        logits, cache = decode(pm, cache, {"tokens": toks[-1]}, cfg=cfg)
        toks.append(greedy(logits))
    return torch.cat(toks, dim=1)
