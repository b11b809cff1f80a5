"""Sharding rules for every parameter, batch and cache leaf, and the
placement of a tree on a mesh: the JAX package's
``parallelism/sharding.py``.

The rules are the reference's, as pure functions of the port's trees:

  TP   — Megatron column/row splits; head-axis TP when n_heads % tp == 0,
         head_dim TP otherwise.
  EP   — expert placement via ShardCtx.ep_axes (full / 2-D / tp-only).
  DP   — batch leading axes over ('pod','data').
  SP   — decode caches shard the *sequence* axis over the data axes when the
         batch axis is too small (long_500k, global_batch=1).
  ZeRO-1 — optimizer moments additionally sharded over the data axes.

A spec is a plain tuple with one entry per dimension: None, an axis name,
or a tuple of axis names.  Every leaf must match a rule; an unmatched leaf
raises KeyError, as in the reference.

The port's parameters are keyed by name, one tensor per layer
(``groups.0.3.attn.wq``); the reference stacks a group's layers on a
leading axis (``params["groups"][0]["attn"]["wq"]``).  A layer's spec is
its stacked leaf's spec, the layer axis's entry first
(``repro_torch.convert`` uses the same naming), so that it equals the
reference's spec for the same leaf; ``leaf_layers`` names each layer's
place in its stack.  ZeRO-1 may shard that layer axis: each layer is then
held whole by the positions of one block.

Placement (``shard_tree``, ``gather_tree``) covers every axis: a leaf is
split along each dimension's entry into one block per mesh position, in
the order of a JAX ``NamedSharding`` (row-major over the entry's axes,
a tuple entry such as ('data', 'model') included); entries on two
dimensions give their intersection (a ZeRO-1 moment's data axes beside
its parameter's model axis).  A leaf, or a block, is stored once per
distinct device: positions on the same device hold views of it, so a
mesh that repeats one card holds one copy.

Parameters are placed by ``place_params``, by their whole specs: the
model-axis entries, and the data-axis entries of the MoE layers' expert
leaves (``ctx.ep_axes``: experts over the data axes, over data and model,
or over model), so that a device stores only its experts' blocks; each
stored tensor is a leaf of its own that autograd differentiates.
``param_blocks`` then gives each position its block of every parameter,
taken when it is called (inside the train step's forward): a view of the
one stored tensor where the position's device holds the parameter whole,
else that device's stored block.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers.attention import head_axes
from repro_torch.parallelism.ctx import ShardCtx

_NORM_PARENTS = {"attn_norm", "mlp_norm", "final_norm", "ln1", "ln2", "norm",
                 "q_norm", "kv_norm", "self_norm", "cross_norm", "enc_norm",
                 "dec_norm"}
_FFN_PARENTS = {"mlp", "shared", "dense"}
_ATTN_PARENTS = {"attn", "self_attn", "cross_attn"}

# the top-level keys whose layers the reference stacks on a leading axis
STACKS = ("groups", "enc_blocks", "dec_blocks")


# ---------------------------------------------------------------------------
# the port's names and the reference's paths
# ---------------------------------------------------------------------------

def _ref_path(name: str):
    """(the reference's path names, stack key, layer index) of a port
    parameter name; the last two are None outside the stacks."""
    parts = name.split(".")
    if parts[0] == "groups":
        g, i = parts[1], int(parts[2])
        return ["groups", f"[{g}]", *parts[3:]], ("groups", g,
                                                  *parts[3:]), i
    if parts[0] in STACKS:
        return [parts[0], *parts[2:]], (parts[0], *parts[2:]), int(parts[1])
    return parts, None, None


def leaf_layers(names) -> dict:
    """{name: (layer index, layers in its stack)}, or None for a leaf
    outside the stacks, from the names of a whole tree."""
    counts: dict = {}
    paths = {n: _ref_path(n) for n in names}
    for _, key, i in paths.values():
        if key is not None:
            counts[key] = max(counts.get(key, 0), i + 1)
    return {n: None if key is None else (i, counts[key])
            for n, (_, key, i) in paths.items()}


def ref_shapes(tree: dict) -> dict:
    """{name: the shape of the reference's leaf}, a stacked leaf's with
    its layer axis first, of a {name: tensor} dict or a {name: shape}
    dict (``factory.param_shapes``)."""
    layers = leaf_layers(tree)
    return {n: (() if layers[n] is None else (layers[n][1],))
            + tuple(getattr(x, "shape", x)) for n, x in tree.items()}


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _param_rule(names: list[str], shape, cfg: ArchConfig, ctx: ShardCtx):
    """Spec for the *trailing* dims; caller pads leading stacked dims."""
    name = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    tp = ctx.tp_if
    hd = cfg.resolved_head_dim
    h_ax, hd_ax = head_axes(ctx, cfg.n_heads, hd)
    kv_h_ax = h_ax if (h_ax and cfg.n_kv_heads % ctx.tp_size == 0) else None

    if parent in _NORM_PARENTS or name in ("scale", "bias"):
        return (None,) * 1 if len(shape) >= 1 else ()
    if parent == "embed" and name == "emb":
        return (None, tp(cfg.d_model))
    if parent == "head" and name == "w":
        return (None, tp(cfg.padded_vocab(32)))
    if name == "pos_dec":
        return (None, None)
    if parent in _ATTN_PARENTS:
        return {
            "wq": (None, h_ax, hd_ax),
            "wk": (None, kv_h_ax, hd_ax),
            "wv": (None, kv_h_ax, hd_ax),
            "wo": (h_ax, hd_ax, None),
            "bq": (h_ax, hd_ax),
            "bk": (kv_h_ax, hd_ax),
            "bv": (kv_h_ax, hd_ax),
        }[name]
    if parent == "mla":
        th = tp(cfg.n_heads)
        return {
            "wdq": (None, None), "wdkv": (None, None),
            "wuq": (None, th, None), "wuk": (None, th, None),
            "wuv": (None, th, None), "wo": (th, None, None),
        }[name]
    if parent == "moe":
        ep_ax, ff_ax = ctx.ep_axes(cfg.moe.n_experts, cfg.moe.d_ff_expert)
        return {
            "router": (None, None),
            "wi_gate": (ep_ax, None, ff_ax),
            "wi_up": (ep_ax, None, ff_ax),
            "wo": (ep_ax, ff_ax, None),
        }[name]
    if parent in _FFN_PARENTS:
        if name in ("wi_gate", "wi_up", "wi"):
            return (None, tp(shape[-1]))
        if name == "wo":
            return (tp(shape[-2]), None)
    if parent == "tm":
        d = cfg.d_model
        return {
            "wr": (None, tp(d)), "wk": (None, tp(d)), "wv": (None, tp(d)),
            "wg": (None, tp(d)), "wo": (tp(d), None),
            "wd1": (None, None), "wd2": (None, tp(d)),
            "w0": (tp(d),), "u": (tp(d),),
            "gn_scale": (tp(d),), "gn_bias": (tp(d),),
            "mu_x": (None,), "mu": (None, None),
            "mix_w1": (None, None), "mix_w2": (None, None, None),
        }[name]
    if parent == "cm":
        return {
            "wk": (None, tp(cfg.d_ff)), "wv": (tp(cfg.d_ff), None),
            "wr": (None, None), "mu_k": (None,), "mu_r": (None,),
        }[name]
    if parent == "mamba":
        di = cfg.ssm.expand * cfg.d_model
        return {
            "wx": (None, tp(di)), "wz": (None, tp(di)),
            "conv_w": (None, tp(di)), "conv_b": (tp(di),),
            "wxp": (tp(di), None), "wdt": (None, tp(di)),
            "dt_bias": (tp(di),), "A_log": (tp(di), None),
            "D": (tp(di),), "wo": (tp(di), None),
        }[name]
    raise KeyError(f"no sharding rule for param path {'/'.join(names)} "
                   f"shape={tuple(shape)}")


def _pad(rule: tuple, ndim: int) -> tuple:
    if len(rule) > ndim:
        # scalar-ish leaves (e.g. 1-element rule on 0-d) — replicate
        rule = rule[-ndim:] if ndim else ()
    return (None,) * (ndim - len(rule)) + tuple(rule)


def param_pspecs(params: dict, cfg: ArchConfig, ctx: ShardCtx) -> dict:
    """{name: spec} for a model's {name: tensor or shape} parameters:
    each the reference's spec of the leaf, a stacked layer's with the
    layer axis's entry first."""
    shapes = ref_shapes(params)
    return {n: _pad(_param_rule(_ref_path(n)[0], shape, cfg, ctx),
                    len(shape)) for n, shape in shapes.items()}


# ---------------------------------------------------------------------------
# batches / caches / logits
# ---------------------------------------------------------------------------

def batch_pspecs(batch: dict, ctx: ShardCtx) -> dict:
    """DP on each leaf's leading (batch) dim, everything else
    replicated."""
    return {k: (ctx.dp_if(x.shape[0]),) + (None,) * (x.dim() - 1)
            for k, x in batch.items()}


def cache_pspecs(cache: dict, cfg: ArchConfig, ctx: ShardCtx) -> dict:
    """Specs in the cache's own layout ({"len", "groups": [{...}]}, or
    Whisper's flat dict), its leaves stacked as the reference's."""
    hd = cfg.resolved_head_dim
    h_ax, hd_ax = head_axes(ctx, cfg.n_heads, hd)
    kv_h_ax = h_ax if (h_ax and cfg.n_kv_heads % ctx.tp_size == 0) else None

    def seq_entry(b, s, model_used: bool):
        """(B_ax, S_ax).  Batch over data; the sequence axis picks up every
        mesh axis not already used (model, or data+model when B=1) so the
        cache — the dominant decode state — is maximally sharded."""
        b_ax = ctx.dp_if(b)
        if b_ax is not None:
            s_ax = None if model_used else ctx.tp_if(s)
            return b_ax, s_ax
        # tiny batch (long_500k): shard the sequence instead
        if not model_used and ctx.batch_axes and ctx.tp_axis and \
                s % (ctx.dp_size * ctx.tp_size) == 0:
            return None, tuple(ctx.batch_axes) + (ctx.tp_axis,)
        return None, ctx.dp_if(s)

    def leaf(names, x):
        name, sh = names[-1], tuple(x.shape)
        if name == "len":
            return (None,)
        if name in ("k", "v", "ck", "cv"):
            b, s = sh[1], sh[2]
            model_used = (kv_h_ax is not None) or (hd_ax is not None)
            b_ax, s_ax = seq_entry(b, s, model_used)
            return (None, b_ax, s_ax, kv_h_ax, hd_ax)
        if name in ("ckv", "kr"):
            b_ax, s_ax = seq_entry(sh[1], sh[2], False)
            return (None, b_ax, s_ax, None)
        if name == "S":      # rwkv state (n,B,H,hs,hs)
            return (None, ctx.dp_if(sh[1]), ctx.tp_if(sh[2]), None, None)
        if name in ("tm", "cm"):
            return (None, ctx.dp_if(sh[1]), None)
        if name == "h":      # mamba (n,nm,B,di,ds)
            return (None, None, ctx.dp_if(sh[2]), ctx.tp_if(sh[3]), None)
        if name == "conv":   # (n,nm,B,K-1,di)
            return (None, None, ctx.dp_if(sh[2]), None, ctx.tp_if(sh[4]))
        raise KeyError(f"no cache rule for {'/'.join(names)}")

    def walk(node, names):
        if isinstance(node, dict):
            return {k: walk(v, names + [k]) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, names + [f"[{i}]"]) for i, v in enumerate(node)]
        return leaf(names, node)
    return walk(cache, [])


def logits_pspec(cfg: ArchConfig, ctx: ShardCtx, batch: int) -> tuple:
    return (ctx.dp_if(batch), ctx.tp_if(cfg.padded_vocab(32)))


# ---------------------------------------------------------------------------
# ZeRO-1: moments additionally sharded over the data axes
# ---------------------------------------------------------------------------

def zero1_pspec(spec: tuple, shape, ctx: ShardCtx) -> tuple:
    if not ctx.batch_axes:
        return spec
    used = set()
    for entry in spec:
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            used.add(a)
    if any(a in used for a in ctx.batch_axes):
        return spec
    dp = ctx.dp_size
    entries = list(spec)
    for i, (entry, dim) in enumerate(zip(entries, shape)):
        if entry is None and dim % dp == 0 and dim >= dp:
            entries[i] = ctx.batch
            return tuple(entries)
    return spec


def moments_pspecs(param_specs: dict, params: dict, ctx: ShardCtx) -> dict:
    """The moments' specs: each parameter's, plus the data axes on the
    first free dimension they divide (the layer axis included)."""
    shapes = ref_shapes(params)
    return {n: zero1_pspec(s, shapes[n], ctx) for n, s in param_specs.items()}


# ---------------------------------------------------------------------------
# placement: the port's ``named``
# ---------------------------------------------------------------------------

def _entry_block(entry, coords: dict, mesh) -> tuple[int, int]:
    """(block index, blocks) of a position along one dimension whose spec
    entry is ``entry``: row-major over the entry's axes."""
    axes = () if entry is None else (entry if isinstance(entry, tuple)
                                     else (entry,))
    k, nb = 0, 1
    for a in axes:
        size = mesh.shape[a]
        k, nb = k * size + coords[a], nb * size
    return k, nb


def _block_of(spec: tuple, shape: tuple, layer, mesh, pos: int):
    """The part of a leaf of ``shape`` that mesh position ``pos`` holds,
    as ((start, stop) per dim), or None where it holds none of it; for a
    stacked layer (``layer`` = (index, layers)) ``spec`` leads with the
    layer axis's entry."""
    coords = dict(zip(mesh.axis_names,
                      np.unravel_index(pos, mesh.devices.shape)))
    entries = list(spec)
    if layer is not None:
        i, n = layer
        k, nb = _entry_block(entries.pop(0), coords, mesh)
        if n % nb:
            raise ValueError(f"{n} layers do not split into {nb} blocks")
        if i // (n // nb) != k:
            return None
    if len(entries) != len(shape):
        raise ValueError(f"spec {spec} does not fit a leaf of shape "
                         f"{tuple(shape)}")
    out = []
    for entry, dim in zip(entries, shape):
        k, nb = _entry_block(entry, coords, mesh)
        if dim % nb:
            raise ValueError(f"spec {spec}: dimension {dim} of "
                             f"{tuple(shape)} does not split into {nb}")
        out.append((k * (dim // nb), (k + 1) * (dim // nb)))
    return tuple(out)


def index_of(block: tuple) -> tuple:
    """A block ((start, stop) per dim) as an index of basic slices."""
    return tuple(slice(a, b) for a, b in block)


def inside(block: tuple, outer: tuple):
    """``block``'s index relative to ``outer``, which contains it, or None
    where it does not."""
    if any(a < oa or b > ob for (a, b), (oa, ob) in zip(block, outer)):
        return None
    return tuple(slice(a - oa, b - oa) for (a, b), (oa, _) in zip(block,
                                                                  outer))


class Shards:
    """A leaf placed on a mesh.  ``blocks[pos]`` is the tensor that mesh
    position ``pos`` (row-major) holds, or None, and ``where[pos]`` its
    block ((start, stop) per dim); ``devices[pos]`` is that position's
    device; ``stores[device]`` lists the distinct (block, tensor) pairs
    that device holds, each once; ``wholes[device]`` is the whole leaf
    where that device holds every block, its blocks views of it."""

    def __init__(self, shape, spec, blocks, where, devices, stores, wholes):
        self.shape, self.spec = tuple(shape), spec
        self.blocks, self.where, self.devices = blocks, where, devices
        self.stores, self.wholes = stores, wholes

    def region(self, device, block: tuple):
        """The stored tensor on ``device`` over ``block`` (a view), or None
        where that device holds no stored tensor containing it."""
        if device in self.wholes:
            return self.wholes[device][index_of(block)]
        for held, t in self.stores.get(device, ()):
            idx = inside(block, held)
            if idx is not None:
                return t[idx]
        return None


def _place(shape, spec, layer, mesh, whole_on, block_on) -> Shards:
    """A leaf of ``shape`` placed by ``spec``: ``whole_on(dev)`` is the
    whole leaf on a device that holds every block of it, ``block_on(b,
    dev)`` block b on a device that holds some."""
    devs = list(mesh.devices.flat)
    where = [_block_of(spec, tuple(shape), layer, mesh, p)
             for p in range(len(devs))]
    distinct = {b for b in where if b is not None}
    blocks, stores, wholes = [None] * len(devs), {}, {}
    for dev in dict.fromkeys(devs):
        held = list(dict.fromkeys(where[p] for p in range(len(devs))
                                  if devs[p] == dev and where[p] is not None))
        if not held:
            continue
        if len(held) == len(distinct):     # all of it: once, blocks as views
            whole = wholes[dev] = whole_on(dev)
            stores[dev] = [(b, whole[index_of(b)]) for b in held]
        else:
            stores[dev] = [(b, block_on(b, dev)) for b in held]
        views = dict(stores[dev])
        for p in range(len(devs)):
            if devs[p] == dev and where[p] is not None:
                blocks[p] = views[where[p]]
    return Shards(shape, spec, blocks, where, devs, stores, wholes)


def _shard_leaf(x, spec, layer, mesh, leaves: bool = False) -> Shards:
    """``x`` placed by ``spec``.  With ``leaves`` each stored tensor is a
    leaf that requires grad: ``x`` itself on its own device where that
    device holds it whole, else a copy."""
    src = x.detach()

    def copy(t, dev):
        t = t.to(dev, copy=True)
        return nn.Parameter(t) if leaves else t

    def whole_on(dev):
        if leaves:
            return x if x.device == dev else copy(src, dev)
        return src.to(dev)

    return _place(x.shape, spec, layer, mesh, whole_on,
                  lambda b, dev: copy(src[index_of(b)], dev))


def shard_tree(tree: dict, specs: dict, mesh) -> dict:
    """{name: Shards} of a {name: tensor} tree placed by ``specs``."""
    layers = leaf_layers(tree)
    return {n: _shard_leaf(x, specs[n], layers[n], mesh)
            for n, x in tree.items()}


def zeros_tree(shapes: dict, specs: dict, mesh, dtype,
               leaves: bool = False) -> dict:
    """{name: Shards} of zero leaves of ``shapes`` placed by ``specs``,
    each stored block made on its device, so that no device holds more of
    a leaf than its blocks (the ZeRO-1 moments).  With ``leaves`` each
    stored tensor is a leaf that requires grad, as ``place_params`` stores
    a model's parameters (a dry run's parameters, made from shapes)."""
    layers = leaf_layers(shapes)

    def zeros(shape, dev):
        t = torch.zeros(shape, dtype=dtype, device=dev)
        return nn.Parameter(t) if leaves else t

    return {n: _place(tuple(shape), specs[n], layers[n], mesh,
                      lambda dev, shape=shape: zeros(tuple(shape), dev),
                      lambda b, dev: zeros(tuple(e - a for a, e in b), dev))
            for n, shape in shapes.items()}


def is_expert_leaf(name: str) -> bool:
    """Whether ``name`` is an MoE layer's expert leaf (``moe.wi_gate``,
    ``moe.wi_up``, ``moe.wo``), which ``ctx.ep_axes`` may place over the
    data axes."""
    parts = name.split(".")
    return len(parts) >= 2 and parts[-2] == "moe" and parts[-1] in (
        "wi_gate", "wi_up", "wo")


def place_params(params: dict, specs: dict, mesh, layers=None) -> dict:
    """{name: Shards} of a model's {name: parameter} placed by ``specs``
    (an expert leaf's data-axis entries too).  A device stores each
    parameter whose blocks it holds all of whole, once (the parameter
    itself on the device it lives on), and otherwise only the blocks its
    positions hold; every stored tensor is a leaf that requires grad.  A
    parameter that the mesh's first device does not store whole is
    released once placed (its storage emptied), so that the device that
    made the model never holds it beside its blocks.  ``layers``
    (``leaf_layers`` of the whole model's names) places part of a model:
    by default the names of ``params`` are the whole."""
    layers = leaf_layers(params) if layers is None else layers
    home = mesh.devices.flat[0]
    out = {}
    for n, x in params.items():
        out[n] = _shard_leaf(x, specs[n], layers[n], mesh, leaves=True)
        if home not in out[n].wholes:
            x.data = x.new_empty(0)
    return out


def expert_owners(where: list, row: list) -> list:
    """The mesh positions that run each expert block for the data position
    whose model positions are ``row``: ``where`` is an expert leaf's
    ``Shards.where`` ((experts, d_model, d_ff) ranges by position).  For
    each block of experts, in order, one position for each block of d_ff,
    in order: the row's own where it holds that block (the 'tp' and
    replicated placements), else the first that does (the '2d' and 'full'
    placements hold each block once)."""
    blocks: dict = {}
    for q, w in enumerate(where):
        held = blocks.setdefault(w[0], {})
        if w[2] not in held or (q in row and held[w[2]] not in row):
            held[w[2]] = q
    return [[held[f] for f in sorted(held)]
            for _, held in sorted(blocks.items())]


def param_blocks(placed: dict) -> list:
    """For each mesh position, {name: the block of that parameter it
    holds}: a view of the stored tensor, taken now, where the position's
    device holds the parameter whole (the tensor itself where the block is
    all of it), else that device's stored block.  ``placed`` is
    ``place_params``'s."""
    n = len(next(iter(placed.values())).devices)
    out = [{} for _ in range(n)]
    for name, sh in placed.items():
        for p, dev in enumerate(sh.devices):
            if dev not in sh.wholes:
                out[p][name] = sh.blocks[p]
            elif all(a == 0 and b == d for (a, b), d in zip(sh.where[p],
                                                           sh.shape)):
                out[p][name] = sh.wholes[dev]
            else:
                out[p][name] = sh.wholes[dev][index_of(sh.where[p])]
    return out


@torch.no_grad()
def gather_tree(shards: dict, specs: dict, mesh) -> dict:
    """{name: the whole tensor} on the mesh's first device: the stored
    tensor itself where that device holds all of a leaf (no copy), else
    each block copied from its first holder."""
    out = {}
    for n, sh in shards.items():
        if sh.spec != specs[n]:
            raise ValueError(f"{n}: placed by {sh.spec}, not {specs[n]}")
        out[n] = gather(sh, mesh.devices.flat[0])
    return out


# ---------------------------------------------------------------------------
# leaves computed in pieces: a served model's cache and logits
# ---------------------------------------------------------------------------

def regions(sh: Shards) -> list:
    """[(block, tensor)]: each distinct block of a placed leaf once, the
    tensor of its first holder in position order."""
    seen, out = set(), []
    for b, t in zip(sh.where, sh.blocks):
        if b is not None and b not in seen:
            seen.add(b)
            out.append((b, t))
    return out


def _overlap(box: tuple, other: tuple):
    """The intersection of two boxes ((start, stop) per dim), or None."""
    out = tuple((max(a, c), min(b, d)) for (a, b), (c, d) in zip(box, other))
    return None if any(a >= b for a, b in out) else out


def _fill(out, box: tuple, pieces: list):
    """Copy into ``out``, which covers ``box``, every piece's overlap
    with it, in the pieces' order."""
    for pbox, t in pieces:
        ov = _overlap(box, pbox)
        if ov is not None:
            out[inside(ov, box)] = t[inside(ov, pbox)].to(out.device)


def cut(box: tuple, pieces: list, device):
    """The tensor over ``box`` on ``device`` from ``pieces`` [(box,
    tensor)], boxes in the leaf's coordinates: the piece itself where one
    is exactly ``box`` on ``device``, else a copy of the first piece that
    holds all of it, else zeros filled from every piece that overlaps it
    in order (what no piece covers stays 0: a cache's positions past the
    prompt).  A copy holds only ``box``, never the piece it came from."""
    for pbox, t in pieces:
        idx = inside(box, pbox)
        if idx is None:
            continue
        if pbox == box and t.device == torch.device(device):
            return t
        return t[idx].to(device, copy=True)
    out = torch.zeros(tuple(b - a for a, b in box), dtype=pieces[0][1].dtype,
                      device=device)
    _fill(out, box, pieces)
    return out


def place_pieces(shape, spec, mesh, pieces: list,
                 stacked: bool = False) -> Shards:
    """A leaf of ``shape`` placed by ``spec``, each stored block (and the
    whole, on a device that holds every block) cut from ``pieces`` [(box,
    tensor)] (``cut``); with ``stacked``, ``pieces`` holds one such list
    per index of the leaf's first (layer) axis, each box over a layer's
    slice, and a block is filled layer by layer.  The pieces may lie on
    any device; each block is made on its holder."""
    def make(box, dev):
        if not stacked:
            return cut(box, pieces, dev)
        (l0, l1), sub = box[0], box[1:]
        first = pieces[l0][0][1]
        out = torch.zeros(tuple(b - a for a, b in box), dtype=first.dtype,
                          device=dev)
        for i, layer in enumerate(pieces[l0:l1]):
            _fill(out[i], sub, layer)
        return out

    full = tuple((0, d) for d in shape)
    return _place(tuple(shape), spec, None, mesh, lambda dev: make(full, dev),
                  make)


def gather(sh: Shards, device):
    """The whole of a placed leaf on ``device``: the stored whole where
    that device holds one, else its blocks joined there."""
    dev = torch.device(device)
    if dev in sh.wholes:
        return sh.wholes[dev]
    return cut(tuple((0, d) for d in sh.shape), regions(sh), dev)
