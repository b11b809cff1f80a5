"""GQA attention: init, the prefill path through the flash-attention kernel,
the decode path, and the JAX package's plain attention forms, from its
``models/layers/attention.py``.

The weight layout keeps heads 3-D, as the reference's does: wq (d, H, hd),
wk and wv (d, KV, hd), wo (H, hd, d), and the optional biases bq (H, hd),
bk and bv (KV, hd).  Activations are (B, S, heads, hd).

``attention_train`` sends its core attention through the flash-attention
wrapper on the GQA layout, without repeating the KV heads: the CUDA
kernel on the card, ``attention_plain`` on the CPU.  The reference's
``direct_attention`` and ``chunked_attention`` (the block-pair
online-softmax scan over repeated KV) are kept as plain functions for the
tests.  Decode is plain PyTorch, as the reference's is plain jnp.

Cross attention (Whisper's decoder over the encoder's output):
``cross_attention_train`` projects the encoder's keys and values and
sends the full-sequence attention through the same wrapper, non-causal
(the kernel on the card); ``cross_attention_decode`` attends one step's
query over the cached encoder keys, plain.  ``head_axes`` gives the
sharding rules (``parallelism/sharding.py``) the tensor-parallel entries
of the (H, hd) dims, and the sharded train step runs one data
position's attention over its model-axis group through
``attention_group``, in the layout they give:

  · heads: ``attention_heads`` once per model position on its block of
    heads, the positions' outputs summed (``parallelism/tensor.py:
    row_sum``);
  · head_dim: each position projects its head_dim columns, ``join``
    makes whole heads, RoPE is applied to them, and the core attention
    runs on whole heads: ``seqpar_attention`` (each position on its
    slab of queries) where the reference's test at its
    ``attention.py:235-236`` takes it, else one call on the first
    position; each position then multiplies its columns of the output
    by its rows of ``wo``;
  · replicated (neither divides): the whole attention once, on the
    first position.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.models.layers.rope import apply_mrope, apply_rope
from repro_torch.parallelism.ctx import ShardCtx
from repro_torch.parallelism.tensor import (fan_out, join, ordered_sum,
                                             row_sum)

NEG_INF = -1e30


def head_axes(ctx: ShardCtx, n_heads: int, head_dim: int):
    """(head_axis, head_dim_axis) spec entries for (H, hd) dims."""
    if ctx.tp_axis is None or ctx.tp_size <= 1:
        return None, None
    if n_heads % ctx.tp_size == 0:
        return ctx.tp_axis, None
    if head_dim % ctx.tp_size == 0:
        return None, ctx.tp_axis
    return None, None


# ---------------------------------------------------------------------------
# init.  draw(shape, std) returns f32 normal draws times std; the scales
# are the JAX package's.
# ---------------------------------------------------------------------------

def init_attention(draw, cfg: ArchConfig, dtype=torch.float32, device=None,
                   *, cross: bool = False) -> dict:
    d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    scale = d ** -0.5
    p = {"wq": draw((d, h, hd), scale).to(dtype),
         "wk": draw((d, kv, hd), scale).to(dtype),
         "wv": draw((d, kv, hd), scale).to(dtype),
         "wo": draw((h, hd, d), (h * hd) ** -0.5).to(dtype)}
    if cfg.qkv_bias and not cross:
        p["bq"] = torch.zeros((h, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((kv, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((kv, hd), dtype=dtype, device=device)
    return p


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------

def _heads(x, w):
    """x (B,S,d) @ w (d, heads, hd) -> (B,S,heads,hd)."""
    b, s, _ = x.shape
    return (x @ w.to(x.dtype).reshape(w.shape[0], -1)).reshape(
        b, s, w.shape[1], w.shape[2])


def _project_q(p, x):
    q = _heads(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    return q


def _project_kv(p, x):
    k, v = _heads(x, p["wk"]), _heads(x, p["wv"])
    if "bk" in p:
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return k, v


def _out(p, o):
    """o (B,S,H,hd) @ wo (H,hd,d) -> (B,S,d)."""
    b, s, h, hd = o.shape
    return o.reshape(b, s, h * hd) @ p["wo"].to(o.dtype).reshape(h * hd, -1)


def repeat_kv(k, n_heads: int):
    """(B,S,KV,hd) -> (B,S,H,hd): each KV head repeated H // KV times in
    place, as ``jnp.repeat(k, H // KV, axis=2)``."""
    kvh = k.shape[2]
    if kvh == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // kvh, dim=2)


def _rope(q, positions, cfg: ArchConfig):
    if cfg.rope_mode == "rope":
        return apply_rope(q, positions, theta=cfg.rope_theta)
    if cfg.rope_mode == "mrope":
        return apply_mrope(q, positions, theta=cfg.rope_theta)
    return q  # 'none' / 'sinusoidal' (handled at the embedding)


# ---------------------------------------------------------------------------
# the reference's core attention maths, plain
# ---------------------------------------------------------------------------

def _causal_mask(sq: int, skv: int, device):
    """(sq, skv) bool, True where query i (at key position skv - sq + i)
    sees key j."""
    qpos = torch.arange(sq, device=device)[:, None] + (skv - sq)
    return qpos >= torch.arange(skv, device=device)[None, :]


def direct_attention(q, k, v, *, causal: bool, kv_valid=None):
    """Materialized-score attention.  q: (B,Sq,H,hd); k,v: (B,Skv,H,hd);
    kv_valid: (B,Skv) bool or None."""
    hd = q.shape[-1]
    s = torch.einsum("bqhk,bshk->bhqs", q.float(), k.float()) * (hd ** -0.5)
    if causal:
        s = torch.where(_causal_mask(q.shape[1], k.shape[1], q.device), s,
                        NEG_INF)
    if kv_valid is not None:
        s = torch.where(kv_valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqs,bshk->bqhk", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def _causal_pairs(tq: int, tk: int, cq: int, ck: int):
    """(i, j, first, last) block pairs covering the causal triangle,
    row-major in i, ascending j."""
    pairs = []
    for i in range(tq):
        js = [j for j in range(tk) if j * ck <= (i + 1) * cq - 1]
        pairs += [(i, j, n == 0, n == len(js) - 1) for n, j in enumerate(js)]
    return pairs


def chunked_attention(q, k, v, *, causal: bool = True, chunk_q: int = 1024,
                      chunk_k: int = 1024, direct_threshold: int = 2048):
    """Online-softmax block attention.  q,k,v: (B,S,H,hd) (kv repeated)."""
    b, sq, h, hd = q.shape
    skv, dv = k.shape[1], v.shape[-1]
    if sq <= direct_threshold and skv <= direct_threshold:
        return direct_attention(q, k, v, causal=causal)
    if skv <= direct_threshold and not causal:
        # long queries over a short KV: chunk q only
        cq = min(chunk_q, sq)
        assert sq % cq == 0, (sq, cq)
        return torch.cat([direct_attention(q[:, i:i + cq], k, v,
                                           causal=False)
                          for i in range(0, sq, cq)], dim=1)
    cq, ck = min(chunk_q, sq), min(chunk_k, skv)
    assert sq % cq == 0 and skv % ck == 0, (sq, cq, skv, ck)
    tq, tk = sq // cq, skv // ck
    if causal:
        pairs = _causal_pairs(tq, tk, cq, ck)
    else:
        pairs = [(i, j, j == 0, j == tk - 1) for i in range(tq)
                 for j in range(tk)]
    scale = hd ** -0.5
    offset = skv - sq
    out = torch.zeros(q.shape[:-1] + (dv,), dtype=q.dtype, device=q.device)
    for i, j, first, last in pairs:
        qi = q[:, i * cq:(i + 1) * cq].float()
        kj = k[:, j * ck:(j + 1) * ck].float()
        vj = v[:, j * ck:(j + 1) * ck]
        s = torch.einsum("bqhk,bshk->bhqs", qi, kj) * scale
        if causal:
            qpos = i * cq + torch.arange(cq, device=q.device)[:, None] + offset
            kpos = j * ck + torch.arange(ck, device=q.device)[None, :]
            s = torch.where(qpos >= kpos, s, NEG_INF)
        if first:
            m = torch.full((b, h, cq), NEG_INF, device=q.device)
            l = torch.zeros((b, h, cq), device=q.device)
            acc = torch.zeros((b, h, cq, dv), device=q.device)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhqs,bshk->bhqk", p.to(vj.dtype).float(),
                          vj.float())
        acc = acc * corr[..., None] + pv
        m = m_new
        if last:
            o_block = acc / torch.clamp(l[..., None], min=1e-30)
            out[:, i * cq:(i + 1) * cq] = o_block.transpose(1, 2).to(q.dtype)
    return out


# ---------------------------------------------------------------------------
# layer-level entry points
# ---------------------------------------------------------------------------

def attention_train(p, x, *, cfg: ArchConfig, positions, causal: bool = True,
                    return_kv: bool = False):
    """Full-sequence attention (prefill).  x: (B,S,d).  The core attention
    is the flash-attention wrapper on the GQA layout (no KV repeat)."""
    q = _rope(_project_q(p, x), positions, cfg)
    k, v = _project_kv(p, x)
    k = _rope(k, positions, cfg)
    out = _out(p, flash_attention(q, k, v, causal=causal))
    if return_kv:
        return out, (k, v)   # roped, pre-repeat: the KV-cache entries
    return out


def attention_heads(p, x, *, cfg: ArchConfig, positions, head0: int,
                    causal: bool = True, kv_x=None, return_kv: bool = False):
    """The output partial (B,S,d) of one model position's query heads
    ``head0 .. head0 + H'``: ``p`` holds its blocks (wq (d,H',hd), wo
    (H',hd,d), bq) and either its block of the KV heads (wk/wv (d,K',hd),
    bk/bv) or all of them, replicated (the reference's ``kv_h_ax`` None:
    the KV heads do not divide the model axis).  Replicated KV heads are
    projected only where the position's heads need them (query head i
    reads KV head i // (H / KV)), and repeated to one per query head where
    the position's heads straddle two groups unevenly.  Keys and values
    come from ``kv_x`` where given (cross attention, no RoPE), else from
    ``x``.  The core attention is the flash-attention wrapper, as in
    ``attention_train``; the position's rows of wo make the partial,
    which ``row_sum`` adds up.  With ``return_kv`` also (first KV head,
    k, v): the keys (roped) and values of the KV heads it projected, before
    any repeat, the cache entries of those heads."""
    hl = p["wq"].shape[1]
    kv = {n: p[n] for n in ("wk", "wv", "bk", "bv") if n in p}
    rep, lo = None, head0 // hl * p["wk"].shape[1]
    if hl < cfg.n_heads and p["wk"].shape[1] == cfg.n_kv_heads:
        group = cfg.n_heads // cfg.n_kv_heads
        ids = [(head0 + i) // group for i in range(hl)]
        lo, hi = ids[0], ids[-1] + 1
        kv = {n: t[:, lo:hi] if n[0] == "w" else t[lo:hi]
              for n, t in kv.items()}
        n_kv = hi - lo
        if hl % n_kv or any(ids[i] - lo != i // (hl // n_kv)
                            for i in range(hl)):
            rep = [i - lo for i in ids]
    q = _project_q(p, x)
    k, v = _project_kv(kv, x if kv_x is None else kv_x)
    if kv_x is None:
        q, k = _rope(q, positions, cfg), _rope(k, positions, cfg)
    entry = (lo, k, v)
    if rep is not None:
        # each KV head expanded to its run of query heads (a sum in the
        # backward, no scatter)
        runs = [(c, rep.count(c)) for c in dict.fromkeys(rep)]
        k, v = (torch.cat([t[:, :, c:c + 1].expand(-1, -1, n, -1)
                           for c, n in runs], dim=2) for t in (k, v))
    out = _out(p, flash_attention(q, k, v, causal=causal))
    return (out, entry) if return_kv else out


def seqpar_attention(q, k, v, *, causal: bool, devices: list):
    """Sequence-block-parallel attention, the reference's
    ``seqpar_attention`` (``attention.py:262``), for whole heads made by
    a head_dim split: q (B,S,H,hd), k and v (B,S,KV,hd) in the GQA
    layout (no KV repeat; K3' reads it), each on ``devices[0]``.  Model
    position m, on ``devices[m]``, takes query rows [m·sg, (m+1)·sg),
    sg = S / tp, and runs ``flash_attention`` on them over keys
    [0, (m+1)·sg) where causal (K3''s right-aligned mask, offset m·sg,
    is then the global mask of that slab), over every key otherwise.
    In place of the reference's hints (q resharded into sequence slabs,
    K and V gathered over the model axis) and its online-softmax scan
    over key chunks of 512, ``fan_out`` hands q, k and v to the
    positions (their gradients added in position order) and the slabs'
    outputs are joined along the sequence in position order.  Returns
    (B,S,H,hd) on ``devices[0]``."""
    tp, s = len(devices), q.shape[1]
    if s % tp or k.shape[1] != s:
        raise ValueError(f"seqpar_attention: {s} queries over "
                         f"{k.shape[1]} keys do not split into {tp} slabs")
    sg = s // tp
    qs, ks, vs = (fan_out(t, devices) for t in (q, k, v))
    slabs = []
    for m in range(tp):
        end = (m + 1) * sg if causal else s
        slabs.append(flash_attention(
            qs[m][:, m * sg:(m + 1) * sg].contiguous(),
            ks[m][:, :end].contiguous(), vs[m][:, :end].contiguous(),
            causal=causal))
    return join(slabs, devices[0], dim=1)


def attention_group(blocks: list, xs: list, *, cfg: ArchConfig, positions,
                    devices: list, causal: bool = True, kv_xs=None,
                    return_kv: bool = False):
    """The attention output (B,S,d), on ``devices[0]``, of one data
    position's model-axis group: ``blocks[j]`` is model position j's
    block of the layer's leaves (wq, wk, wv, wo and the biases), ``xs[j]``
    its copy of the normed input (``fan_out``) and ``kv_xs[j]`` of the
    keys' and values' source for cross attention (Whisper's encoder
    output; None for self attention).  ``positions`` is on
    ``devices[0]``.  The layout is the rules' ``head_axes``, read from
    the blocks' shapes (see the module's docstring).  The whole
    attention, the head_dim split's fallback and its join of the heads
    run once per data position, never once per model position.  With
    ``return_kv`` also the cache entries, [(first KV head, k, v), ...]
    (roped keys, before any repeat): each position's KV heads on its
    device where the layout splits heads, else every KV head, whole, on
    ``devices[0]``."""
    b0, tp = blocks[0], len(blocks)
    kv_xs = [None] * tp if kv_xs is None else kv_xs
    hl, hdl = b0["wq"].shape[1], b0["wq"].shape[2]
    if hl < cfg.n_heads:                             # heads
        outs = [attention_heads(bj, xj, cfg=cfg,
                                positions=positions.to(xj.device),
                                head0=j * hl, causal=causal, kv_x=kvj,
                                return_kv=True)
                for j, (bj, xj, kvj) in enumerate(zip(blocks, xs, kv_xs))]
        out = row_sum([o for o, _ in outs], devices)[0]
        return (out, [e for _, e in outs]) if return_kv else out
    if hdl == cfg.resolved_head_dim:                 # replicated
        if kv_xs[0] is None:
            out = attention_train(b0, xs[0], cfg=cfg, positions=positions,
                                  causal=causal, return_kv=return_kv)
        else:
            out = cross_attention_train(b0, xs[0], kv_xs[0], cfg=cfg,
                                        return_kv=return_kv)
        if not return_kv:
            return out
        return out[0], [(0, *out[1])]
    home = devices[0]                                # head_dim
    q = join([_project_q(bj, xj) for bj, xj in zip(blocks, xs)], home)
    kvs = [_project_kv(bj, xj if kvj is None else kvj)
           for bj, xj, kvj in zip(blocks, xs, kv_xs)]
    k, v = (join([t[i] for t in kvs], home) for i in (0, 1))
    if kv_xs[0] is None:
        q, k = _rope(q, positions, cfg), _rope(k, positions, cfg)
    sq = q.shape[1]
    if (kv_xs[0] is None and sq % tp == 0 and sq // tp >= 128
            and sq == k.shape[1]):
        o = seqpar_attention(q, k, v, causal=causal, devices=devices)
    else:
        o = flash_attention(q, k, v, causal=causal)
    out = out_group(blocks, o, devices)
    return (out, [(0, k, v)]) if return_kv else out


def out_group(blocks: list, o, devices: list):
    """The output projection of whole heads ``o`` (B,S,H,hd) on
    ``devices[0]`` over a model-axis group, by ``wo``'s layout: each
    position's heads or head_dim columns through its rows of ``wo``, the
    partials added in position order (``row_sum``); replicated, once on
    the first position."""
    hl, hdl = blocks[0]["wo"].shape[:2]
    if hl == o.shape[2] and hdl == o.shape[3]:
        return _out(blocks[0], o)
    parts = [_out(bj, oj[:, :, j * hl:(j + 1) * hl] if hl < o.shape[2]
                  else oj[..., j * hdl:(j + 1) * hdl])
             for j, (bj, oj) in enumerate(zip(blocks, fan_out(o, devices)))]
    return row_sum(parts, devices)[0]


def gqa_decode_attention(q, k_cache, v_cache, kv_valid):
    """Grouped decode attention without materializing the KV repeat.
    q: (B,1,H,hd); k_cache/v_cache: (B,S,KV,hd); kv_valid: (B,S) bool."""
    b, _, h, hd = q.shape
    kv = k_cache.shape[2]
    qg = q.reshape(b, 1, kv, h // kv, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg.float(),
                     k_cache.float()) * (hd ** -0.5)
    s = torch.where(kv_valid[:, None, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bskh->bqkgh", (p / l).to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(b, 1, h, hd).to(q.dtype)


def init_kv_cache(cfg: ArchConfig, n_layers: int, batch: int, max_len: int,
                  dtype=torch.float32, device=None) -> dict:
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_decode(p, x, cache_k, cache_v, *, cfg: ArchConfig, cache_len):
    """One-token decode. x: (B,1,d); cache_k/v: (B,Smax,KV,hd); cache_len:
    (B,) int32 current lengths.  Returns (out, new_k, new_v); the caches
    passed in are not changed (the new ones are copies, one write per
    row at cache_len[b], a distinct index per row)."""
    b, smax = cache_k.shape[0], cache_k.shape[1]
    positions = cache_len[:, None]                      # (B,1)
    if cfg.rope_mode == "mrope":
        positions = positions[None].expand(3, b, 1)
    q = _rope(_project_q(p, x), positions, cfg)
    k_new, v_new = _project_kv(p, x)
    k_new = _rope(k_new, positions, cfg)
    rows = (torch.arange(b, device=x.device), cache_len.long())
    cache_k = cache_k.index_put(rows, k_new[:, 0].to(cache_k.dtype))
    cache_v = cache_v.index_put(rows, v_new[:, 0].to(cache_v.dtype))
    kv_valid = (torch.arange(smax, device=x.device)[None, :]
                <= cache_len[:, None])
    o = gqa_decode_attention(q, cache_k.to(x.dtype), cache_v.to(x.dtype),
                             kv_valid)
    return _out(p, o), cache_k, cache_v


def decode_qkv_group(blocks: list, xs: list, *, cfg: ArchConfig, positions,
                     devices: list, kv: bool = True):
    """One decode step's q (B,1,H,hd), and with ``kv`` the new k and v
    (B,1,KV,hd), whole heads on ``devices[0]``, of a model-axis group:
    each position projects its block of the heads (or of head_dim), the
    blocks joined in position order, then q and k roped at ``positions``
    (None: no RoPE, cross attention); a leaf the axis replicates is
    projected once, by position 0."""
    b0 = blocks[0]
    hd = cfg.resolved_head_dim

    def whole(name, fn, heads):
        w = b0[name]
        if w.shape[1] == heads and w.shape[2] == hd:
            return fn(b0, xs[0])
        parts = [fn(bj, xj) for bj, xj in zip(blocks, xs)]
        dim = 2 if w.shape[1] < heads else -1
        return tuple(join([p[i] for p in parts], devices[0], dim=dim)
                     for i in range(len(parts[0])))

    def rope(t):
        return t if positions is None else _rope(t, positions, cfg)

    q, = whole("wq", lambda bj, xj: (_project_q(bj, xj),), cfg.n_heads)
    if not kv:
        return rope(q)
    k, v = whole("wk", _project_kv, cfg.n_kv_heads)
    return rope(q), rope(k), v


def write_step(blocks: list, new, cache_len, rows: tuple) -> list:
    """A decode step's cache blocks: each of ``blocks`` [(box, tensor)]
    (box (rows, sequence, heads, head_dim) ranges, the rows global) with
    the new token's entry of ``new`` (B_g,1,KV,hd; the group's rows
    ``rows``) written at sequence index ``cache_len[b]`` where the block
    holds it, by a mask: each row writes at most one index of a block, and
    a block that does not hold it is copied unchanged."""
    r0 = rows[0]
    out = []
    for box, blk in blocks:
        (a, b), (s0, s1), (h0, h1), (d0, d1) = box
        dev = blk.device
        at = (torch.arange(s0, s1, device=dev)[None, :]
              == cache_len[a - r0:b - r0].to(dev)[:, None])
        val = new[a - r0:b - r0, :, h0:h1, d0:d1].to(dev, blk.dtype)
        out.append((box, torch.where(at[:, :, None, None], val, blk)))
    return out


def _slab_partial(q, blocks: list, valid, scale: float):
    """(m, l, acc) of one sequence slab, on q's device: the scores of q
    (B,1,KV',g,hd) against the slab's head_dim blocks [(columns, k, v)]
    (each k, v (B,S',KV',hd') on its device), their partial products
    added in column order on the first block's device, masked by
    ``valid`` (B,S'); the running max m and sum l (B,KV',g,1,1) and the
    unnormalised output acc (B,KV',g,1,hd), the columns joined."""
    home = q.device
    dev = blocks[0][1].device
    s = ordered_sum([torch.einsum("bqkgh,bskh->bkgqs",
                                  q[..., d0:d1].to(k.device).float(),
                                  k.float())
                     for (d0, d1), k, _ in blocks], dev) * scale
    s = torch.where(valid.to(dev)[:, None, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = join([torch.einsum("bkgqs,bskh->bkgqh", pj, v.float())
                for pj, (_, _, v) in zip(fan_out(p, [v.device for _, _, v
                                                     in blocks]), blocks)],
               home)
    return m.to(home), l.to(home), acc


def merge_slabs(partials: list):
    """The attention output (B,KV',g,1,hd) from the slabs' (m, l, acc) in
    slab order (``_slab_partial``): each slab's sum and output rescaled
    by exp(m_i − max m) and added in that order, then acc / l.  A slab
    whose keys are all masked has m = NEG_INF and adds exactly 0."""
    mg = partials[0][0]
    for m, _, _ in partials[1:]:
        mg = torch.maximum(mg, m)
    l_acc = o_acc = None
    for m, l, acc in partials:
        f = torch.exp(m - mg)
        l_acc = l * f if l_acc is None else l_acc + l * f
        o_acc = acc * f if o_acc is None else o_acc + acc * f
    return o_acc / l_acc


def decode_heads(q, k_blocks: list, v_blocks: list, valid_of, rows: tuple):
    """One step's attention output (B_g,1,H,hd) on q's device of q
    (B_g,1,H,hd) over a layer's cache held in blocks: ``k_blocks`` and
    ``v_blocks`` [(box, tensor)] of the same boxes (rows, sequence, KV
    heads, head_dim ranges; blocks outside the group's ``rows`` are
    skipped) and ``valid_of(rows, seq)`` the (rows, S') mask of the keys
    a query sees.  The blocks of one (rows, KV heads) tile are its
    sequence slabs, each of head_dim blocks: a tile of one whole block
    is ``gqa_decode_attention`` on its device; otherwise each slab's
    partial (its head_dim partial products added in column order) and
    the slabs merged by log-sum-exp in slab order (``merge_slabs``), on
    q's device."""
    b, _, h, hd = q.shape
    r0, r1 = rows
    kv_heads = max(box[2][1] for box, _ in k_blocks)
    g = h // kv_heads
    tiles: dict = {}
    for (box, k), (_, v) in zip(k_blocks, v_blocks):
        rb, sb, hb, db = box
        if rb[0] < r0 or rb[1] > r1:
            continue
        tiles.setdefault((rb, hb), {}).setdefault(sb, []).append((db, k, v))
    out = torch.empty_like(q)
    for ((a, b_), (h0, h1)), slabs in tiles.items():
        qt = q[a - r0:b_ - r0, :, h0 * g:h1 * g]
        slabs = sorted(slabs.items())
        if len(slabs) == 1 and len(slabs[0][1]) == 1 and \
                slabs[0][1][0][0] == (0, hd):
            sb, ((_, k, v),) = slabs[0]
            o = gqa_decode_attention(qt.to(k.device), k.to(q.dtype),
                                     v.to(q.dtype),
                                     valid_of((a, b_), sb).to(k.device))
        else:
            qg = qt.reshape(b_ - a, 1, h1 - h0, g, hd)
            parts = [_slab_partial(qg, sorted(blks, key=lambda t: t[0]),
                                   valid_of((a, b_), sb), hd ** -0.5)
                     for sb, blks in slabs]
            o = merge_slabs(parts).permute(0, 3, 1, 2, 4).reshape(
                b_ - a, 1, (h1 - h0) * g, hd).to(q.dtype)
        out[a - r0:b_ - r0, :, h0 * g:h1 * g] = o.to(q.device)
    return out


def attention_decode_group(blocks: list, xs: list, cache: dict, *,
                           cfg: ArchConfig, cache_len, devices: list,
                           rows: tuple, cross: bool = False):
    """One decode step of a layer's attention over one data position's
    model-axis group, the cache held in blocks (``cache_pspecs``):
    ``blocks[j]``/``xs[j]`` as ``attention_group``'s; ``cache`` {"k": [(box,
    tensor)], "v": [...]} the distinct blocks of the layer's K and V
    (box (rows, sequence, KV heads, head_dim), rows global), each on its
    holder; ``cache_len`` (B_g,) the group's rows' lengths on
    ``devices[0]``; ``rows`` (r0, r1) the group's rows.  q, k and v are
    projected by the positions and joined into whole heads
    (``decode_qkv_group``); the new token is written into the block that
    holds its index (``write_step``); each tile of blocks attends where
    it is stored (``decode_heads``); the whole heads' output goes through
    ``wo``'s layout (``out_group``).  Returns (out (B_g,1,d) on
    ``devices[0]``, {"k", "v": the new blocks}).  With ``cross`` (Whisper's
    cross attention over ``ck``/``cv``) nothing is written, no RoPE
    applies and every key is seen; the blocks come back unchanged."""
    b = cache_len.shape[0]
    positions = cache_len[:, None]
    if cfg.rope_mode == "mrope":
        positions = positions[None].expand(3, b, 1)
    if cross:
        q = decode_qkv_group(blocks, xs, cfg=cfg, positions=None,
                             devices=devices, kv=False)
        new = cache

        def valid_of(r, sb):
            return torch.ones((r[1] - r[0], sb[1] - sb[0]), dtype=torch.bool,
                              device=q.device)
    else:
        q, k_new, v_new = decode_qkv_group(blocks, xs, cfg=cfg,
                                           positions=positions,
                                           devices=devices)
        new = {"k": write_step(cache["k"], k_new, cache_len, rows),
               "v": write_step(cache["v"], v_new, cache_len, rows)}

        def valid_of(r, sb):
            return (torch.arange(sb[0], sb[1], device=q.device)[None, :]
                    <= cache_len[r[0] - rows[0]:r[1] - rows[0], None])
    o = decode_heads(q, new["k"], new["v"], valid_of, rows)
    return out_group(blocks, o, devices), new


def cross_attention_train(p, x, enc, *, cfg: ArchConfig,
                          return_kv: bool = False):
    """Encoder-decoder cross attention (Whisper).  x: (B,Sd,d) decoder
    states; enc: (B,Senc,d) encoder output.  Every query sees every key:
    the flash-attention wrapper non-causal, Sd > Senc allowed.  With
    return_kv, also the projected (k, v) (B,Senc,KV,hd): the decode
    cache's cross entries."""
    q = _project_q(p, x)
    k, v = _project_kv(p, enc)
    out = _out(p, flash_attention(q, k, v, causal=False))
    if return_kv:
        return out, (k, v)
    return out


def cross_attention_decode(p, x, cross_k, cross_v, *, cfg: ArchConfig):
    """Decode-time cross attention of x (B,S,d) over the precomputed
    encoder keys and values (B,Senc,KV,hd), plain (``direct_attention``
    on the repeated KV heads, as the reference's)."""
    q = _project_q(p, x)
    k = repeat_kv(cross_k.to(x.dtype), cfg.n_heads)
    v = repeat_kv(cross_v.to(x.dtype), cfg.n_heads)
    return _out(p, direct_attention(q, k, v, causal=False))
