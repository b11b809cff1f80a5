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
of the (H, hd) dims.  Where they split the heads, the sharded train step
runs ``attention_heads`` once per model position on its block of heads
and sums the positions' outputs (``parallelism/tensor.py:row_sum``); a
head_dim split (sequence-parallel attention, ``seqpar_attention`` in the
reference) is ROADMAP slice 11d.5b.2.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.models.layers.rope import apply_mrope, apply_rope
from repro_torch.parallelism.ctx import ShardCtx

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


def attention_heads(p, x, *, cfg: ArchConfig, positions, head0: int):
    """The output partial (B,S,d) of one model position's query heads
    ``head0 .. head0 + H'``: ``p`` holds its blocks (wq (d,H',hd), wo
    (H',hd,d), bq) and either its block of the KV heads (wk/wv (d,K',hd),
    bk/bv) or all of them, replicated (the reference's ``kv_h_ax`` None:
    the KV heads do not divide the model axis).  Replicated KV heads are
    projected only where the position's heads need them (query head i
    reads KV head i // (H / KV)), and repeated to one per query head where
    the position's heads straddle two groups unevenly.  The core
    attention is the flash-attention wrapper, as in ``attention_train``;
    the position's rows of wo make the partial, which ``row_sum`` adds
    up."""
    hl = p["wq"].shape[1]
    kv = {n: p[n] for n in ("wk", "wv", "bk", "bv") if n in p}
    rep = None
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
    q = _rope(_project_q(p, x), positions, cfg)
    k, v = _project_kv(kv, x)
    k = _rope(k, positions, cfg)
    if rep is not None:
        # each KV head expanded to its run of query heads (a sum in the
        # backward, no scatter)
        runs = [(c, rep.count(c)) for c in dict.fromkeys(rep)]
        k, v = (torch.cat([t[:, :, c:c + 1].expand(-1, -1, n, -1)
                           for c, n in runs], dim=2) for t in (k, v))
    return _out(p, flash_attention(q, k, v, causal=True))


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
