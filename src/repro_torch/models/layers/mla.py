"""Multi-head Latent Attention (DeepSeek-V3), the JAX package's
``models/layers/mla.py``.

The training and prefill path materializes per-head K/V from the KV
latent; the decode path uses the *absorbed* form: scores are taken
directly against the cached latent (c_kv, k_rope), so the KV cache holds
only kv_lora_rank + qk_rope_head_dim floats per token.

Queries and keys have head size qk_nope_head_dim + qk_rope_head_dim (192
at full width), values v_head_dim (128).  That is outside the
flash-attention kernel's contract (one head size for q, k and v), and
the reference's MLA runs the plain ``chunked_attention``, not its Pallas
kernel: so does the port.  MLA launches no kernel of the port, and there
is no fallback from the flash-attention kernel to it.

Under the sharded train step's model axis (``mla_group``) the heads are
split, as the reference's rules split ``wuq``, ``wuk``, ``wuv`` and
``wo`` (``repro/parallelism/sharding.py``): the latents run once per
data position, each model position attends with its heads, and the
partials of the output projection are added in position order.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers.attention import (NEG_INF, chunked_attention,
                                                  write_step)
from repro_torch.models.layers.common import apply_norm, init_norm
from repro_torch.models.layers.rope import apply_rope
from repro_torch.parallelism.sharding import cut
from repro_torch.parallelism.tensor import fan_out, row_sum


def init_mla(draw, cfg: ArchConfig, dtype=torch.float32, device=None) -> dict:
    """draw(shape, std) returns f32 normal draws times std; scales, names
    and draw order are the reference's."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim
    s = d ** -0.5
    p = {"wdq": draw((d, m.q_lora_rank), s).to(dtype),
         "q_norm": init_norm("rmsnorm", m.q_lora_rank, dtype, device)}
    p["wuq"] = draw((m.q_lora_rank, h, qk + m.qk_rope_head_dim),
                    m.q_lora_rank ** -0.5).to(dtype)
    p["wdkv"] = draw((d, m.kv_lora_rank + m.qk_rope_head_dim), s).to(dtype)
    p["kv_norm"] = init_norm("rmsnorm", m.kv_lora_rank, dtype, device)
    p["wuk"] = draw((m.kv_lora_rank, h, qk), m.kv_lora_rank ** -0.5).to(dtype)
    p["wuv"] = draw((m.kv_lora_rank, h, m.v_head_dim),
                    m.kv_lora_rank ** -0.5).to(dtype)
    p["wo"] = draw((h, m.v_head_dim, d), (h * m.v_head_dim) ** -0.5).to(dtype)
    return p


def _up(c, w):
    """c (B,S,r) @ w (r, H, k) -> (B,S,H,k)."""
    b, s, _ = c.shape
    return (c @ w.to(c.dtype).reshape(w.shape[0], -1)).reshape(
        b, s, w.shape[1], w.shape[2])


def _out(p, o):
    """o (B,S,H,dv) @ wo (H,dv,d) -> (B,S,d)."""
    b, s, h, dv = o.shape
    return o.reshape(b, s, h * dv) @ p["wo"].to(o.dtype).reshape(h * dv, -1)


def q_latent(p, x, cfg: ArchConfig):
    """The query latent cq (B,S,q_lora_rank): x's down-projection, normed."""
    cq = x @ p["wdq"].to(x.dtype)
    return apply_norm(p["q_norm"], cq, kind="rmsnorm", eps=cfg.norm_eps)


def _queries(p, cq, cfg: ArchConfig, positions):
    """(q_nope, q_rope) of p's heads (``wuq``'s, or a block of them)."""
    m = cfg.mla
    q = _up(cq, p["wuq"])
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions,
                        theta=cfg.rope_theta)
    return q_nope, q_rope


def _latents(p, x, cfg: ArchConfig, positions):
    m = cfg.mla
    ckr = x @ p["wdkv"].to(x.dtype)                     # (B,S,dc+rope)
    ckv = apply_norm(p["kv_norm"], ckr[..., :m.kv_lora_rank],
                     kind="rmsnorm", eps=cfg.norm_eps)
    k_rope = apply_rope(ckr[..., None, m.kv_lora_rank:], positions,
                        theta=cfg.rope_theta)[..., 0, :]   # (B,S,rope)
    return ckv, k_rope


def mla_heads(p, cq, ckv, k_rope, *, cfg: ArchConfig, positions,
              chunk: int = 1024):
    """Causal attention of p's heads (all of them, or the block that a
    model position holds of ``wuq``, ``wuk``, ``wuv`` and ``wo``) from the
    latents, through its rows of ``wo``: (B,S,d), the whole output or
    that position's partial of it."""
    m = cfg.mla
    q_nope, q_rope = _queries(p, cq, cfg, positions)
    k_nope = _up(ckv, p["wuk"])
    v = _up(ckv, p["wuv"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        k_nope.shape[:3] + (m.qk_rope_head_dim,))], dim=-1)
    o = chunked_attention(q, k, v, causal=True, chunk_q=chunk, chunk_k=chunk)
    return _out(p, o)


def mla_train(p, x, *, cfg: ArchConfig, positions, chunk: int = 1024,
              return_cache: bool = False):
    """Full-sequence causal MLA.  x: (B,S,d); with ``return_cache`` also
    the latent cache entries (ckv (B,S,kv_lora), k_rope (B,S,rope))."""
    ckv, k_rope = _latents(p, x, cfg, positions)
    out = mla_heads(p, q_latent(p, x, cfg), ckv, k_rope, cfg=cfg,
                    positions=positions, chunk=chunk)
    if return_cache:
        return out, (ckv, k_rope)
    return out


def mla_group(blocks: list, x, *, cfg: ArchConfig, positions, devices: list,
              chunk: int = 1024, return_cache: bool = False):
    """MLA over one data position's model-axis group, on ``devices[0]``:
    ``blocks[j]`` is model position j's block of the layer's leaves (the
    rules' ``tp(n_heads)`` on ``wuq``, ``wuk``, ``wuv`` and ``wo``'s
    rows), ``x`` the normed input on ``devices[0]``.  The latents and the
    query latent run once, with position 0's copies of the replicated
    ``wdq``, ``wdkv`` and norms; each position attends with its heads
    (``fan_out`` hands it the latents), and the partials through its rows
    of ``wo`` are added in position order.  Where the model axis does not
    split the heads, MLA runs once, on position 0.  With ``return_cache``
    also the latent cache entries, as ``mla_train``'s."""
    b0 = blocks[0]
    if b0["wuq"].shape[1] == cfg.n_heads:              # replicated
        return mla_train(b0, x, cfg=cfg, positions=positions, chunk=chunk,
                         return_cache=return_cache)
    ckv, k_rope = _latents(b0, x, cfg, positions)
    lat = [fan_out(t, devices) for t in (q_latent(b0, x, cfg), ckv, k_rope)]
    parts = [mla_heads(bj, *(t[j] for t in lat), cfg=cfg,
                       positions=positions.to(devices[j]), chunk=chunk)
             for j, bj in enumerate(blocks)]
    out = row_sum(parts, devices)[0]
    return (out, (ckv, k_rope)) if return_cache else out


def init_latent_cache(cfg: ArchConfig, n_layers: int, batch: int,
                      max_len: int, dtype=torch.float32, device=None) -> dict:
    """The zeroed latent cache of a group of MLA layers: ckv (n, B,
    max_len, kv_lora_rank) and kr (n, B, max_len, qk_rope_head_dim)."""
    m = cfg.mla
    lead = (n_layers, batch, max_len)
    return {"ckv": torch.zeros(lead + (m.kv_lora_rank,), dtype=dtype,
                               device=device),
            "kr": torch.zeros(lead + (m.qk_rope_head_dim,), dtype=dtype,
                              device=device)}


def mla_decode(p, x, cache_ckv, cache_krope, *, cfg: ArchConfig, cache_len):
    """Absorbed one-token decode.  x: (B,1,d); cache_ckv: (B,Smax,dc);
    cache_krope: (B,Smax,rope); cache_len: (B,) int32.  Returns (out,
    new_ckv, new_krope); the caches passed in are not changed (one write
    per row at cache_len[b], a distinct index per row)."""
    b = cache_ckv.shape[0]
    positions = cache_len[:, None]
    cq = q_latent(p, x, cfg)
    ckv_new, krope_new = _latents(p, x, cfg, positions)
    rows = (torch.arange(b, device=x.device), cache_len.long())
    cache_ckv = cache_ckv.index_put(rows, ckv_new[:, 0].to(cache_ckv.dtype))
    cache_krope = cache_krope.index_put(rows,
                                        krope_new[:, 0].to(cache_krope.dtype))
    out = absorbed_decode(p, cq, cache_ckv, cache_krope, cfg=cfg,
                          cache_len=cache_len)
    return out, cache_ckv, cache_krope


def absorbed_decode(p, cq, cache_ckv, cache_krope, *, cfg: ArchConfig,
                    cache_len):
    """The absorbed attention of p's heads (all of them, or a model
    position's block of ``wuq``, ``wuk``, ``wuv`` and ``wo``) for one step's
    query latent cq (B,1,q_lora) over the latent cache (B,Smax,dc) and
    (B,Smax,rope), the new token written: (B,1,d), the whole output or the
    position's partial through its rows of ``wo``."""
    m = cfg.mla
    dt = cq.dtype
    smax = cache_ckv.shape[1]
    q_nope, q_rope = _queries(p, cq, cfg, cache_len[:, None])
    # absorb W_uk into q:  q_c = q_nope @ W_uk^T  -> (B,1,H,dc)
    q_c = torch.einsum("bshk,rhk->bshr", q_nope, p["wuk"].to(dt))
    s = torch.einsum("bshr,btr->bhst", q_c.float(),
                     cache_ckv.to(dt).float())
    s = s + torch.einsum("bshk,btk->bhst", q_rope.float(),
                         cache_krope.to(dt).float())
    s = s * ((m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5)
    valid = (torch.arange(smax, device=cq.device)[None, :]
             <= cache_len[:, None])
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    prob = torch.softmax(s, dim=-1)
    o_c = torch.einsum("bhst,btr->bshr", prob.to(dt),
                       cache_ckv.to(dt))               # (B,1,H,dc)
    o = torch.einsum("bshr,rhk->bshk", o_c, p["wuv"].to(dt))
    return torch.einsum("bshk,hkd->bsd", o, p["wo"].to(dt))


def mla_decode_group(blocks: list, x, cache: dict, *, cfg: ArchConfig,
                     cache_len, devices: list, rows: tuple):
    """One absorbed decode step of MLA over one data position's model-axis
    group, its latent cache held in blocks (``cache_pspecs``: by
    sequence): ``blocks`` as ``mla_group``'s, ``x`` (B_g,1,d) and
    ``cache_len`` (B_g,) on ``devices[0]``, ``cache`` {"ckv": [(box,
    tensor)], "kr": [...]} the layer's distinct blocks (box (rows,
    sequence, columns), rows global), ``rows`` the group's.  The latents of
    the new token run once (position 0's replicated ``wdq``, ``wdkv`` and
    norms) and are written into the block that holds their index
    (``attention.write_step``'s mask); the slabs are joined on
    ``devices[0]`` for the step, and each position attends with its heads
    (``absorbed_decode``, the partials added in position order; once, on
    position 0, where the model axis does not split the heads).  Returns
    (out (B_g,1,d), {"ckv", "kr": the new blocks}); the cache stays in its
    blocks between steps."""
    b0, home = blocks[0], devices[0]
    cq = q_latent(b0, x, cfg)
    lat = _latents(b0, x, cfg, cache_len[:, None])
    new, whole = {}, []
    for name, t in zip(("ckv", "kr"), lat):
        mine = [(box, blk) for box, blk in cache[name]
                if rows[0] <= box[0][0] and box[0][1] <= rows[1]]
        # the step's row as a one-head, full-width entry of the writer
        wrote = write_step([((r, s, (0, 1), c), blk[:, :, None])
                            for (r, s, c), blk in mine],
                           t[:, :, None], cache_len, rows)
        new[name] = [(box, blk[:, :, 0]) for (box, _), (_, blk) in
                     zip(mine, wrote)]
        smax = max(box[1][1] for box, _ in mine)
        whole.append(cut((rows, (0, smax), (0, t.shape[-1])), new[name],
                         home))
    if b0["wuq"].shape[1] == cfg.n_heads:              # replicated
        return absorbed_decode(b0, cq, *whole, cfg=cfg,
                               cache_len=cache_len), new
    ins = [fan_out(t, devices) for t in (cq, *whole, cache_len)]
    parts = [absorbed_decode(bj, *(t[j] for t in ins[:3]), cfg=cfg,
                             cache_len=ins[3][j])
             for j, bj in enumerate(blocks)]
    return row_sum(parts, devices)[0], new
