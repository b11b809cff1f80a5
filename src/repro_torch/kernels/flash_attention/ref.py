"""Plain PyTorch attention, the function that the flash-attention kernel
computes: the reference's ``repro/kernels/flash_attention/ref.py:
attention_ref`` on the port's layout.

q is (B, Sq, H, hd) and k, v are (B, Sk, KV, hd) with H % KV == 0; query
head h reads KV head h // (H // KV), which is what repeating each KV head
H // KV times (``jnp.repeat(k, H // KV, axis=2)``) gives, without making
the repeat.  Scores and softmax are f32 (f64 for f64 inputs, so that the
card can hold the f32 forms against an f64 truth), the causal mask is
right-aligned (query i sits at key position Sk − Sq + i) at -1e30, and
the result has q's dtype."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def check_shapes(q, k, v) -> None:
    """Raise ValueError unless q (B, Sq, H, hd), k and v (B, Sk, KV, hd)
    fit together with H % KV == 0 and Sq <= Sk.  Sq > Sk is outside the
    contract: the Pallas kernel skips whole k-blocks there and disagrees
    with its own oracle on rows that see no key (ROADMAP §3, F4)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} must be (B, S, heads, hd)")
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    sk = k.shape[1]
    if tuple(k.shape) != (b, sk, kv, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if kv == 0 or h % kv:
        raise ValueError(f"flash_attention: {h} query heads do not split "
                         f"into groups over {kv} KV heads")
    if sq > sk:
        raise ValueError(f"flash_attention: Sq = {sq} > Sk = {sk}; the "
                         "kernel's contract is Sq <= Sk")


def attention_plain(q, k, v, *, causal: bool = True):
    """q: (B,Sq,H,hd); k, v: (B,Sk,KV,hd) -> (B,Sq,H,hd) in q's dtype."""
    check_shapes(q, k, v)
    b, sq, h, hd = q.shape
    s, dt = _scores(q, k, causal)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(dt))
    return o.reshape(b, sq, h, hd).to(q.dtype)


def _scores(q, k, causal: bool):
    """Scaled, masked scores (B, KV, G, Sq, Sk) in f32 (f64 for f64
    inputs), and that dtype."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    dt = torch.promote_types(q.dtype, torch.float32)
    qg = q.to(dt).reshape(b, sq, kv, h // kv, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(dt)) * (hd ** -0.5)
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        kpos = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(qpos >= kpos, s, NEG_INF)
    return s, dt


def attention_backward_plain(q, k, v, do, *, causal: bool = True):
    """The gradient of ``attention_plain``, by explicit formulas
    (FlashAttention-2's): P = softmax(s), dV = P^T dO, dP = dO V^T,
    D = rowsum(dO . O), dS = P (dP - D), dQ = scale dS K, dK = scale dS^T
    Q, with dK and dV summed over each KV head's group of query heads.
    Computed in f32 (f64 for f64 inputs); returns (dq, dk, dv) in q's,
    k's and v's dtypes."""
    check_shapes(q, k, v)
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    s, dt = _scores(q, k, causal)
    p = torch.softmax(s, dim=-1)
    vf, kf = v.to(dt), k.to(dt)
    qg = q.to(dt).reshape(b, sq, kv, g, hd)
    dog = do.to(dt).reshape(b, sq, kv, g, hd)
    og = torch.einsum("bkgqs,bskd->bqkgd", p, vf)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, vf)
    d_rows = (dog * og).sum(-1).permute(0, 2, 3, 1)          # (B,KV,G,Sq)
    ds = p * (dp - d_rows[..., None])
    scale = hd ** -0.5
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg) * scale
    return (dq.reshape(b, sq, h, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
