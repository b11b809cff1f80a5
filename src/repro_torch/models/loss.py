"""Sequence-chunked cross-entropy, the JAX package's ``models/loss.py``.

Logits are never materialized for the full sequence: the head product
and log-sum-exp run per sequence chunk (peak activation B x chunk x V
instead of B x S x V).  Labels == -1 are masked out.  The vocab-parallel
sharding of the reference comes with slice 11d.
"""
from __future__ import annotations

import torch


def chunked_cross_entropy(hidden, head_w, labels, *, chunk: int = 512):
    """hidden: (B,S,d); head_w: (d,V); labels: (B,S) int (-1 = pad).
    Returns the mean cross-entropy over the valid labels, f32.  Chunks of
    ``chunk`` tokens; a length they do not divide runs in one shot, as in
    the reference."""
    b, s, d = hidden.shape
    v = head_w.shape[1]
    c = min(chunk, s)
    if s % c:
        c = s
    vocab = torch.arange(v, dtype=torch.int32, device=hidden.device)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.int32, device=hidden.device)
    for start in range(0, s, c):
        h = hidden[:, start:start + c]
        lab = labels[:, start:start + c]
        logits = (h @ head_w.to(h.dtype)).float()              # (B,c,V)
        lse = torch.logsumexp(logits, dim=-1)
        mask_v = vocab[None, None, :] == lab[..., None]
        gold = torch.where(mask_v, logits, 0.0).sum(-1)
        valid = lab >= 0
        tot = tot + torch.where(valid, lse - gold, 0.0).sum()
        cnt = cnt + valid.sum(dtype=torch.int32)
    return tot / torch.clamp(cnt, min=1).float()
