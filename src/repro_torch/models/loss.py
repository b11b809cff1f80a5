"""Sequence-chunked cross-entropy, the JAX package's ``models/loss.py``.

Logits are never materialized for the full sequence: the head product
and log-sum-exp run per sequence chunk (peak activation B x chunk x V
instead of B x S x V).  Labels == -1 are masked out.  It returns the
sum of the cross-entropy and the count of valid labels, so that the
train step forms the mean over all its data positions as the
reference's ``tot / max(cnt, 1)`` (``factory.combine_parts``).

Vocab-parallel: given the head as a list of column blocks, one per model
position of a data position (each on its position's device, the vocab
split as the reference's ``tp(padded_vocab)``), each position computes
only its block of every chunk's logits.  The log-sum-exp is taken over
the blocks with the global max (each block's max, then the max of those,
then Σ exp over the blocks in position order, then log), and the gold
logit comes from the block that holds the label; no position builds the
whole vocab's logits.
"""
from __future__ import annotations

import torch

from repro_torch.parallelism.tensor import fan_out


def chunked_cross_entropy(hidden, head_w, labels, *, chunk: int = 512):
    """hidden: (B,S,d); head_w: (d,V), or a list of its column blocks
    (d,V_j) in vocab order, one per model position; labels: (B,S) int
    (-1 = pad).  Returns the pair (the cross-entropy summed over the valid
    labels, f32; their count, int32), on ``hidden``'s device.  Chunks of
    ``chunk`` tokens; a length they do not divide runs in one shot, as in
    the reference."""
    b, s, d = hidden.shape
    blocks = list(head_w) if isinstance(head_w, (list, tuple)) else None
    c = min(chunk, s)
    if s % c:
        c = s
    dev = hidden.device
    tot = torch.zeros((), dtype=torch.float32, device=dev)
    cnt = torch.zeros((), dtype=torch.int32, device=dev)
    if blocks is None:
        vocab = torch.arange(head_w.shape[1], dtype=torch.int32, device=dev)
    for start in range(0, s, c):
        h = hidden[:, start:start + c]
        lab = labels[:, start:start + c]
        if blocks is None:
            logits = (h @ head_w.to(h.dtype)).float()          # (B,c,V)
            lse = torch.logsumexp(logits, dim=-1)
            mask_v = vocab[None, None, :] == lab[..., None]
            gold = torch.where(mask_v, logits, 0.0).sum(-1)
        else:
            lse, gold = _vocab_parallel(h, blocks, lab)
        valid = lab >= 0
        tot = tot + torch.where(valid, lse - gold, 0.0).sum()
        cnt = cnt + valid.sum(dtype=torch.int32)
    return tot, cnt


def _vocab_parallel(h, blocks: list, lab):
    """(log-sum-exp, gold logit), each (B,c) on ``h``'s device, of one
    chunk's logits over the column ``blocks``, each block's logits on its
    own device.  The max is a constant of the backward, as in
    ``torch.logsumexp``: the gradient is the softmax."""
    home = h.device
    logits = [(hj @ w.to(h.dtype)).float() for hj, w in zip(
        fan_out(h, [w.device for w in blocks]), blocks)]
    m = None
    for lg in logits:
        bm = lg.detach().amax(dim=-1).to(home)
        m = bm if m is None else torch.maximum(m, bm)
    se = gold = None
    off = 0
    for lg in logits:
        here = lg.device
        e = torch.exp(lg - m.to(here)[..., None]).sum(-1).to(home)
        se = e if se is None else se + e
        vocab = torch.arange(lg.shape[-1], dtype=torch.int32, device=here)
        local = (lab.to(here) - off)[..., None]
        g = torch.where(vocab[None, None, :] == local, lg, 0.0).sum(-1)
        gold = g.to(home) if gold is None else gold + g.to(home)
        off += lg.shape[-1]
    return m + torch.log(se), gold
