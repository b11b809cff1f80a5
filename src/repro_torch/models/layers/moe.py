"""Mixture-of-Experts with sort-based capacity dispatch, the JAX package's
``models/layers/moe.py``.

Tokens are sorted by expert id (a stable sort, so the order is fixed),
packed into a fixed-capacity (E, C, d) buffer, run through every expert's
SwiGLU FFN as batched products over the expert axis, and combined back
with their router weights.  A token routed to an expert whose C slots are
full is dropped there (its weight counts as 0).  The router runs in f32;
a switch-style load-balance loss from the top-1 counts is returned beside
the output.

Where the port differs in form from the reference, and why the result is
the same:

  · Top-k: ``jax.lax.top_k`` puts the lower expert index first on equal
    probabilities; ``torch.topk`` does not (on a tensor of 64 equal
    values it returned experts 42 and 43 where JAX returns 0 and 1).  The
    router takes the first k of a stable descending ``torch.sort``, which
    breaks ties as JAX does.
  · Dispatch: the reference writes every dropped entry into one dead row
    (``buf.at[slot].set`` with duplicate indices there) and discards it.
    Here each slot computes its token from the sorted order (slot p of
    expert e holds the e-th run's p-th entry while p is below the run's
    length), and the buffer is a gather of the tokens, an empty slot
    reading an appended zero row: the same buffer, with no writes to
    order and no wait for the host.
  · Combine: the reference scatter-adds each entry's weighted output into
    its token (``y.at[order // k].add``), in the sorted order, which for
    one token is its experts in ascending id.  Here each token gathers its
    k entries and sums them in that order, 0 + v_1 + ... + v_k, with no
    atomics: deterministic on the card.  With k = 2 this is the
    reference's sum bit for bit; with deepseek-v3's k = 8 it is the same
    sequence of f32 additions, and the CPU tests hold it within 1e-5.
  · Token groups: the reference splits the N tokens into G groups (one
    per data shard, ``moe_groups``), each with its own capacity and
    dispatch.  ``groups`` here does the same in one dispatch: group g's
    expert e is dispatched as expert g·E + e, and a stable sort of those
    ids orders each group's entries as the group's own sort does.  The
    sharded train step runs each data position's rows with one group, or
    a replicated batch with G groups (train/train_step.py).
  · Balance loss: the reference takes it over all groups, from the top-1
    counts and the mean router probability.  ``moe_layer`` returns those
    statistics, (2, E) f32, so that the sharded step can sum them over
    the data positions before ``balance_loss`` forms the loss.

The expert products are plain batched ``torch.bmm`` over the expert axis,
as the reference's are ``jnp.einsum`` outside any Pallas kernel.

Under the sharded train step the experts are placed by ``ctx.ep_axes``
(``parallelism/sharding.py``): a data position routes and dispatches its
own tokens, then ``experts_group`` cuts its (E, C, d) buffer by expert
block and runs each block where it is stored, on each owner's columns of
the expert FFN's width (the '2d' placement), the down-projection's
partials added in model-position order; the blocks' outputs come back to
the data position, which combines them as above.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers.ffn import apply_ffn, init_ffn
from repro_torch.parallelism.tensor import fan_out, join, ordered_sum


def init_moe(draw, cfg: ArchConfig, dtype=torch.float32) -> dict:
    """draw(shape, std) returns f32 normal draws times std; scales, names
    and draw order are the reference's."""
    m = cfg.moe
    d, e, f = cfg.d_model, m.n_experts, m.d_ff_expert
    si, so = d ** -0.5, f ** -0.5
    p = {"router": draw((d, e), si).float(),
         "wi_gate": draw((e, d, f), si).to(dtype),
         "wi_up": draw((e, d, f), si).to(dtype),
         "wo": draw((e, f, d), so).to(dtype)}
    if m.n_shared_experts:
        p["shared"] = init_ffn(draw, d, m.n_shared_experts * f, cfg.act,
                               dtype)
    if m.dense_residual:
        p["dense"] = init_ffn(draw, d, cfg.d_ff, cfg.act, dtype)
    return p


def _capacity(n_tokens: int, top_k: int, n_experts: int, cf: float) -> int:
    c = int(n_tokens * top_k * cf / n_experts) + 1
    c = max(top_k, min(c, n_tokens * top_k))
    return -(-c // 4) * 4  # round up to a multiple of 4


def top_k_experts(probs, k: int):
    """(weights, expert ids), each (..., k): the k largest probabilities,
    ties to the lower expert id, as ``jax.lax.top_k``."""
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[..., :k], idx[..., :k]


def _dispatch(tokens, top_idx, n_experts: int, capacity: int):
    """tokens (N, d), top_idx (N, K) -> (buf (E, C, d), slot, keep,
    order), slot/keep/order over the N*K entries in sorted order as the
    reference's."""
    n, k = top_idx.shape
    dev = tokens.device
    flat_e = top_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(
        n_experts, device=dev, dtype=sorted_e.dtype))
    pos = torch.arange(n * k, device=dev) - starts[sorted_e]
    keep = pos < capacity
    slot = torch.where(keep, sorted_e * capacity + pos,
                       n_experts * capacity)
    # slot -> source token: slot e*C + p holds sorted entry starts[e] + p
    # while p is below expert e's count; an empty slot reads row n, a zero
    # row.  Computed, not scattered: no duplicate writes, no host wait
    ends = torch.cat([starts[1:], starts.new_full((1,), n * k)])
    at = starts[:, None] + torch.arange(capacity, device=dev)   # (E, C)
    src = torch.where(at < ends[:, None],
                      order[torch.clamp(at, max=n * k - 1)] // k,
                      n).reshape(-1)
    padded = torch.cat([tokens, tokens.new_zeros((1, tokens.shape[1]))])
    buf = padded[src].reshape(n_experts, capacity, -1)
    return buf, slot, keep, order


def _combine(out_buf, slot, keep, order, top_idx, top_w):
    """out_buf (E, C, d) -> y (N, d): each token's k weighted expert
    outputs, summed in the reference's scatter order (ascending expert
    id)."""
    n, k = top_idx.shape
    d = out_buf.shape[-1]
    flat = out_buf.reshape(-1, d)
    inv = torch.argsort(order)                 # flat entry -> sorted position
    s_slot, s_keep = slot[inv], keep[inv]      # (N*K,), by token and rank
    w = (top_w.reshape(-1) * s_keep).to(out_buf.dtype)
    rows = flat[torch.clamp(s_slot, max=flat.shape[0] - 1)]
    vals = torch.where(s_keep[:, None], rows * w[:, None], 0.0)
    # the reference adds a token's entries in sorted order: by expert id
    rank = torch.argsort(top_idx, dim=-1)
    vals = torch.take_along_dim(vals.reshape(n, k, d), rank[:, :, None], 1)
    y = torch.zeros((n, d), dtype=out_buf.dtype, device=out_buf.device)
    for j in range(k):
        y = y + vals[:, j]
    return y


def moe_groups(dp: int, n_tokens: int, top_k: int) -> int:
    """The reference's token groups for ``n_tokens`` tokens on ``dp``
    data shards: dp when it divides them and each shard holds at least
    top_k, else 1."""
    return dp if dp > 1 and n_tokens % dp == 0 and n_tokens >= dp * top_k \
        else 1


def balance_loss(stats, n_tokens: int, n_experts: int):
    """The switch-style load-balance loss of router statistics (2, E)
    (top-1 counts, summed probabilities) over ``n_tokens`` tokens:
    E · Σ_e (count_e / N) · (probability_e / N)."""
    return n_experts * torch.sum((stats[0] / n_tokens)
                                 * (stats[1] / n_tokens))


def route(p: dict, tokens, k: int):
    """(probs (N, E), top_w (N, K), top_idx (N, K)) of the f32 router over
    tokens (N, d): the k largest probabilities renormalised to sum 1."""
    logits = tokens.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_idx = top_k_experts(probs, k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return probs, top_w, top_idx


def expert_ffn(p: dict, buf):
    """Every expert's SwiGLU FFN on its rows of buf (E, C, d), batched
    over the expert axis: p's ``wi_gate``/``wi_up`` (E, d, F) and ``wo``
    (E, F, d), or any block of them (a block of experts, a block of F)."""
    h = (F.silu(torch.bmm(buf, p["wi_gate"].to(buf.dtype)))
         * torch.bmm(buf, p["wi_up"].to(buf.dtype)))
    return torch.bmm(h, p["wo"].to(buf.dtype))


def experts_group(blocks: list, devices: list, owners: list, buf):
    """``expert_ffn`` of buf (E, C, d) over placed experts: ``blocks[q]``
    is mesh position q's block of the expert leaves, on ``devices[q]``,
    and ``owners[k]`` the positions that run expert block k, one for each
    block of the FFN's width in order.  Block k's rows of buf go to each
    owner (``fan_out``), the owners' down-projection partials are added in
    that order on the first, and the blocks' outputs are joined in expert
    order on buf's device."""
    outs, e0 = [], 0
    for qs in owners:
        devs = [devices[q] for q in qs]
        n = blocks[qs[0]]["wi_gate"].shape[0]
        outs.append(ordered_sum(
            [expert_ffn(blocks[q], xq)
             for q, xq in zip(qs, fan_out(buf[e0:e0 + n], devs))], devs[0]))
        e0 += n
    return join(outs, buf.device, dim=0)


def moe_routed(p: dict, x, *, cfg: ArchConfig, groups: int = 1, ffn=None):
    """The routed experts' part of ``moe_layer``: (y, stats).  ``ffn``
    (buf (E, G·C, d) -> out (E, G·C, d)) runs the experts; by default
    ``expert_ffn`` on p's leaves."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.n_experts, m.top_k
    n = b * s
    if n % groups:
        raise ValueError(f"{n} tokens do not split into {groups} groups")
    cap = _capacity(n // groups, k, e, m.capacity_factor)
    tokens = x.reshape(n, d)

    # ---- router (f32) ----------------------------------------------------
    probs, top_w, top_idx = route(p, tokens, k)              # (N, K)
    counts = (top_idx[:, :1] == torch.arange(e, device=x.device)).sum(
        0, dtype=torch.float32)
    stats = torch.stack([counts, probs.sum(0)])

    # ---- dispatch, experts, combine --------------------------------------
    if groups > 1:                  # group g's expert e as id g * E + e
        top_idx = top_idx + (torch.arange(n, device=x.device)
                             // (n // groups) * e)[:, None]
    buf, slot, keep, order = _dispatch(tokens, top_idx, groups * e, cap)
    if groups > 1:                  # (G*E, C, d) -> (E, G*C, d)
        buf = buf.reshape(groups, e, cap, d).transpose(0, 1).reshape(
            e, groups * cap, d)
    out_buf = (ffn or (lambda t: expert_ffn(p, t)))(buf)
    del buf
    if groups > 1:
        out_buf = out_buf.reshape(e, groups, cap, d).transpose(0, 1).reshape(
            groups * e, cap, d)
    y = _combine(out_buf, slot, keep, order, top_idx, top_w).reshape(b, s, d)
    return y, stats


def moe_layer(p: dict, x, *, cfg: ArchConfig, groups: int = 1):
    """x: (B,S,d), its B·S tokens in ``groups`` equal groups.  Returns (y,
    stats): stats (2, E) f32, the tokens' top-1 counts and the sum of
    their router probabilities (``balance_loss``)."""
    y, stats = moe_routed(p, x, cfg=cfg, groups=groups)
    if "shared" in p:
        y = y + apply_ffn(p["shared"], x, act=cfg.act)
    if "dense" in p:
        y = y + apply_ffn(p["dense"], x, act=cfg.act)
    return y, stats
