"""The model axis's collectives: what GSPMD inserts into the JAX
package's sharded step, written out for the port's single-controller
mesh.  The reference has no module of its own for them: they are the
all-reduces and all-gathers that XLA lowers from its ``ctx.hint``
layout constraints, chiefly

  · the row-split products' partial sums, in
    ``src/repro/models/layers/``: ``attention.py:69`` (the head-split
    ``q``) and its product with ``wo`` at ``:245``, ``ffn.py:40-41`` (the
    hint on ``h`` and its product with ``wo``), ``rwkv6.py:163-165`` and
    ``:196`` (the head-split r/k/v and the column-split ``kk`` before
    their row-split products);
  · the embedding's concatenation over d_model: ``src/repro/models/
    lm.py:183`` and ``:201``, the hints that make the rows whole over the
    model axis;
  · the gathers to whole heads of a head_dim split and back:
    ``attention.py:285-287`` and ``:326`` (``seqpar_attention``'s query
    slabs, its K/V made whole, its output returned to the head_dim
    split), and ``rwkv6.py:163-165`` where ``tp_if(h)`` replicates the
    wkv over a model axis that cuts heads.

``fan_out`` sends one data position's activation to each model
position, and its backward adds the positions' gradients in
model-position order; ``row_sum`` adds one data position's partials in
model-position order and returns the sum on every position's device
(computed once, on the first, and copied to each other distinct device
through ``fan_out``, so every copy holds the same bits); ``join``
concatenates its column blocks (or its sequence slabs) in position
order on the first device; ``shared_reads`` hands a stored block to
each data position that reads it (an MoE layer's experts), their
gradients added in data-position order.  None writes with
duplicate indices or uses atomics, and no gradient is a sum whose order
depends on the autograd engine's device threads: a tensor read on two
cards gets one gradient from each through ``fan_out``'s one node, not
one from each of its readers as they finish.  So the step is the same
bits from run to run, on one card or several, and a checkpointed
block's recompute repeats it exactly.
"""
from __future__ import annotations

import torch


class _FanOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *devices):
        ctx.set_materialize_grads(False)
        ctx.home = x.device
        copies = {x.device: x}
        out = []
        for dev in devices:
            if dev not in copies:
                copies[dev] = x.to(dev)
            out.append(copies[dev].view_as(x))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        acc = None
        for g in grads:                      # in position order
            if g is not None:
                g = g.to(ctx.home)
                acc = g if acc is None else acc + g
        return (acc,) + (None,) * len(grads)


def fan_out(x, devices: list) -> list:
    """``x`` on each of ``devices`` (a view of it, or of one copy per
    other distinct device); the gradients of the positions' tensors are
    added in position order, on ``x``'s device."""
    return list(_FanOut.apply(x, *devices))


class _Reads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *grads):
        acc = None
        for g in grads:                      # in reader order
            if g is not None:
                acc = g if acc is None else acc.add_(g)
        return acc, None


def shared_reads(x, n: int) -> list:
    """``n`` views of ``x`` on its own device, one for each reader (the
    data positions that read a stored expert block); their gradients are
    added in reader order, into the first's storage, so that a block's
    gradient never stands beside more than its readers' own.  The readers'
    gradients must be fresh tensors of their own (a product's weight
    gradient), not shared with another branch of the graph."""
    return list(_Reads.apply(x, n))


def ordered_sum(partials: list, home):
    """Σ partials, in the order given, on ``home``."""
    acc = partials[0].to(home)
    for p in partials[1:]:
        acc = acc + p.to(home)
    return acc


def row_sum(partials: list, devices: list) -> list:
    """Σ partials, in the order given (model position 0 first), on each
    position's device: ``partials[j]`` is position j's, on
    ``devices[j]``."""
    return fan_out(ordered_sum(partials, devices[0]), devices)


def join(parts: list, home, dim: int = -1):
    """The concatenation of ``parts`` along ``dim`` (the last by default:
    column blocks), in model-position order, on ``home``; ``fan_out``
    hands it to the positions that read it."""
    return torch.cat([p.to(home) for p in parts], dim=dim)
