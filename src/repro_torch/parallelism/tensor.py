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
    model axis.

``fan_out`` sends one data position's activation to each model
position, and its backward adds the positions' gradients in
model-position order; ``row_sum`` adds one data position's partials in
model-position order, and ``col_cat`` concatenates its column blocks;
each returns the result on every position's device (computed once, on
the first, and copied to each other distinct device through
``fan_out``, so every copy holds the same bits).  None writes with
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


def row_sum(partials: list, devices: list) -> list:
    """Σ partials, in the order given (model position 0 first), on each
    position's device: ``partials[j]`` is position j's, on
    ``devices[j]``."""
    home = devices[0]
    acc = partials[0].to(home)
    for p in partials[1:]:
        acc = acc + p.to(home)
    return fan_out(acc, devices)


def col_cat(parts: list, devices: list) -> list:
    """The concatenation of ``parts`` along their last dimension, in
    model-position order, on each position's device."""
    home = devices[0]
    return fan_out(torch.cat([p.to(home) for p in parts], dim=-1), devices)
