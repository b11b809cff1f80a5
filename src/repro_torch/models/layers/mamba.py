"""Mamba-1 selective SSM (jamba's mamba sublayer), the JAX package's
``models/layers/mamba.py``.

The diagonal recurrence  h_t = exp(Δ_t·A)⊙h_{t-1} + Δ_t·B_t·u_t  is affine.
``ssm_chunked`` evaluates it in chunks: inside a chunk an exact affine
scan in product form, composing (a2·a1, a2·b1 + b2) with the decays
da = exp(Δ·A) ≤ 1 themselves (a Hillis–Steele scan of log2(chunk)
rounds), then the state h carried from chunk to chunk.  It takes no
``cumsum`` of log decays: exp of differences of large sums loses
precision and its gradient turns NaN under strong decay (ROADMAP §3, F5
and F7 for the wkv).  The summation order is not that of
``lax.associative_scan``, so the two agree to rounding (the JAX
package's own bound for this function, rtol 2e-4 and atol 1e-4).  The
selective scan is plain PyTorch, as the reference's is plain jnp: there
is no TPU kernel to port.

Under the sharded train step's model axis (``mamba_group``) d_inner is
split, as the reference's rules split it (``repro/parallelism/
sharding.py``): each model position runs its channels, the row-split
``wxp`` partials are added in position order and handed back to every
position before the softplus, and so are the partials of ``wo``.

Decode is the training form at chunk 1.  A (B, C, di, ds) f32 tensor is
268 MB at jamba's full width (B 8, C 64, di 8192, ds 16): a chunk keeps
a few of them alive, and under autograd a chunk is checkpointed, so that
a training step's backward holds one chunk's, not a whole sequence's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers.common import ParamDict
from repro_torch.parallelism.tensor import fan_out, row_sum


def init_mamba(draw, cfg: ArchConfig, dtype=torch.float32,
               device=None) -> dict:
    """draw(shape, std) returns f32 normal draws times std; the scales,
    names and draw order are the reference's."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    sc = d ** -0.5
    p = {"wx": draw((d, di), sc).to(dtype),
         "wz": draw((d, di), sc).to(dtype),
         "conv_w": draw((s.d_conv, di), 0.1).to(dtype),
         "conv_b": torch.zeros((di,), dtype=dtype, device=device),
         "wxp": draw((di, s.dt_rank + 2 * s.d_state), di ** -0.5).to(dtype),
         "wdt": draw((s.dt_rank, di), s.dt_rank ** -0.5).to(dtype)}
    p["dt_bias"] = torch.full((di,), -4.0, dtype=dtype, device=device)
    p["A_log"] = torch.log(torch.arange(
        1, s.d_state + 1, dtype=torch.float32, device=device)).expand(
        di, s.d_state).to(dtype).contiguous()
    p["D"] = torch.ones((di,), dtype=dtype, device=device)
    p["wo"] = draw((di, d), di ** -0.5).to(dtype)
    return p


def _conv_shift(u, conv_w, conv_b, init_state):
    """Causal depthwise conv via K shifted adds, summed from zeros in the
    reference's order, then the bias.  u: (B,S,di); conv_w: (K,di);
    init_state: (B,K-1,di).  Returns (out, the last K-1 inputs: the new
    conv state)."""
    k = conv_w.shape[0]
    padded = torch.cat([init_state.to(u.dtype), u], dim=1)
    out = torch.zeros_like(u)
    s = u.shape[1]
    for i in range(k):
        out = out + padded[:, i:i + s] * conv_w[i].to(u.dtype)
    new_state = padded[:, -(k - 1):] if k > 1 else init_state
    return out + conv_b.to(u.dtype), new_state


def _ssm_params(p, uc, cfg: ArchConfig):
    """(dt (B,S,di), a (di,ds), B (B,S,ds), C (B,S,ds)), all f32."""
    return _ssm_split(p, uc @ p["wxp"].to(uc.dtype), cfg)


def _ssm_split(p, xdbc, cfg: ArchConfig):
    """``_ssm_params`` from xdbc = uc @ wxp (B,S,dt_rank + 2·ds): dt of
    p's channels (``wdt``'s columns, ``dt_bias``, ``A_log``: all of them,
    or a model position's block)."""
    s = cfg.ssm
    dt_in = xdbc[..., :s.dt_rank]
    bmat = xdbc[..., s.dt_rank:s.dt_rank + s.d_state].float()
    cmat = xdbc[..., s.dt_rank + s.d_state:].float()
    dt = F.softplus((dt_in @ p["wdt"].to(xdbc.dtype)).float()
                    + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())
    return dt, a, bmat, cmat


def _affine_scan(da, dbu):
    """Inclusive scan of the affine maps h -> da_t h + dbu_t along axis 1:
    (A_t, B_t) with h_t = A_t h_0 + B_t.  Hillis–Steele: in round d each
    position composes with the one d before it, (a2, b2)∘(a1, b1) =
    (a2·a1, a2·b1 + b2), the products of decays taken as products."""
    c = da.shape[1]
    d = 1
    while d < c:
        a_prev, b_prev = da[:, :-d], dbu[:, :-d]
        head_a, tail_a = da[:, :d], da[:, d:]
        dbu = torch.cat([dbu[:, :d], tail_a * b_prev + dbu[:, d:]], dim=1)
        da = torch.cat([head_a, tail_a * a_prev], dim=1)
        d *= 2
    return da, dbu


def _ssm_chunk(dtc, a, bc, cc, uc, h):
    """One chunk of ``ssm_chunked``: (y (B,C,di) f32, the chunk's end
    state (B,di,ds) f32) from the state h before it."""
    da = torch.exp(dtc[..., None] * a)                     # (B,C,di,ds) <= 1
    dbu = (dtc * uc.float())[..., None] * bc[:, :, None, :]
    acc_a, acc_b = _affine_scan(da, dbu)
    del da, dbu
    h_t = acc_a * h[:, None] + acc_b                       # (B,C,di,ds)
    del acc_a, acc_b
    return torch.einsum("bcds,bcs->bcd", h_t, cc), h_t[:, -1].clone()


def ssm_chunked(dt, a, bmat, cmat, u, h0, *, chunk: int = 64):
    """Chunked diagonal SSM scan.  dt: (B,S,di) f32; a: (di,ds); bmat,
    cmat: (B,S,ds); u: (B,S,di); h0: (B,di,ds) f32.  Returns (y (B,S,di)
    f32, h_end (B,di,ds) f32).  Under autograd each chunk is checkpointed
    (its scan recomputed in the backward), so that a training step keeps
    one chunk's (B,C,di,ds) tensors, not every chunk's."""
    b, s, di = dt.shape
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"ssm_chunked: {s} steps do not split into chunks "
                         f"of {c}")
    h = h0.float()
    step = _ssm_chunk
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (dt, a, bmat, cmat, u, h0)):
        def step(*xs):
            return checkpoint(_ssm_chunk, *xs, use_reentrant=False,
                              preserve_rng_state=False)
    ys = []
    for i in range(0, s, c):
        y, h = step(dt[:, i:i + c], a, bmat[:, i:i + c], cmat[:, i:i + c],
                    u[:, i:i + c], h)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def _inner(p, x, conv_state):
    """(uc, z, new conv state) of p's channels: the input projections,
    the causal conv and its SiLU."""
    u = x @ p["wx"].to(x.dtype)
    z = x @ p["wz"].to(x.dtype)
    uc, new_conv = _conv_shift(u, p["conv_w"], p["conv_b"], conv_state)
    return F.silu(uc), z, new_conv


def _scan_out(p, x, uc, z, ssm, h0, chunk: int):
    """(y @ wo (B,S,d), h_end): the scan of p's channels from their SSM
    parameters ``ssm`` = (dt, a, B, C), the skip, the gate, and p's rows
    of ``wo`` (the whole output, or a model position's partial)."""
    y, h_end = ssm_chunked(*ssm, uc, h0, chunk=chunk)
    y = y.to(x.dtype) + p["D"].to(x.dtype) * uc
    y = y * F.silu(z)
    return y @ p["wo"].to(x.dtype), h_end


def mamba_train(p, x, conv_state, h0, *, cfg: ArchConfig, chunk: int = 64):
    """x: (B,S,d); conv_state: (B,K-1,di); h0: (B,di,ds) f32.  Returns
    (out (B,S,d), new conv state, h_end)."""
    uc, z, new_conv = _inner(p, x, conv_state)
    out, h_end = _scan_out(p, x, uc, z, _ssm_params(p, uc, cfg), h0, chunk)
    return out, new_conv, h_end


def wxp_sum(partials: list, devices: list) -> list:
    """xdbc = uc @ wxp from the model positions' partials (each one's
    channels through its rows of ``wxp``), added in position order, on
    every position's device."""
    return row_sum(partials, devices)


def mamba_group(blocks: list, x, *, cfg: ArchConfig, devices: list,
                chunk: int = 64):
    """A Mamba sublayer over one data position's model-axis group, from
    the zero states (training), on ``devices[0]``: ``blocks[j]`` is model
    position j's block of its leaves (the rules' ``tp(di)``: the columns
    of ``wx``, ``wz`` and ``wdt``, each channel's conv, ``dt_bias``,
    ``A_log`` and ``D``, the rows of ``wxp`` and ``wo``).  Each position
    computes its channels' u, z and conv; the ``wxp`` partials are added
    (``wxp_sum``) and the sum handed back to every position before the
    softplus, as the reference's ``_ssm_params`` reads the whole of it;
    each position scans its channels, and the partials through its rows
    of ``wo`` are added in position order.  Where the model axis does not
    split d_inner, the sublayer runs once, on position 0."""
    return mamba_group_states(blocks, x, cfg=cfg, devices=devices,
                              chunk=chunk)[0]


def mamba_group_states(blocks: list, x, *, cfg: ArchConfig, devices: list,
                       chunk: int = 64, states=None):
    """``mamba_group`` from given states, returning the new ones: (out,
    [((c0, c1), conv state (B,K-1,c1-c0), SSM state (B,c1-c0,ds) f32),
    ...]) for the channels each position scanned (all of them, on
    ``devices[0]``, where the model axis does not split d_inner).
    ``states(c0, c1, device)`` gives the (conv, SSM) states of channels
    [c0, c1) before the step on ``device``; None starts from zeros (a
    prefill, training)."""
    b, dev = x.shape[0], devices[0]
    s = cfg.ssm
    di = s.expand * cfg.d_model
    dil = blocks[0]["wx"].shape[1]

    def start(c0, c1, d):
        if states is not None:
            conv, h = states(c0, c1, d)
            return conv.to(x.dtype), h
        return (torch.zeros((b, s.d_conv - 1, c1 - c0), dtype=x.dtype,
                            device=d),
                torch.zeros((b, c1 - c0, s.d_state), dtype=torch.float32,
                            device=d))

    if dil == di:                                     # replicated
        out, conv, h = mamba_train(blocks[0], x, *start(0, di, dev), cfg=cfg,
                                   chunk=chunk)
        return out, [((0, di), conv, h)]
    xs = fan_out(x, devices)
    spans = [(j * dil, (j + 1) * dil) for j in range(len(blocks))]
    st = [start(c0, c1, xj.device) for (c0, c1), xj in zip(spans, xs)]
    inner = [_inner(bj, xj, conv0) for bj, xj, (conv0, _) in zip(blocks, xs,
                                                                  st)]
    xdbc = wxp_sum([uc @ bj["wxp"].to(uc.dtype)
                    for bj, (uc, _, _) in zip(blocks, inner)], devices)
    outs = [_scan_out(bj, xj, uc, z, _ssm_split(bj, xdbc[j], cfg), h0, chunk)
            for j, (bj, xj, (uc, z, _), (_, h0)) in enumerate(zip(
                blocks, xs, inner, st))]
    return (row_sum([o for o, _ in outs], devices)[0],
            [(sp, conv, h) for sp, (_, _, conv), (_, h) in zip(spans, inner,
                                                               outs)])


def mamba_decode(p, x, conv_state, h, *, cfg: ArchConfig):
    """One decode step, x: (B,1,d): ``mamba_train`` at chunk 1."""
    return mamba_train(p, x, conv_state, h, cfg=cfg, chunk=1)


class Mamba(ParamDict):
    """A mamba sublayer's parameters under the reference's leaf names."""

    def __init__(self, cfg: ArchConfig, params: dict):
        super().__init__(params)
        self.cfg = cfg

    def forward(self, x, conv_state, h0, *, chunk: int = 64):
        return mamba_train(self.p, x, conv_state, h0, cfg=self.cfg,
                           chunk=chunk)

    def decode(self, x, conv_state, h):
        return mamba_decode(self.p, x, conv_state, h, cfg=self.cfg)
