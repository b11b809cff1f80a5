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

Decode is the training form at chunk 1.  A (B, C, di, ds) f32 tensor is
268 MB at jamba's full width (B 8, C 64, di 8192, ds 16): a chunk keeps
a few of them alive.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers.common import ParamDict


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
    s = cfg.ssm
    xdbc = uc @ p["wxp"].to(uc.dtype)
    dt_in = xdbc[..., :s.dt_rank]
    bmat = xdbc[..., s.dt_rank:s.dt_rank + s.d_state].float()
    cmat = xdbc[..., s.dt_rank + s.d_state:].float()
    dt = F.softplus((dt_in @ p["wdt"].to(uc.dtype)).float()
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


def ssm_chunked(dt, a, bmat, cmat, u, h0, *, chunk: int = 64):
    """Chunked diagonal SSM scan.  dt: (B,S,di) f32; a: (di,ds); bmat,
    cmat: (B,S,ds); u: (B,S,di); h0: (B,di,ds) f32.  Returns (y (B,S,di)
    f32, h_end (B,di,ds) f32)."""
    b, s, di = dt.shape
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"ssm_chunked: {s} steps do not split into chunks "
                         f"of {c}")
    h = h0.float()
    ys = []
    for i in range(0, s, c):
        dtc = dt[:, i:i + c]
        da = torch.exp(dtc[..., None] * a)                 # (B,C,di,ds) <= 1
        dbu = (dtc * u[:, i:i + c].float())[..., None] * \
            bmat[:, i:i + c, None, :]
        acc_a, acc_b = _affine_scan(da, dbu)
        del da, dbu
        h_t = acc_a * h[:, None] + acc_b                   # (B,C,di,ds)
        del acc_a, acc_b
        ys.append(torch.einsum("bcds,bcs->bcd", h_t, cmat[:, i:i + c]))
        h = h_t[:, -1]
        del h_t
    return torch.cat(ys, dim=1), h


def mamba_train(p, x, conv_state, h0, *, cfg: ArchConfig, chunk: int = 64):
    """x: (B,S,d); conv_state: (B,K-1,di); h0: (B,di,ds) f32.  Returns
    (out (B,S,d), new conv state, h_end)."""
    u = x @ p["wx"].to(x.dtype)
    z = x @ p["wz"].to(x.dtype)
    uc, new_conv = _conv_shift(u, p["conv_w"], p["conv_b"], conv_state)
    uc = F.silu(uc)
    dt, a, bmat, cmat = _ssm_params(p, uc, cfg)
    y, h_end = ssm_chunked(dt, a, bmat, cmat, uc, h0, chunk=chunk)
    y = y.to(x.dtype) + p["D"].to(x.dtype) * uc
    y = y * F.silu(z)
    return y @ p["wo"].to(x.dtype), new_conv, h_end


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
