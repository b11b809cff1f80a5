"""RWKV-6 ("Finch") — data-dependent-decay linear attention.

The wkv recurrence  S_t = diag(w_t)·S_{t-1} + k_t ⊗ v_t,
                    o_t = r_t·(S_{t-1} + diag(u)·k_t ⊗ v_t)
is the JAX package's ``models/layers/rwkv6.py``, ported as plain tensor
functions over parameter dicts with the JAX names, and ``TimeMix`` /
``ChannelMix`` modules over them.

``time_mix_train`` sends the recurrence of a sequence (s > 1) through the
wkv6 wrapper: the CUDA kernel on the card, its plain chunked version on
the CPU.  The one-token decode step runs the plain ``wkv_chunked`` with
chunk 1, as the reference does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.wkv6.kernel import wkv6
from repro_torch.kernels.wkv6.kernel import wkv6_plain as wkv_chunked
from repro_torch.kernels.wkv6.ref import wkv_step
from repro_torch.models.layers.common import ParamDict, group_norm_heads

N_MIX = 5  # w, k, v, r, g

__all__ = ["N_MIX", "ChannelMix", "TimeMix", "channel_mix",
           "init_channel_mix", "init_time_mix", "time_mix_decode",
           "time_mix_train", "wkv_chunked", "wkv_step"]


# ---------------------------------------------------------------------------
# init.  draw(shape, std) returns f32 normal draws times std; the scales
# are the JAX package's.
# ---------------------------------------------------------------------------

def init_time_mix(draw, cfg: ArchConfig, dtype=torch.float32,
                  device=None) -> dict:
    r = cfg.rwkv
    d = cfg.d_model
    s = d ** -0.5
    mr, dr = r.mix_lora_rank, r.decay_lora_rank

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        "mu_x": full((d,), 0.5),
        "mu": full((N_MIX, d), 0.5),
        "mix_w1": draw((d, N_MIX * mr), s).to(dtype),
        "mix_w2": draw((N_MIX, mr, d), mr ** -0.5).to(dtype),
        "w0": torch.linspace(-6.0, -0.5, d, device=device).to(dtype),
        "wd1": draw((d, dr), s).to(dtype),
        "wd2": draw((dr, d), dr ** -0.5).to(dtype),
        "u": draw((d,), 0.1).to(dtype),
        "wr": draw((d, d), s).to(dtype),
        "wk": draw((d, d), s).to(dtype),
        "wv": draw((d, d), s).to(dtype),
        "wg": draw((d, d), s).to(dtype),
        "wo": draw((d, d), s).to(dtype),
        "gn_scale": full((d,), 1.0),
        "gn_bias": full((d,), 0.0),
    }


def init_channel_mix(draw, cfg: ArchConfig, dtype=torch.float32,
                     device=None) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": torch.full((d,), 0.5, dtype=dtype, device=device),
        "mu_r": torch.full((d,), 0.5, dtype=dtype, device=device),
        "wk": draw((d, f), d ** -0.5).to(dtype),
        "wv": draw((f, d), f ** -0.5).to(dtype),
        "wr": draw((d, d), d ** -0.5).to(dtype),
    }


# ---------------------------------------------------------------------------
# layer entry points
# ---------------------------------------------------------------------------

def _ddlerp(p, x, x_prev):
    """Data-dependent token-shift mixes.  Returns (xw,xk,xv,xr,xg)."""
    dx = x_prev - x
    xxx = x + dx * p["mu_x"].to(x.dtype)
    mr = p["mix_w2"].shape[1]
    lora = torch.tanh(xxx @ p["mix_w1"].to(x.dtype))
    lora = lora.reshape(lora.shape[:-1] + (N_MIX, mr))
    mix = p["mu"].to(x.dtype) + torch.einsum(
        "bsnr,nrd->bsnd", lora, p["mix_w2"].to(x.dtype))
    return tuple(x + dx * mix[..., i, :] for i in range(N_MIX))


def _decay_log(p, xw):
    w_raw = p["w0"].float() + \
        torch.tanh(xw @ p["wd1"].to(xw.dtype)).float() @ p["wd2"].float()
    return -torch.exp(w_raw)          # log decay ≤ 0


def time_mix_train(p, x, shift_state, wkv_state, *, cfg: ArchConfig,
                   chunk: int = 64):
    """x: (B,S,d). Returns (out, new_shift, new_wkv_state).  For s > 1 the
    recurrence goes through the wkv6 wrapper (the CUDA kernel on CUDA
    tensors, which it launches or raises); one token takes the plain
    chunked form."""
    hs = cfg.rwkv.head_size
    b, s, d = x.shape
    h = d // hs
    assert s % min(chunk, s) == 0, (s, chunk)
    x_prev = torch.cat([shift_state[:, None, :], x[:, :-1]], dim=1)
    xw, xk, xv, xr, xg = _ddlerp(p, x, x_prev)
    wlog = _decay_log(p, xw).reshape(b, s, h, hs)
    r = (xr @ p["wr"].to(x.dtype)).reshape(b, s, h, hs)
    k = (xk @ p["wk"].to(x.dtype)).reshape(b, s, h, hs)
    v = (xv @ p["wv"].to(x.dtype)).reshape(b, s, h, hs)
    g = F.silu(xg @ p["wg"].to(x.dtype))
    u = p["u"].float().reshape(h, hs)
    if s > 1:
        o, wkv_state = wkv6(r.float(), k.float(), v.float(), wlog, u,
                            wkv_state.float(), chunk=chunk)
    else:
        o, wkv_state = wkv_chunked(r, k, v, wlog, u, wkv_state, chunk=chunk)
    o = group_norm_heads(o.to(x.dtype), p["gn_scale"].reshape(h, hs),
                         p["gn_bias"].reshape(h, hs))
    o = o.reshape(b, s, d) * g
    return o @ p["wo"].to(x.dtype), x[:, -1], wkv_state


def time_mix_decode(p, x, shift_state, wkv_state, *, cfg: ArchConfig):
    """x: (B,1,d)."""
    return time_mix_train(p, x, shift_state, wkv_state, cfg=cfg, chunk=1)


def channel_mix(p, x, shift_state, *, cfg: ArchConfig):
    """x: (B,S,d). Returns (out, new_shift)."""
    x_prev = torch.cat([shift_state[:, None, :], x[:, :-1]], dim=1)
    dx = x_prev - x
    xk = x + dx * p["mu_k"].to(x.dtype)
    xr = x + dx * p["mu_r"].to(x.dtype)
    kk = torch.square(torch.relu(xk @ p["wk"].to(x.dtype)))
    kv = kk @ p["wv"].to(x.dtype)
    out = torch.sigmoid(xr @ p["wr"].to(x.dtype)) * kv
    return out, x[:, -1]


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class TimeMix(ParamDict):
    def __init__(self, cfg: ArchConfig, params: dict):
        super().__init__(params)
        self.cfg = cfg

    def forward(self, x, shift_state, wkv_state, *, chunk: int = 64):
        return time_mix_train(self.p, x, shift_state, wkv_state,
                              cfg=self.cfg, chunk=chunk)

    def decode(self, x, shift_state, wkv_state):
        return time_mix_decode(self.p, x, shift_state, wkv_state,
                               cfg=self.cfg)


class ChannelMix(ParamDict):
    def __init__(self, cfg: ArchConfig, params: dict):
        super().__init__(params)
        self.cfg = cfg

    def forward(self, x, shift_state):
        return channel_mix(self.p, x, shift_state, cfg=self.cfg)
