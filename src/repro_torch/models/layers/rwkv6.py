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

Each mix is split where the model axis splits it: the leaves it
replicates run once (``time_mix_inputs``, ``channel_mix_inputs``,
``channel_mix_gate``), and the column- and row-split ones on a block of
heads or d_ff columns (``time_mix_heads``, ``channel_mix_kv``), whose
partial outputs the sharded train step adds up; the channel mix's sum
comes before its receptance gate, as the reference's ``kv`` is whole
before it is gated.
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
           "channel_mix_gate", "channel_mix_inputs", "channel_mix_kv",
           "init_channel_mix", "init_time_mix", "time_mix_decode",
           "time_mix_heads", "time_mix_inputs", "time_mix_train",
           "wkv_chunked", "wkv_step"]


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


def _decay_lora(p, xw):
    """The decay LoRA's first product, through ``wd1`` (replicated over
    the model axis)."""
    return torch.tanh(xw @ p["wd1"].to(xw.dtype))


def _decay_of(p, dw):
    """The log decay (≤ 0) of the columns of ``w0`` and ``wd2`` in ``p``,
    from ``_decay_lora``'s ``dw``."""
    return -torch.exp(p["w0"].float() + dw.float() @ p["wd2"].float())


def _decay_log(p, xw):
    return _decay_of(p, _decay_lora(p, xw))


def time_mix_inputs(p, x, shift_state):
    """The time mix's leaves that the model axis replicates (the token
    shift's ``mu_x``, ``mu``, ``mix_w1``, ``mix_w2`` and the decay LoRA's
    ``wd1``), applied once: (tanh(xw @ wd1), xk, xv, xr, xg)."""
    x_prev = torch.cat([shift_state[:, None, :], x[:, :-1]], dim=1)
    xw, xk, xv, xr, xg = _ddlerp(p, x, x_prev)
    return _decay_lora(p, xw), xk, xv, xr, xg


def time_mix_heads(p, inputs, wkv_state, *, cfg: ArchConfig,
                   chunk: int = 64):
    """The time mix of the heads whose columns ``p`` holds (``wr``,
    ``wk``, ``wv``, ``wg`` and ``wd2`` by columns, ``w0``, ``u`` and the
    group norm's by heads, ``wo`` by rows), on ``time_mix_inputs``'s
    ``inputs``: (out (B,S,d), the new wkv state of these heads).  ``out``
    is whole for the whole block and a partial for a model position's,
    which ``parallelism/tensor.py:row_sum`` adds up."""
    dw, xk, xv, xr, xg = inputs
    hs = cfg.rwkv.head_size
    b, s, _ = xk.shape
    dl = p["wr"].shape[1]
    if dl % hs:
        raise ValueError(f"a block of {dl} time-mix columns is not whole "
                         f"heads of {hs}")
    h = dl // hs
    assert s % min(chunk, s) == 0, (s, chunk)
    wlog = _decay_of(p, dw).reshape(b, s, h, hs)
    r = (xr @ p["wr"].to(xr.dtype)).reshape(b, s, h, hs)
    k = (xk @ p["wk"].to(xk.dtype)).reshape(b, s, h, hs)
    v = (xv @ p["wv"].to(xv.dtype)).reshape(b, s, h, hs)
    g = F.silu(xg @ p["wg"].to(xg.dtype))
    u = p["u"].float().reshape(h, hs)
    if s > 1:
        o, wkv_state = wkv6(r.float(), k.float(), v.float(), wlog, u,
                            wkv_state.float(), chunk=chunk)
    else:
        o, wkv_state = wkv_chunked(r, k, v, wlog, u, wkv_state, chunk=chunk)
    o = group_norm_heads(o.to(xk.dtype), p["gn_scale"].reshape(h, hs),
                         p["gn_bias"].reshape(h, hs))
    o = o.reshape(b, s, dl) * g
    return o @ p["wo"].to(xk.dtype), wkv_state


def time_mix_train(p, x, shift_state, wkv_state, *, cfg: ArchConfig,
                   chunk: int = 64):
    """x: (B,S,d). Returns (out, new_shift, new_wkv_state).  For s > 1 the
    recurrence goes through the wkv6 wrapper (the CUDA kernel on CUDA
    tensors, which it launches or raises); one token takes the plain
    chunked form."""
    out, wkv_state = time_mix_heads(p, time_mix_inputs(p, x, shift_state),
                                    wkv_state, cfg=cfg, chunk=chunk)
    return out, x[:, -1], wkv_state


def time_mix_decode(p, x, shift_state, wkv_state, *, cfg: ArchConfig):
    """x: (B,1,d)."""
    return time_mix_train(p, x, shift_state, wkv_state, cfg=cfg, chunk=1)


def channel_mix_inputs(p, x, shift_state):
    """The channel mix's token shift (``mu_k``, ``mu_r``, replicated over
    the model axis): (xk, xr)."""
    x_prev = torch.cat([shift_state[:, None, :], x[:, :-1]], dim=1)
    dx = x_prev - x
    return x + dx * p["mu_k"].to(x.dtype), x + dx * p["mu_r"].to(x.dtype)


def channel_mix_kv(p, xk):
    """relu(xk @ wk)² @ wv over the d_ff columns ``p`` holds: whole for
    the whole block, a partial for a model position's."""
    kk = torch.square(torch.relu(xk @ p["wk"].to(xk.dtype)))
    return kk @ p["wv"].to(xk.dtype)


def channel_mix_gate(p, xr, kv):
    """The receptance gate on the whole ``kv``: sigmoid(xr @ wr) * kv."""
    return torch.sigmoid(xr @ p["wr"].to(xr.dtype)) * kv


def channel_mix(p, x, shift_state, *, cfg: ArchConfig):
    """x: (B,S,d). Returns (out, new_shift)."""
    xk, xr = channel_mix_inputs(p, x, shift_state)
    return channel_mix_gate(p, xr, channel_mix_kv(p, xk)), x[:, -1]


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
