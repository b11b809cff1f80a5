"""The literal per-token wkv recurrence, the ground truth that the wkv6
kernel and its chunked plain version are held to (the reference's
``repro/kernels/wkv6/ref.py:wkv_ref_stepwise``), and its one-token step,
the reference's ``models/layers/rwkv6.py:wkv_step``.

Both compute in f32 as the reference does, or in f64 when the state is
f64, so that the card can hold the f32 forms against an f64 truth."""
from __future__ import annotations

import torch


def wkv_step(r, k, v, wlog, u, state):
    """Single decode step. r,k,v,wlog: (B,H,hs); state: (B,H,hs,hs) fp32."""
    dt = torch.promote_types(state.dtype, torch.float32)
    rf, kf, vf, uf, state = (a.to(dt) for a in (r, k, v, u, state))
    kv = kf[..., :, None] * vf[..., None, :]          # (B,H,hs,hs)
    o = torch.einsum("bhi,bhij->bhj", rf, state + uf[..., None] * kv)
    state = torch.exp(wlog.to(dt))[..., None] * state + kv
    return o, state


def wkv_ref_stepwise(r, k, v, wlog, u, state):
    """r,k,v,wlog: (B,S,H,hs); u: (H,hs); state: (B,H,hs,hs).  Returns
    (o (B,S,H,hs), final state (B,H,hs,hs))."""
    S = state
    outs = []
    for t in range(r.shape[1]):
        o, S = wkv_step(r[:, t], k[:, t], v[:, t], wlog[:, t], u, S)
        outs.append(o)
    return torch.stack(outs, 1), S
