"""Dense feed-forward blocks: SwiGLU / GELU / squared-ReLU (nemotron), the
JAX package's ``models/layers/ffn.py``.  GELU is JAX's default, the tanh
approximation."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def init_ffn(draw, d_model: int, d_ff: int, act: str, dtype=torch.float32
             ) -> dict:
    """draw(shape, std) returns f32 normal draws times std; the scales are
    the JAX package's."""
    si, so = d_model ** -0.5, d_ff ** -0.5
    if act == "swiglu":
        return {"wi_gate": draw((d_model, d_ff), si).to(dtype),
                "wi_up": draw((d_model, d_ff), si).to(dtype),
                "wo": draw((d_ff, d_model), so).to(dtype)}
    return {"wi": draw((d_model, d_ff), si).to(dtype),
            "wo": draw((d_ff, d_model), so).to(dtype)}


def apply_ffn(p: dict, x, *, act: str):
    if act == "swiglu":
        h = F.silu(x @ p["wi_gate"].to(x.dtype)) * (x @ p["wi_up"].to(x.dtype))
    else:
        h = x @ p["wi"].to(x.dtype)
        if act == "gelu":
            h = F.gelu(h, approximate="tanh")
        elif act == "relu2":
            h = torch.square(F.relu(h))
        else:
            raise ValueError(act)
    return h @ p["wo"].to(x.dtype)
