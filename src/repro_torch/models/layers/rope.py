"""Rotary position embeddings with block-local pairing, the JAX package's
``models/layers/rope.py``.

head_dim is viewed as (hd//8) blocks of 8; rotation partners are (i, i+4)
inside each block (not the HF half-split).  Angles and rotation are
computed in f32 and cast back to the input's dtype.  Standard RoPE and
Qwen2-VL M-RoPE (3 position streams split over pair sections; (16, 24,
24) for hd = 128).
"""
from __future__ import annotations

import torch

ROPE_BLOCK = 8
_HALF = ROPE_BLOCK // 2


def rope_frequencies(head_dim: int, theta: float, device=None):
    """Per-pair inverse frequencies, shape (head_dim//2,)."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def _apply_angles(x, angles):
    """x: (..., H, hd); angles: broadcastable to x's batch dims + (hd//2,)."""
    dt = x.dtype
    shape = x.shape
    nb = shape[-1] // ROPE_BLOCK
    x = x.float().reshape(shape[:-1] + (nb, ROPE_BLOCK))
    x1 = x[..., :_HALF]
    x2 = x[..., _HALF:]
    ang = angles.reshape(angles.shape[:-1] + (nb, _HALF))
    cos = torch.cos(ang)
    sin = torch.sin(ang)
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    return torch.cat([r1, r2], dim=-1).reshape(shape).to(dt)


def apply_rope(x, positions, *, theta: float):
    """Standard RoPE.  x: (B, S, H, hd); positions: (B, S) int32."""
    inv = rope_frequencies(x.shape[-1], theta, x.device)        # (hd/2,)
    ang = positions[..., None, None].float() * inv               # (B,S,1,hd/2)
    return _apply_angles(x, ang)


def mrope_sections(head_dim: int) -> tuple[int, int, int]:
    """Pair-section sizes (t, h, w): (16, 24, 24) for hd=128 (Qwen2-VL),
    generalized to 1/4, 3/8, 3/8 of the pair count."""
    pairs = head_dim // 2
    t = pairs // 4
    h = (pairs - t) // 2
    w = pairs - t - h
    return t, h, w


def apply_mrope(x, positions3, *, theta: float):
    """M-RoPE.  x: (B, S, H, hd); positions3: (3, B, S) int32 (t/h/w)."""
    hd = x.shape[-1]
    inv = rope_frequencies(hd, theta, x.device)                  # (hd/2,)
    sec_id = torch.tensor([i for i, n in enumerate(mrope_sections(hd))
                           for _ in range(n)], device=x.device)  # (hd/2,)
    pos = torch.movedim(positions3, 0, -1).float()               # (B, S, 3)
    pos_per_pair = pos[..., sec_id]                              # (B, S, hd/2)
    ang = pos_per_pair[..., None, :] * inv                       # (B,S,1,hd/2)
    return _apply_angles(x, ang)


def text_mrope_positions(positions):
    """Text-only M-RoPE: all three streams equal.  (B,S) -> (3,B,S)."""
    return positions[None].expand((3,) + tuple(positions.shape))
