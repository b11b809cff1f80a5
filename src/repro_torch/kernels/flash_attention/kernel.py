"""Flash attention: the CUDA kernel's wrapper.

``flash_attention`` replaces ``repro/kernels/flash_attention/kernel.py:
flash_attention`` (the Pallas kernel): forward attention with an online
softmax, here on the port's layout, q (B, Sq, H, hd) and k, v (B, Sk, KV,
hd) with H % KV == 0, read without repeating the KV heads.  Its function
is ``ref.attention_plain``; see ``csrc/flash_attention.cu``.

On CUDA tensors the wrapper launches the kernel (built from
``csrc/flash_attention.cu`` at first use) or raises; on CPU tensors it
runs ``attention_plain``.  Sq > Sk raises ValueError on both (ROADMAP §3,
F4).  ``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import build_library, once
from repro_torch.kernels.flash_attention.ref import (attention_plain,
                                                     check_shapes)

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535        # CUDA's limit on the grid's y (B) and z axes
_BQ = 64                    # query rows per block: the grid's z is Sq / 64


def _check(name, x, dtype, device):
    if x.device != device:
        raise ValueError(f"flash_attention: {name} is on {x.device}, "
                         f"expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"flash_attention: {name} has dtype {x.dtype}, "
                        f"expected {dtype}")
    if not x.is_contiguous():
        raise ValueError(f"flash_attention: {name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} must be 16-byte aligned "
                         "(the kernel copies rows in 16-byte pieces)")


@once
def _launcher():
    lib, info = build_library(SOURCE, "flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, info


def build() -> dict:
    """Build (or reuse) and load the kernel; returns the build record of
    ``repro_torch.kernels.build.build_library``."""
    return _launcher()[1]


def flash_attention(q, k, v, *, causal: bool = True):
    """Attention of q (B,Sq,H,hd) over k, v (B,Sk,KV,hd), Sq <= Sk: the
    CUDA kernel on CUDA tensors, ``attention_plain`` on CPU tensors.
    Returns (B,Sq,H,hd) in q's dtype.  On CUDA q, k and v are contiguous,
    all f32 or all bf16, and hd is 16, 32, 64 or 128."""
    device = q.device
    if device.type == "cpu":
        return attention_plain(q, k, v, causal=causal)
    if device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {device}")
    check_shapes(q, k, v)
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head size {hd} has no kernel; "
                         f"the kernel takes hd in {HEAD_DIMS}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: q has dtype {q.dtype}; the kernel "
                        "takes torch.float32 or torch.bfloat16")
    if max(b, -(-sq // _BQ)) > _MAX_GRID_YZ:
        raise ValueError(f"flash_attention: batch {b} or {sq} queries above "
                         f"the grid's limit of {_MAX_GRID_YZ} (x {_BQ})")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check(name, x, q.dtype, device)
    o = torch.empty_like(q)
    if b * h * sq == 0:
        return o
    fn, _ = _launcher()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq,
             sk, h, kv, hd, int(causal), _DTYPES[q.dtype], hd ** -0.5,
             torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
