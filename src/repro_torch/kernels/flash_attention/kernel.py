"""Flash attention: the CUDA kernels' wrappers, and the autograd function
over them.

``flash_attention`` replaces ``repro/kernels/flash_attention/kernel.py:
flash_attention`` (the Pallas kernel): forward attention with an online
softmax, here on the port's layout, q (B, Sq, H, hd) and k, v (B, Sk, KV,
hd) with H % KV == 0, read without repeating the KV heads.  Its function
is ``ref.attention_plain``; see ``csrc/flash_attention.cu``.

On CUDA tensors the wrapper launches the kernel (built from
``csrc/flash_attention.cu`` at first use) or raises; on CPU tensors it
runs ``attention_plain``, and autograd runs through it.  Where a gradient
is asked for on CUDA, ``flash_attention`` goes through
``FlashAttentionFunction``: its forward is the same kernel, which also
writes the rows' log-sum-exp, and its backward the port's own kernels
(``csrc/flash_attention_bwd.cu``, wrapped by ``flash_attention_bwd``;
plain version ``ref.attention_backward_plain``), f32 or bf16 like the
forward: the TPU package has no backward kernel and trains through plain
attention.
Causal Sq > Sk raises ValueError on both devices (ROADMAP §3, F4);
non-causal Sq > Sk is taken (the kernels' full path reads no Sk - Sq
offset).
``flash_attention.launches`` counts forward kernel launches,
``flash_attention_bwd.launches`` backward calls (two launches each:
``flash_bwd_dq``, which also writes D = rowsum(do . o), then
``flash_bwd_dkdv``).

Each launch reports its work to the running cost passes
(``repro_torch.kernels.costs``) by ``flash_cost`` / ``flash_bwd_cost``.
A dry run's fake tensors take the kernels' path wherever they lie: they
are checked as the card's are, their outputs allocated and their work
reported (bf16 bytes for bf16 tensors), and nothing is built or
launched.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import costs
from repro_torch.kernels.build import build_library, once
from repro_torch.kernels.flash_attention.ref import (
    attention_backward_plain, attention_plain, check_shapes)

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BWD_SOURCE = (Path(__file__).resolve().parent / "csrc"
              / "flash_attention_bwd.cu")
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535        # CUDA's limit on the grid's y (B) and z axes
_BQ = 64                    # query rows per block: the grid's z is Sq / 64


def causal_pairs(sq: int, sk: int, causal: bool) -> int:
    """The (query, key) pairs one head of one row attends: every pair, or
    under the right-aligned causal mask query i's keys j <= i + sk - sq
    (sq <= sk)."""
    if not causal:
        return sq * sk
    return sq * (sk - sq) + sq * (sq + 1) // 2


def flash_cost(b, sq, sk, h, kv, hd, causal, itemsize: int = 4,
               with_lse: bool = False) -> tuple:
    """(flops, bytes) of one forward launch: q·k and p·v over the pairs
    it attends, 4·hd a pair (only the causal pairs: the masked part of a
    diagonal tile is not counted); q, k and v read once, o written once
    (and the rows' log-sum-exp, f32)."""
    flops = 4 * hd * b * h * causal_pairs(sq, sk, causal)
    nbytes = itemsize * hd * (2 * b * sq * h + 2 * b * sk * kv)
    return flops, nbytes + (4 * b * h * sq if with_lse else 0)


def flash_bwd_cost(b, sq, sk, h, kv, hd, causal, itemsize: int = 4) -> tuple:
    """(flops, bytes) of one backward call: q·k recomputed, do·v, p·do,
    ds·k and ds·q over the pairs it attends, 10·hd a pair; q, k, v, o and
    do read once and dq, dk and dv written once at ``itemsize`` bytes an
    element, and the log-sum-exp (f32) read once (its D rows are
    scratch)."""
    flops = 10 * hd * b * h * causal_pairs(sq, sk, causal)
    nbytes = (itemsize * hd * (4 * b * sq * h + 4 * b * sk * kv)
              + 4 * b * h * sq)
    return flops, nbytes


def _check(name, x, dtype, device):
    if x.device != device:
        raise ValueError(f"flash_attention: {name} is on {x.device}, "
                         f"expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"flash_attention: {name} has dtype {x.dtype}, "
                        f"expected {dtype}")
    if not x.is_contiguous():
        raise ValueError(f"flash_attention: {name} must be contiguous")
    if costs.misaligned(x):
        raise ValueError(f"flash_attention: {name} must be 16-byte aligned "
                         "(the kernel copies rows in 16-byte pieces)")


def _check_inputs(q, k, v, causal: bool):
    """(b, sq, sk, h, kv, hd) of CUDA inputs the kernels take (or a dry
    run's fake ones); raises otherwise."""
    device = q.device
    if device.type != "cuda" and not costs.is_fake(q):
        raise ValueError(f"flash_attention: no kernel for device {device}")
    check_shapes(q, k, v, causal)
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
    return b, sq, sk, h, kv, hd


@once
def _launcher():
    lib, info = build_library(SOURCE, "flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, info


@once
def _bwd_launcher():
    lib, info = build_library(BWD_SOURCE, "flash_attention_bwd")
    fn = lib.flash_attention_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, info


def build() -> dict:
    """Build (or reuse) and load the forward kernel; returns the build
    record of ``repro_torch.kernels.build.build_library``."""
    return _launcher()[1]


def build_bwd() -> dict:
    """Build (or reuse) and load the backward kernels; their build
    record."""
    return _bwd_launcher()[1]


def _flash_kernel(q, k, v, causal: bool, with_lse: bool):
    """One launch of the forward kernel: (o, lse (B, H, Sq) f32 or None)."""
    b, sq, sk, h, kv, hd = _check_inputs(q, k, v, causal)
    device = q.device
    o = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=device)
           if with_lse else None)
    if b * h * sq == 0:
        return o, lse
    if not costs.is_fake(q):
        fn, _ = _launcher()
        # the launcher sets its shared-memory attribute and launches on the
        # current device: make it the tensors' one
        with torch.cuda.device(device):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     None if lse is None else lse.data_ptr(), b, sq, sk, h,
                     kv, hd, int(causal), _DTYPES[q.dtype], hd ** -0.5,
                     torch.cuda.current_stream(device).cuda_stream)
        if err:
            raise RuntimeError(f"flash_attention: kernel launch failed with "
                               f"CUDA error {err}")
        flash_attention.launches += 1
    if costs.PASSES:
        costs.report("flash_attention", device, *flash_cost(
            b, sq, sk, h, kv, hd, causal, q.element_size(), with_lse))
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True):
    """The gradient of ``flash_attention`` on CUDA tensors, by the backward
    kernels, from the forward's output and row log-sum-exp: (dq (B,Sq,H,hd),
    dk, dv (B,Sk,KV,hd)), dk and dv summed over each KV head's query
    heads.  q, k, v, o and do are all f32 or all bf16, lse (B,H,Sq) is
    f32, and the gradients come back in the inputs' dtype; any other
    dtype raises TypeError.  ``do`` is made contiguous here, since
    autograd hands it over in any layout."""
    b, sq, sk, h, kv, hd = _check_inputs(q, k, v, causal)
    device = q.device
    do = do.contiguous()
    for name, x in (("o", o), ("do", do)):
        _check(name, x, q.dtype, device)
        if x.shape != q.shape:
            raise ValueError(f"flash_attention_bwd: {name} has shape "
                             f"{tuple(x.shape)}, expected {tuple(q.shape)}")
    _check("lse", lse, torch.float32, device)
    if tuple(lse.shape) != (b, h, sq):
        raise ValueError(f"flash_attention_bwd: lse has shape "
                         f"{tuple(lse.shape)}, expected {(b, h, sq)}")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if b * h * sq == 0:
        return dq, dk.zero_(), dv.zero_()
    d_rows = torch.empty((b, h, sq), dtype=torch.float32, device=device)
    if not costs.is_fake(q):
        fn, _ = _bwd_launcher()
        with torch.cuda.device(device):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     do.data_ptr(), lse.data_ptr(), d_rows.data_ptr(),
                     dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, sk,
                     h, kv, hd, int(causal), _DTYPES[q.dtype], hd ** -0.5,
                     torch.cuda.current_stream(device).cuda_stream)
        if err:
            raise RuntimeError(f"flash_attention_bwd: kernel launch failed "
                               f"with CUDA error {err}")
        flash_attention_bwd.launches += 1
    if costs.PASSES:
        costs.report("flash_attention_bwd", device, *flash_bwd_cost(
            b, sq, sk, h, kv, hd, causal, q.element_size()))
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """``flash_attention`` with a gradient, on CUDA tensors: forward by the
    forward kernel (with the rows' log-sum-exp), backward by the backward
    kernels.  ``flash_attention`` sends CPU tensors to plain autograd
    through ``attention_plain`` and never here."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = _flash_kernel(q, k, v, causal, with_lse=True)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                         causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool = True):
    """Attention of q (B,Sq,H,hd) over k, v (B,Sk,KV,hd), Sq <= Sk where
    causal: the CUDA kernel on CUDA tensors, ``attention_plain`` on CPU
    tensors.
    Returns (B,Sq,H,hd) in q's dtype.  On CUDA q, k and v are contiguous,
    all f32 or all bf16, and hd is 16, 32, 64 or 128; where grad mode is on
    and an input requires grad the call goes through
    ``FlashAttentionFunction``, whose backward is a kernel too, in the
    same dtype."""
    device = q.device
    if device.type == "cpu" and not costs.is_fake(q):
        return attention_plain(q, k, v, causal=causal)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, causal)
    return _flash_kernel(q, k, v, causal, with_lse=False)[0]


flash_attention.launches = 0
flash_attention_bwd.launches = 0
