"""RWKV-6 wkv linear attention: the CUDA kernel's wrapper and its plain
version.

``wkv6`` replaces ``repro/kernels/wkv6/kernel.py:wkv6_pallas``: for
r, k, v, wlog (B, S, H, hs) and u (H, hs) it returns the output
(B, S, H, hs) f32 and the final state (B, H, hs, hs) f32 of the recurrence
from ``state``; zero ``state`` is the Pallas kernel's contract.  See
``csrc/wkv6.cu``.

On CUDA tensors the wrapper launches the kernel (built from
``csrc/wkv6.cu`` at first use: chunks of 32 tokens, the products in three
TF32 passes on the tensor cores) or raises; on CPU tensors it runs
``wkv6_plain``, the chunked parallel form of the reference's
``models/layers/rwkv6.py:wkv_chunked``.  ``wkv6.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import build_library, once

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv6.cu"
HEAD_SIZES = (16, 32, 64)


def wkv6_plain(r, k, v, wlog, u, state, *, chunk: int = 64):
    """Chunked parallel form: intra-chunk pairwise decays (all exponents
    ≤ 0) plus an inter-chunk state scan.  r,k,v,wlog: (B,S,H,hs) (wlog =
    log decay ≤ 0); u: (H,hs); state: (B,H,hs,hs).  Computed in f32;
    returns (o (B,S,H,hs), new_state (B,H,hs,hs))."""
    b, s, h, hs = r.shape
    c = min(chunk, s)
    assert s % c == 0, (s, c)
    nc = s // c
    rc, kc, vc, wc = (a.reshape(b, nc, c, h, hs).float()
                      for a in (r, k, v, wlog))
    uf = u.float()
    S = state.float()
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                      -1)[None, :, :, None, None]
    outs = []
    for n in range(nc):
        rr, kk, vv, ww = rc[:, n], kc[:, n], vc[:, n], wc[:, n]  # (B,C,H,hs)
        L = torch.cumsum(ww, dim=1)          # inclusive logs, ≤0, decreasing
        Lprev = L - ww
        Lend = L[:, -1:]                     # (B,1,H,hs)
        # inter-chunk: o_t += (r_t ⊙ exp(Lprev_t)) @ S
        o_inter = torch.einsum("bthi,bhij->bthj", rr * torch.exp(Lprev), S)
        # intra-chunk pairwise decays (t>s): exp(Lprev_t - L_s) ≤ 1
        dexp = torch.where(mask, torch.exp(Lprev[:, :, None] - L[:, None, :]),
                           0.0)              # (B,C,C,H,hs)
        scores = torch.einsum("bthi,bshi,btshi->bhts", rr, kk, dexp)
        o_intra = torch.einsum("bhts,bshj->bthj", scores, vv)
        # bonus diagonal
        du = torch.einsum("bthi,bthi->bth", rr, uf * kk)
        outs.append(o_inter + o_intra + du[..., None] * vv)
        # state update: S' = exp(Lend)⊙S + Σ_s exp(Lend - L_s)⊙k_s ⊗ v_s
        kdec = kk * torch.exp(Lend - L)
        S = torch.exp(Lend)[:, 0, :, :, None] * S + \
            torch.einsum("bshi,bshj->bhij", kdec, vv)
    return torch.stack(outs, 1).reshape(b, s, h, hs), S


def _check(name, x, shape, device):
    if x.device != device:
        raise ValueError(f"wkv6: {name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"wkv6: {name} has dtype {x.dtype}, expected "
                        "torch.float32")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"wkv6: {name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"wkv6: {name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"wkv6: {name} must start on a 16-byte boundary "
                         "(the kernel loads rows 16 bytes at a time)")


@once
def _launcher():
    lib, info = build_library(SOURCE, "wkv6")
    fn = lib.wkv6_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.wkv6_smem_bytes.argtypes = [ctypes.c_int]
    lib.wkv6_smem_bytes.restype = ctypes.c_int
    info = dict(info, smem_bytes={hs: lib.wkv6_smem_bytes(hs)
                                  for hs in HEAD_SIZES})
    return fn, info


def build() -> dict:
    """Build (or reuse) and load the kernel; returns the build record of
    ``repro_torch.kernels.build.build_library``, with the dynamic shared
    memory of one block per head size under ``smem_bytes``."""
    return _launcher()[1]


def wkv6(r, k, v, wlog, u, state, *, chunk: int = 64):
    """The wkv recurrence from ``state``: the CUDA kernel on CUDA tensors,
    ``wkv6_plain`` on CPU tensors.  Same arguments and results as
    ``wkv6_plain``; ``chunk`` is the plain version's chunk length, and the
    kernel, whose chunk is fixed in its source, does not read it.  On CUDA
    every input is f32, contiguous and 16-byte aligned, hs is 16, 32 or
    64, and S may be any length."""
    device = r.device
    if device.type == "cpu":
        return wkv6_plain(r, k, v, wlog, u, state, chunk=chunk)
    if device.type != "cuda":
        raise ValueError(f"wkv6: no kernel for device {device}")
    if r.dim() != 4:
        raise ValueError(f"wkv6: r has shape {tuple(r.shape)}, expected "
                         "(B, S, H, hs)")
    b, s, h, hs = r.shape
    if hs not in HEAD_SIZES:
        raise ValueError(f"wkv6: head size {hs} has no kernel; the kernel "
                         f"takes hs in {HEAD_SIZES}")
    for name, x, shape in (("r", r, (b, s, h, hs)), ("k", k, (b, s, h, hs)),
                           ("v", v, (b, s, h, hs)),
                           ("wlog", wlog, (b, s, h, hs)), ("u", u, (h, hs)),
                           ("state", state, (b, h, hs, hs))):
        _check(name, x, shape, device)
    o = torch.empty((b, s, h, hs), dtype=torch.float32, device=device)
    s_out = torch.empty((b, h, hs, hs), dtype=torch.float32, device=device)
    if b * h == 0:
        return o, s_out
    fn, _ = _launcher()
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), wlog.data_ptr(),
             u.data_ptr(), state.data_ptr(), o.data_ptr(), s_out.data_ptr(),
             b, s, h, hs, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"wkv6: kernel launch failed with CUDA error "
                           f"{err}")
    wkv6.launches += 1
    return o, s_out


wkv6.launches = 0
