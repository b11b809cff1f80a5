"""RWKV-6 wkv linear attention: the CUDA kernels' wrappers, their plain
versions, and the autograd function over them.

``wkv6`` replaces ``repro/kernels/wkv6/kernel.py:wkv6_pallas``: for
r, k, v, wlog (B, S, H, hs) and u (H, hs) it returns the output
(B, S, H, hs) f32 and the final state (B, H, hs, hs) f32 of the recurrence
from ``state``; zero ``state`` is the Pallas kernel's contract.  See
``csrc/wkv6.cu``.

On CUDA tensors the wrapper launches the kernel (built from
``csrc/wkv6.cu`` at first use: chunks of 32 tokens, the products in three
TF32 passes on the tensor cores) or raises; on CPU tensors it runs
``wkv6_plain``, the chunked parallel form of the reference's
``models/layers/rwkv6.py:wkv_chunked``, and autograd runs through it.
Where a gradient is asked for on CUDA, ``wkv6`` goes through
``WKV6Function``, whose backward is the port's own kernel
(``csrc/wkv6_bwd.cu``, wrapped by ``wkv6_bwd``; its plain version is
``wkv6_backward_plain``, the stepwise recurrence, and
``wkv6_backward_chunked_plain`` repeats the kernel's chunked formulas):
the TPU package has no backward kernel and trains through
``wkv_chunked``.  ``wkv6.launches`` counts forward kernel
launches, ``wkv6_bwd.launches`` backward calls (one launch each).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import build_library, once

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv6.cu"
BWD_SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv6_bwd.cu"
HEAD_SIZES = (16, 32, 64)


def wkv6_plain(r, k, v, wlog, u, state, *, chunk: int = 64):
    """Chunked parallel form: intra-chunk pairwise decays (all exponents
    ≤ 0) plus an inter-chunk state scan.  r,k,v,wlog: (B,S,H,hs) (wlog =
    log decay ≤ 0); u: (H,hs); state: (B,H,hs,hs).  Computed in f32 (in
    f64 for f64 r, so that the card can hold the kernels against an f64
    truth); returns (o (B,S,H,hs), new_state (B,H,hs,hs))."""
    b, s, h, hs = r.shape
    c = min(chunk, s)
    assert s % c == 0, (s, c)
    nc = s // c
    dt = torch.promote_types(r.dtype, torch.float32)
    rc, kc, vc, wc = (a.reshape(b, nc, c, h, hs).to(dt)
                      for a in (r, k, v, wlog))
    uf = u.to(dt)
    S = state.to(dt)
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
        # intra-chunk pairwise decays (t>s): exp(Lprev_t - L_s) ≤ 1.  The
        # mask goes inside the exponent: the reference masks exp's output,
        # whose gradient is 0 x inf = NaN where a masked exponent overflows
        # (ROADMAP §3, F7); the values are the same
        dexp = torch.exp(torch.where(mask, Lprev[:, :, None] - L[:, None, :],
                                     -torch.inf))    # (B,C,C,H,hs)
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


def wkv6_backward_plain(r, k, v, wlog, u, state, do, dstate=None):
    """The gradient of the wkv recurrence, plain: the kernel's step-by-step
    reverse recurrence (``csrc/wkv6_bwd.cu`` states it) in f32, or in f64
    when ``state`` is f64.  r, k, v, wlog, do: (B,S,H,hs); u: (H,hs);
    state and dstate (the final state's adjoint, or None for zero):
    (B,H,hs,hs).  Returns (dr, dk, dv, dwlog (B,S,H,hs), du (H,hs))."""
    dt = torch.promote_types(state.dtype, torch.float32)
    r, k, v, wlog, u, S, do = (a.to(dt) for a in (r, k, v, wlog, u, state,
                                                   do))
    w = torch.exp(wlog)
    prev = []                                  # S_{t-1} for every t
    for t in range(r.shape[1]):
        prev.append(S)
        S = w[:, t, :, :, None] * S + k[:, t, :, :, None] * v[:, t, :, None]
    G = torch.zeros_like(S) if dstate is None else dstate.to(dt)
    grads = {n: [None] * r.shape[1] for n in ("r", "k", "v", "w")}
    du = torch.zeros_like(u)
    for t in reversed(range(r.shape[1])):
        rt, kt, vt, wt, dot = r[:, t], k[:, t], v[:, t], w[:, t], do[:, t]
        dov = (dot * vt).sum(-1, keepdim=True)             # (B,H,1)
        rku = (rt * u * kt).sum(-1, keepdim=True)
        grads["r"][t] = torch.einsum("bhij,bhj->bhi", prev[t], dot) \
            + u * kt * dov
        grads["k"][t] = torch.einsum("bhij,bhj->bhi", G, vt) + rt * u * dov
        grads["v"][t] = torch.einsum("bhij,bhi->bhj", G, kt) + rku * dot
        grads["w"][t] = wt * (G * prev[t]).sum(-1)
        du = du + (rt * kt * dov).sum(0)
        G = wt[..., None] * G + rt[..., None] * dot[:, :, None]
    return tuple(torch.stack(grads[n], 1) for n in ("r", "k", "v", "w")) \
        + (du,)


_SUB = 16                   # tokens per sub-chunk of the backward kernel


def _decays(W):
    """The chunk's decay products, as ``csrc/wkv6_bwd.cu`` forms them from
    W = exp(w) (B,H,C,hs), C = 2 x 16: each an exclusive running product
    inside a sub-chunk, so that no exponent is a difference of two long
    sums.  Returns (cf = exp(Lp_t), cb = exp(L_end - L_t), rf, cend =
    exp(L_end)), rf being exp(L_ref - L_s) on the first sub-chunk and
    exp(Lp_t - L_ref) on the second, L_ref = L_15."""
    W0, W1 = W[:, :, :_SUB], W[:, :, _SUB:]

    def excl(x):                       # prod_{q < t}, left to right
        return torch.cumprod(torch.cat([torch.ones_like(x[:, :, :1]),
                                        x[:, :, :-1]], 2), 2)
    f0, f1 = excl(W0), excl(W1)
    b0, b1 = (excl(x.flip(2)).flip(2) for x in (W0, W1))
    p0, p1 = f0[:, :, -1] * W0[:, :, -1], f1[:, :, -1] * W1[:, :, -1]
    cf = torch.cat([f0, p0[:, :, None] * f1], 2)
    cb = torch.cat([b0 * p1[:, :, None], b1], 2)
    return cf, cb, torch.cat([b0, f1], 2), p0 * p1


def wkv6_backward_chunked_plain(r, k, v, wlog, u, state, do, dstate=None):
    """The gradient of the wkv recurrence in the backward kernel's chunked
    form (``csrc/wkv6_bwd.cu`` derives it): chunks of 32 tokens in two
    sub-chunks of 16, the inter-chunk products against the chunk-start
    state S_c and the end-of-chunk adjoint G, the intra-chunk ones
    through D = do v^T and the forward's scores A, the off-diagonal
    16 x 16 block through the reference point L_15, the diagonal blocks
    with exact decay products, and dw as the kernel sums it (no
    difference of cumulative sums).  Same arguments and results as
    ``wkv6_backward_plain``; f32, or f64 when ``state`` is f64; any S."""
    dt = torch.promote_types(state.dtype, torch.float32)
    b, s, h, n = r.shape
    c = 2 * _SUB
    nc = -(-s // c)
    pad = nc * c - s

    def chunks(x):               # (B,S,H,n) -> (nc, B, H, C, n), zero tail
        x = torch.nn.functional.pad(x.to(dt), (0, 0, 0, 0, 0, pad))
        return x.reshape(b, nc, c, h, n).permute(1, 0, 3, 2, 4)
    rc, kc, vc, wc, oc = (chunks(x) for x in (r, k, v, wlog, do))
    Wc = torch.exp(wc)           # a padded token: w = 0, a decay of 1
    uf = u.to(dt)[None, :, None, :]
    dec = [_decays(Wc[i]) for i in range(nc)]
    # pass 1: the state at every chunk's start
    S = state.to(dt)
    starts = []
    for i in range(nc):
        starts.append(S)
        _, cb, _, cend = dec[i]
        S = cend[..., None] * S + (kc[i] * cb).transpose(-1, -2) @ vc[i]
    lo, hi = slice(0, _SUB), slice(_SUB, c)
    tri = torch.ones((_SUB, _SUB), dtype=torch.bool, device=r.device)
    strict = torch.tril(tri, -1)                               # s < t
    m_idx = torch.arange(_SUB, device=r.device)
    # (m, t, s): s < m < t, the pairs of a sub-chunk that straddle m
    straddle = ((m_idx[None, None, :] < m_idx[:, None, None])
                & (m_idx[:, None, None] < m_idx[None, :, None]))
    G = (torch.zeros((b, h, n, n), dtype=dt, device=r.device)
         if dstate is None else dstate.to(dt))
    out = {x: [None] * nc for x in ("r", "k", "v", "w")}
    du = torch.zeros((b, h, n), dtype=dt, device=r.device)
    for i in reversed(range(nc)):
        R, K, V, Wd, O, Sc = rc[i], kc[i], vc[i], Wc[i], oc[i], starts[i]
        cf, cb, rf, cend = dec[i]
        D = O @ V.transpose(-1, -2)                  # D[t, s] = do_t . v_s
        diag_d = torch.diagonal(D, 0, -2, -1)[..., None]         # D_tt
        # decay products of each sub-chunk's pairs s < t: prod_{s<q<t} W_q
        E = torch.zeros((b, h, 2, _SUB, _SUB, n), dtype=dt, device=r.device)
        for sc in range(2):
            Ws = Wd[:, :, sc * _SUB:(sc + 1) * _SUB]
            for s0 in range(_SUB - 1):
                E[:, :, sc, s0 + 1:, s0] = torch.cumprod(torch.cat(
                    [torch.ones_like(Ws[:, :, :1]), Ws[:, :, s0 + 1:-1]], 2),
                    2)
        Rs = R.reshape(b, h, 2, _SUB, n)
        Ks = K.reshape(b, h, 2, _SUB, n)
        Ds = torch.stack([D[:, :, lo, lo], D[:, :, hi, hi]], 2)
        Dm = torch.where(strict, Ds, 0)[..., None] * E   # (b,h,2,t,s,n)
        # the forward's scores A (the u bonus on the diagonal): the diagonal
        # blocks exact, the off-diagonal one through L_ref
        A = torch.zeros((b, h, c, c), dtype=dt, device=r.device)
        ad = torch.einsum("bhxti,bhxsi,bhxtsi->bhxts", Rs, Ks,
                          torch.where(strict[..., None], E, 0))
        A[:, :, lo, lo], A[:, :, hi, hi] = ad[:, :, 0], ad[:, :, 1]
        A = A + torch.diag_embed((R * uf * K).sum(-1))
        A[:, :, hi, lo] = (R[:, :, hi] * rf[:, :, hi]) @ (
            K[:, :, lo] * rf[:, :, lo]).transpose(-1, -2)
        # inter-chunk parts, and the off-diagonal block's
        drI = cf * (O @ Sc.transpose(-1, -2))
        dkI = cb * (V @ G.transpose(-1, -2))
        drX = rf[:, :, hi] * (D[:, :, hi, lo] @ (K[:, :, lo] * rf[:, :, lo]))
        dkX = rf[:, :, lo] * (D[:, :, hi, lo].transpose(-1, -2)
                              @ (R[:, :, hi] * rf[:, :, hi]))
        # the diagonal blocks, exact: sum_{s<t} E_ts k_s D_ts and its twin
        drD = torch.einsum("bhxtsi,bhxsi->bhxti", Dm, Ks).reshape(b, h, c, n)
        dkD = torch.einsum("bhxtsi,bhxti->bhxsi", Dm, Rs).reshape(b, h, c, n)
        zero = torch.zeros_like(drX)
        dr = drI + torch.cat([zero, drX], 2) + drD + uf * K * diag_d
        dk = dkI + torch.cat([dkX, zero], 2) + dkD + R * uf * diag_d
        dv = (K * cb) @ G + A.transpose(-1, -2) @ O
        # dw_m = W_m rowsum(G_m . S_{m-1}), expanded into its terms, each a
        # product of decays: exp(L_end) rowsum(G . S_c); k_s . dk_s's
        # inter part for s < m; r_t . dr_t's for t > m; the off-diagonal
        # block's pairs (in dk for m in the first sub-chunk, in dr for m in
        # the second); and the diagonal blocks' pairs s < m < t
        P = K * dkI                                 # prefix terms, s < m
        Q = R * drI                                 # suffix terms, t > m
        P[:, :, lo] += K[:, :, lo] * dkX
        Q[:, :, hi] += R[:, :, hi] * drX

        def before(x):          # sum over the earlier tokens of a sub-chunk
            return torch.cumsum(torch.cat([torch.zeros_like(x[:, :, :1]),
                                           x[:, :, :-1]], 2), 2)
        # each sub-chunk's running sums; across the sub-chunks the inter
        # parts only, the off-diagonal block's pairs being counted inside
        pre = torch.cat([before(P[:, :, lo]), before(P[:, :, hi]) + (
            K[:, :, lo] * dkI[:, :, lo]).sum(2, keepdim=True)], 2)
        suf = torch.cat([before(Q[:, :, lo].flip(2)).flip(2) + (
            R[:, :, hi] * drI[:, :, hi]).sum(2, keepdim=True),
            before(Q[:, :, hi].flip(2)).flip(2)], 2)
        X = torch.einsum("mts,bhxtsi,bhxti,bhxsi->bhxmi", straddle.to(dt), Dm,
                         Rs, Ks).reshape(b, h, c, n)
        dw = (cend * (G * Sc).sum(-1))[:, :, None] + pre + suf + X
        for key, val in (("r", dr), ("k", dk), ("v", dv), ("w", dw)):
            out[key][i] = val
        du = du + (R * K * diag_d).sum(2)
        G = cend[..., None] * G + (R * cf).transpose(-1, -2) @ O

    def unchunk(xs):            # nc x (B,H,C,n) -> (B,S,H,n)
        return torch.stack(xs, 1).permute(0, 1, 3, 2, 4).reshape(
            b, nc * c, h, n)[:, :s]
    return tuple(unchunk(out[x]) for x in ("r", "k", "v", "w")) + (
        du.sum(0),)


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


def _check_inputs(r, k, v, wlog, u, state):
    """(b, s, h, hs) of CUDA inputs the kernels take; raises otherwise."""
    device = r.device
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
    return b, s, h, hs


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


@once
def _bwd_launcher():
    lib, info = build_library(BWD_SOURCE, "wkv6_bwd")
    fn = lib.wkv6_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    scratch = lib.wkv6_bwd_scratch_floats
    scratch.argtypes = [ctypes.c_int] * 4
    scratch.restype = ctypes.c_longlong
    return fn, scratch, info


def build() -> dict:
    """Build (or reuse) and load the forward kernel; returns the build
    record of ``repro_torch.kernels.build.build_library``, with the dynamic
    shared memory of one block per head size under ``smem_bytes``."""
    return _launcher()[1]


def build_bwd() -> dict:
    """Build (or reuse) and load the backward kernel; its build record."""
    return _bwd_launcher()[2]


def _wkv6_kernel(r, k, v, wlog, u, state):
    """One launch of the forward kernel on checked CUDA inputs."""
    b, s, h, hs = _check_inputs(r, k, v, wlog, u, state)
    device = r.device
    o = torch.empty((b, s, h, hs), dtype=torch.float32, device=device)
    s_out = torch.empty((b, h, hs, hs), dtype=torch.float32, device=device)
    if b * h == 0:
        return o, s_out
    fn, _ = _launcher()
    # the launcher sets its shared-memory attribute and launches on the
    # current device: make it the tensors' one
    with torch.cuda.device(device):
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), wlog.data_ptr(),
                 u.data_ptr(), state.data_ptr(), o.data_ptr(),
                 s_out.data_ptr(), b, s, h, hs,
                 torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"wkv6: kernel launch failed with CUDA error "
                           f"{err}")
    wkv6.launches += 1
    return o, s_out


def wkv6_bwd(r, k, v, wlog, u, state, do, dstate=None):
    """The gradient of ``wkv6`` on CUDA tensors, by the backward kernel:
    the same results as ``wkv6_backward_plain`` (dr, dk, dv, dwlog, du).
    ``do`` and ``dstate`` (None: zero) are made contiguous here, since
    autograd hands them over in any layout; du is the kernel's per-(b, h)
    partials summed over b."""
    b, s, h, hs = _check_inputs(r, k, v, wlog, u, state)
    device = r.device
    do = do.contiguous()
    _check("do", do, (b, s, h, hs), device)
    if dstate is not None:
        dstate = dstate.contiguous()
        _check("dstate", dstate, (b, h, hs, hs), device)
    grads = [torch.empty((b, s, h, hs), dtype=torch.float32, device=device)
             for _ in range(4)]
    du_part = torch.zeros((b, h, hs), dtype=torch.float32, device=device)
    if b * h * s == 0:                 # every gradient but du is empty
        return (*grads, du_part.sum(0))
    fn, scratch_floats, _ = _bwd_launcher()
    scratch = torch.empty(int(scratch_floats(b, s, h, hs)),
                          dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), wlog.data_ptr(),
                 u.data_ptr(), state.data_ptr(), do.data_ptr(),
                 None if dstate is None else dstate.data_ptr(),
                 *(g.data_ptr() for g in grads), du_part.data_ptr(),
                 scratch.data_ptr(), b, s, h, hs,
                 torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"wkv6_bwd: kernel launch failed with CUDA error "
                           f"{err}")
    wkv6_bwd.launches += 1
    return (*grads, du_part.sum(0))


class WKV6Function(torch.autograd.Function):
    """``wkv6`` with a gradient, on CUDA tensors: forward by the forward
    kernel, backward by the backward kernel (``wkv6`` sends CPU tensors to
    plain autograd through ``wkv6_plain`` and never here).  The gradient
    of the final state is the reverse pass's initial adjoint.  No gradient
    flows to ``state``: the reference trains from the zero state, and a
    ``state`` that requires grad raises."""

    @staticmethod
    def forward(ctx, r, k, v, wlog, u, state):
        if state.requires_grad:
            raise ValueError("wkv6: no gradient flows to the initial state "
                             "(training starts from the zero state); "
                             "detach it")
        ctx.save_for_backward(r, k, v, wlog, u, state)
        # an unused final state gives None, not zeros: no adjoint to load
        ctx.set_materialize_grads(False)
        return _wkv6_kernel(r, k, v, wlog, u, state)

    @staticmethod
    def backward(ctx, do, dstate):
        r, k, v, wlog, u, state = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(r)
        return (*wkv6_bwd(r, k, v, wlog, u, state, do, dstate), None)


def wkv6(r, k, v, wlog, u, state, *, chunk: int = 64):
    """The wkv recurrence from ``state``: the CUDA kernel on CUDA tensors,
    ``wkv6_plain`` on CPU tensors.  Same arguments and results as
    ``wkv6_plain``; ``chunk`` is the plain version's chunk length, and the
    kernel, whose chunk is fixed in its source, does not read it.  On CUDA
    every input is f32, contiguous and 16-byte aligned, hs is 16, 32 or
    64, and S may be any length; where grad mode is on and an input
    requires grad the call goes through ``WKV6Function``, whose backward
    is a kernel too (a ``state`` that requires grad raises)."""
    device = r.device
    if device.type == "cpu":
        return wkv6_plain(r, k, v, wlog, u, state, chunk=chunk)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (r, k, v, wlog, u, state)):
        return WKV6Function.apply(r, k, v, wlog, u, state)
    return _wkv6_kernel(r, k, v, wlog, u, state)


wkv6.launches = 0
wkv6_bwd.launches = 0
