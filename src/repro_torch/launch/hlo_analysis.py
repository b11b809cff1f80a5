"""Roofline terms of a step from its cost pass; the port's
``repro.launch.hlo_analysis``.

Hardware model: one NVIDIA H100 SXM5 80GB at its 700 W limit, the dense
peaks of NVIDIA's H100 SXM data sheet, per card:

  989 TFLOP/s bf16 (tensor cores, dense); f32 counted at the 3xTF32
  rate the port's kernels run at, 495 / 3 TFLOP/s (each f32 product in
  three TF32 passes; ``PERF.md``'s kernel bounds use it) · 3.35 TB/s
  HBM3 · 450 GB/s each way over NVLink to the other 7 cards of its host
  (DGX H100) · 50 GB/s to a card on another host: one 400 Gb/s network
  port per card, as the DGX H100 data sheet gives it (8 ConnectX-7 ports
  for 8 cards).

The collective statistics are the cost pass's (``launch/hlo_costs.py``:
the bytes each card sends, by link), not parsed from text.  A card's
NVLink and its network port carry their traffic at once, so the
collective term is the longer of the two links' times.
"""
from __future__ import annotations

import torch

CARD = "NVIDIA H100 SXM5 80GB"
POWER_LIMIT_W = 700
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 495e12 / 3}
HBM_BW = 3.35e12         # bytes/s per card
NVLINK_BW = 450e9        # bytes/s per card, each way, within a host
NET_BW = 50e9            # bytes/s per card, to another host


def peaks(dtype=torch.float32) -> dict:
    """The constants ``roofline_terms`` uses for a step in ``dtype``, and
    the card they describe (a dry run's record keeps them)."""
    return {"card": CARD, "power_limit_w": POWER_LIMIT_W,
            "source": "NVIDIA H100 SXM data sheet (dense peaks); DGX H100 "
                      "data sheet (one 400 Gb/s port per card)",
            "peak_flops": PEAK_FLOPS[dtype], "hbm_bw": HBM_BW,
            "nvlink_bw": NVLINK_BW, "net_bw": NET_BW}


def roofline_terms(hlo_flops: float, hlo_bytes: float, coll_bytes: float,
                   n_chips: int, model_flops_global: float, *,
                   inter_host_bytes: float = 0.0,
                   dtype=torch.float32) -> dict:
    """The reference's terms for one card's counts: ``coll_bytes`` all it
    sends, ``inter_host_bytes`` the part of it bound for other hosts."""
    peak = PEAK_FLOPS[dtype]
    compute_t = hlo_flops / peak
    memory_t = hlo_bytes / HBM_BW
    coll_t = max((coll_bytes - inter_host_bytes) / NVLINK_BW,
                 inter_host_bytes / NET_BW)
    terms = {"compute": compute_t, "memory": memory_t, "collective": coll_t}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    useful_t = model_flops_global / (n_chips * peak)
    return {
        "compute_term_s": compute_t,
        "memory_term_s": memory_t,
        "collective_term_s": coll_t,
        "dominant": dominant,
        "step_bound_s": bound,
        "model_flops_global": model_flops_global,
        "hlo_flops_global": hlo_flops * n_chips,
        "useful_flops_ratio": (model_flops_global / (hlo_flops * n_chips)
                               if hlo_flops else 0.0),
        "roofline_fraction": useful_t / bound if bound else 0.0,
    }
