"""LM-derived simulator workloads — the assigned architectures as kernels.

The paper's technique applied first-class: every (arch × shape) cell can be
converted into a GPU kernel trace (per-layer GEMM tiles, attention tiles,
MoE dispatch, recurrence chunks) and simulated on the modeled GPU with the
deterministic parallel engine.  One representative layer is traced and
scaled (tokens ÷ ``token_div``, CTAs capped) so cells simulate in seconds;
the mapping is documented per family below.
"""
from __future__ import annotations

import math

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.sim.trace import Workload, build_kernel
from repro_torch.workloads.synthetic import (_body_gemm_tile, _body_irregular,
                                       _body_stream)

TILE = 128
CTA_CAP = 4096


def _gemm_kernel(name, m, n, k, warps=4):
    ctas = min(CTA_CAP, max(1, math.ceil(m / TILE) * math.ceil(n / TILE)))
    ksteps = min(32, max(1, k // TILE))
    return build_kernel(name, n_ctas=ctas, warps_per_cta=warps,
                        body=_body_gemm_tile(ksteps))


def arch_workload(cfg: ArchConfig, shape: ShapeSpec,
                  token_div: int = 64) -> Workload:
    """One representative transformer layer of `cfg` under `shape`."""
    w = Workload(f"{cfg.name}__{shape.name}")
    add = w.kernels.append
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    if shape.is_decode:
        tokens = max(1, shape.global_batch)
    else:
        tokens = max(1, shape.tokens // token_div)

    # attention / mixer
    if cfg.family == "ssm":
        # rwkv: chunked linear attention — CTAs = B×H chunk-scans
        add(_gemm_kernel("proj_rkvg", tokens, 4 * d, d))
        chunks = max(1, min(CTA_CAP, tokens // 64))
        add(build_kernel("wkv_chunk", n_ctas=chunks, warps_per_cta=2,
                         body=_body_stream(4, 24, store=True), repeats=2))
        add(_gemm_kernel("out_proj", tokens, d, d))
    else:
        qkv_out = (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
        add(_gemm_kernel("qkv_proj", tokens, qkv_out, d))
        if shape.is_decode:
            # decode attention: stream the KV cache
            ctas = min(CTA_CAP,
                       max(1, shape.global_batch * cfg.n_kv_heads))
            add(build_kernel("attn_decode", n_ctas=ctas, warps_per_cta=4,
                             body=_body_stream(8, 8, store=False),
                             repeats=4))
        else:
            s_tiles = max(1, (shape.seq_len // token_div) // TILE)
            ctas = min(CTA_CAP, max(1, cfg.n_heads * s_tiles))
            add(build_kernel("attn_tiles", n_ctas=ctas, warps_per_cta=4,
                             body=_body_gemm_tile(8), repeats=2))
        add(_gemm_kernel("o_proj", tokens, d, cfg.n_heads * hd))

    # FFN / MoE
    if cfg.moe is not None:
        add(build_kernel("moe_route", n_ctas=min(CTA_CAP,
                                                 max(1, tokens // 256)),
                         warps_per_cta=4, body=_body_irregular(4, 8)))
        e_tokens = max(1, tokens * cfg.moe.top_k // cfg.moe.n_experts)
        for proj, (m, n, k) in {
                "expert_up": (e_tokens * min(cfg.moe.n_experts, 16),
                              cfg.moe.d_ff_expert, d),
                "expert_down": (e_tokens * min(cfg.moe.n_experts, 16), d,
                                cfg.moe.d_ff_expert)}.items():
            add(_gemm_kernel(proj, m, n, k))
    else:
        add(_gemm_kernel("ffn_up", tokens, cfg.d_ff, d))
        add(_gemm_kernel("ffn_down", tokens, d, cfg.d_ff))
    if cfg.block_pattern is not None:
        # jamba: one mamba sublayer (conv + chunked scan)
        di = cfg.ssm.expand * d
        add(_gemm_kernel("mamba_in", tokens, 2 * di, d))
        chunks = max(1, min(CTA_CAP, tokens // 64))
        add(build_kernel("ssm_chunk", n_ctas=chunks, warps_per_cta=2,
                         body=_body_stream(4, 20), repeats=2))
        add(_gemm_kernel("mamba_out", tokens, d, di))
    return w
