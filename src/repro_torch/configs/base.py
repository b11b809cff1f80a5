"""Architecture / shape configuration system.

Every assigned architecture gets one module in this package exporting
``CONFIG`` (the exact published dims) and ``reduced()`` (a tiny same-family
variant for CPU smoke tests).  Shapes (seq_len x global_batch cells) are
global and owned here; each config reports which cells apply to it.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional


# ---------------------------------------------------------------------------
# Shape cells (assigned input-shape set, shared by every LM-family arch)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode' | 'long_decode'

    @property
    def is_decode(self) -> bool:
        return self.kind in ("decode", "long_decode")

    @property
    def tokens(self) -> int:
        """Tokens processed per step (decode steps emit one token/sequence)."""
        if self.is_decode:
            return self.global_batch
        return self.global_batch * self.seq_len


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "long_decode"),
}


# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0          # deepseek-v3 shared expert
    dense_residual: bool = False       # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    # which layers are MoE. 'all' | 'alternate' (odd layers) | 'after_prefix'
    layer_mode: str = "all"
    router_dtype: str = "float32"


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 Multi-head Latent Attention dims."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 dims (used by jamba's mamba sublayers)."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 256


@dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64
    decay_lora_rank: int = 64
    mix_lora_rank: int = 32


# ---------------------------------------------------------------------------
# Main architecture config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rope_mode: str = "rope"           # rope | mrope | sinusoidal | none
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    norm_eps: float = 1e-5
    act: str = "swiglu"               # swiglu | gelu
    tie_embeddings: bool = False

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None

    # dense transformer layers before the MoE stack (deepseek-v3: 3)
    n_dense_prefix: int = 0
    # hybrid (jamba): per-period sublayer pattern, e.g. 8 entries; n_layers
    # must be divisible by len(block_pattern).  Entries: 'attn' | 'mamba'.
    block_pattern: Optional[tuple[str, ...]] = None

    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    # frontend stubs: 'audio' -> precomputed frame embeddings,
    # 'vision' -> precomputed patch embeddings, '' -> token ids
    frontend: str = ""

    # source provenance (from the assignment table)
    source: str = ""

    # --- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def padded_vocab(self, multiple: int = 32) -> int:
        return int(math.ceil(self.vocab_size / multiple) * multiple)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run the 500k-token long-context decode cell?"""
        return self.family in ("ssm", "hybrid")

    def supports(self, shape: ShapeSpec) -> bool:
        if shape.kind == "long_decode":
            return self.sub_quadratic
        return True

    def cells(self) -> list[ShapeSpec]:
        return [s for s in SHAPES.values() if self.supports(s)]

    def skipped_cells(self) -> list[tuple[ShapeSpec, str]]:
        out = []
        for s in SHAPES.values():
            if not self.supports(s):
                out.append((s, "long_500k requires sub-quadratic attention; "
                               f"{self.name} is pure full-attention"))
        return out

    # --- parameter counting (for MODEL_FLOPS = 6*N*D) -----------------------
    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count; active_only counts top-k routed experts."""
        d, hd = self.d_model, self.resolved_head_dim
        V = self.vocab_size
        emb = V * d
        head = 0 if self.tie_embeddings else V * d

        def attn_params() -> int:
            if self.mla is not None:
                m = self.mla
                q = d * m.q_lora_rank + m.q_lora_rank * self.n_heads * (
                    m.qk_nope_head_dim + m.qk_rope_head_dim)
                kv = d * (m.kv_lora_rank + m.qk_rope_head_dim)
                kv += m.kv_lora_rank * self.n_heads * (
                    m.qk_nope_head_dim + m.v_head_dim)
                o = self.n_heads * m.v_head_dim * d
                return q + kv + o
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            b = (self.n_heads + 2 * self.n_kv_heads) * hd if self.qkv_bias else 0
            return q + kv + o + b

        def dense_ffn() -> int:
            mult = 3 if self.act == "swiglu" else 2
            return mult * d * self.d_ff

        def moe_ffn(active: bool) -> int:
            m = self.moe
            assert m is not None
            mult = 3 if self.act == "swiglu" else 2
            n_e = m.top_k if active else m.n_experts
            p = n_e * mult * d * m.d_ff_expert
            p += m.n_shared_experts * mult * d * m.d_ff_expert
            if m.dense_residual:
                p += dense_ffn()
            p += d * m.n_experts  # router
            return p

        def mamba_params() -> int:
            s = self.ssm
            assert s is not None
            di = s.expand * d
            p = 2 * d * di                      # in_proj (x, z)
            p += di * s.d_conv                  # depthwise conv
            p += di * (s.dt_rank + 2 * s.d_state)  # x_proj
            p += s.dt_rank * di                 # dt_proj
            p += di * s.d_state + di            # A_log, D
            p += di * d                         # out_proj
            return p

        def rwkv_params() -> int:
            r = self.rwkv
            assert r is not None
            tm = 4 * d * d + d * d              # r,k,v,g + output
            tm += d * r.decay_lora_rank * 2     # decay lora
            tm += 6 * d * r.mix_lora_rank * 2   # ddlerp loras (approx)
            cm = d * self.d_ff + self.d_ff * d + d * d  # channel mix k,v,r
            return tm + cm

        total = emb + head
        n_moe, n_dense = 0, 0
        pattern = self.block_pattern
        for layer in range(self.n_layers):
            if pattern is not None:
                sub = pattern[layer % len(pattern)]
                total += attn_params() if sub == "attn" else mamba_params()
                if self.moe is not None and self.moe.layer_mode == "alternate":
                    if layer % 2 == 1:
                        n_moe += 1
                    else:
                        n_dense += 1
                else:
                    n_dense += 1
                continue
            if self.family == "ssm":
                # channel-mix is already the FFN — no extra dense MLP.
                total += rwkv_params()
                continue
            total += attn_params()
            if self.moe is not None and layer >= self.n_dense_prefix:
                n_moe += 1
            else:
                n_dense += 1
        if self.enc_dec:
            # encoder: self-attn + ffn; decoder already counted above,
            # add cross-attention for decoder layers.
            total += self.n_enc_layers * (attn_params() + dense_ffn())
            total += self.n_layers * attn_params()  # cross attn
        total += n_dense * dense_ffn()
        if n_moe:
            total += n_moe * moe_ffn(active=active_only)
        return total

    def model_flops(self, shape: ShapeSpec) -> float:
        """6*N*D with N = active params (MoE counts top-k)."""
        n = self.param_count(active_only=True)
        mult = 6.0 if shape.kind == "train" else 2.0
        return mult * n * shape.tokens


# registry -------------------------------------------------------------------

_REGISTRY: dict[str, "tuple"] = {}


def register(config: ArchConfig, reduced_fn) -> ArchConfig:
    _REGISTRY[config.name] = (config, reduced_fn)
    return config


def get_config(name: str) -> ArchConfig:
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name][0]


def get_reduced(name: str) -> ArchConfig:
    _load_all()
    return _REGISTRY[name][1]()


def list_archs() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)


_LOADED = False

_ARCH_MODULES = [
    "codeqwen15_7b", "qwen2_72b", "phi3_medium_14b", "minitron_8b",
    "rwkv6_1p6b", "qwen2_vl_2b", "jamba_v01_52b", "arctic_480b",
    "deepseek_v3_671b", "whisper_base",
]


def _load_all() -> None:
    global _LOADED
    if _LOADED:
        return
    import importlib
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")
    _LOADED = True


def shrink(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Build a reduced same-family config for smoke tests."""
    return dataclasses.replace(cfg, **overrides)
