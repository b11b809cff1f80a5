"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE every other
layer (16 experts, top-2). [arXiv:2403.19887; hf]"""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig, register, shrink

# 8-sublayer period with the single attention layer at index 4 (1:7 ratio);
# MoE replaces the MLP on every odd sublayer.
PATTERN = ("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba")

CONFIG = register(
    ArchConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=65536,
        norm="rmsnorm",
        rope_mode="none",          # jamba uses no positional encoding
        moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336,
                      layer_mode="alternate"),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, dt_rank=256),
        block_pattern=PATTERN,
        source="arXiv:2403.19887",
    ),
    lambda: shrink(
        CONFIG, n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=192, vocab_size=512,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=192,
                      layer_mode="alternate"),
        ssm=SSMConfig(d_state=4, d_conv=4, expand=2, dt_rank=8)),
)
