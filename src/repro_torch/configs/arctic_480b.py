"""arctic-480b [moe] — 128 experts top-2 + dense residual MLP.
[hf:Snowflake/snowflake-arctic-base; hf]"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register, shrink

CONFIG = register(
    ArchConfig(
        name="arctic-480b",
        family="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=4864,
        vocab_size=32000,
        rope_theta=10_000.0,
        moe=MoEConfig(n_experts=128, top_k=2, d_ff_expert=4864,
                      dense_residual=True, layer_mode="all"),
        source="hf:Snowflake/snowflake-arctic-base",
    ),
    lambda: shrink(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab_size=512,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=96,
                      dense_residual=True, layer_mode="all")),
)
