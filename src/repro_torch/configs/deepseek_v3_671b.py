"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed experts top-8.
(MTP head noted in DESIGN.md; not part of the lowered step.)
[arXiv:2412.19437; hf]"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, register, shrink

CONFIG = register(
    ArchConfig(
        name="deepseek-v3-671b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,
        d_ff=18432,               # dense-prefix MLP width (published)
        vocab_size=129280,
        rope_theta=10_000.0,
        n_dense_prefix=3,
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048,
                      n_shared_experts=1, layer_mode="after_prefix"),
        source="arXiv:2412.19437",
    ),
    lambda: shrink(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=192, vocab_size=512, n_dense_prefix=1,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_head_dim=16, qk_rope_head_dim=8,
                      v_head_dim=16),
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64,
                      n_shared_experts=1, layer_mode="after_prefix")),
)
