"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution (vision frontend stubbed:
input_specs() provides precomputed patch embeddings). [arXiv:2409.12191; hf]"""
from repro_torch.configs.base import ArchConfig, register, shrink

CONFIG = register(
    ArchConfig(
        name="qwen2-vl-2b",
        family="vlm",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_ff=8960,
        vocab_size=151936,
        qkv_bias=True,
        rope_mode="mrope",
        rope_theta=1_000_000.0,
        frontend="vision",
        source="arXiv:2409.12191",
    ),
    lambda: shrink(
        CONFIG, n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
        d_ff=256, vocab_size=512),
)
