"""phi3-medium-14b [dense] — RoPE SwiGLU GQA. [arXiv:2404.14219; unverified]"""
from repro_torch.configs.base import ArchConfig, register, shrink

CONFIG = register(
    ArchConfig(
        name="phi3-medium-14b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=10,
        d_ff=17920,
        vocab_size=100352,
        rope_theta=10_000.0,
        source="arXiv:2404.14219",
    ),
    lambda: shrink(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=224, vocab_size=512),
)
