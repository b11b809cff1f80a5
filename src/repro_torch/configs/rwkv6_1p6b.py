"""rwkv6-1.6b [ssm] — Finch: attention-free, data-dependent decay.
[arXiv:2404.05892; unverified]"""
from repro_torch.configs.base import ArchConfig, RWKVConfig, register, shrink

CONFIG = register(
    ArchConfig(
        name="rwkv6-1.6b",
        family="ssm",
        n_layers=24,
        d_model=2048,
        n_heads=32,           # d_model / head_size
        n_kv_heads=32,
        d_ff=7168,
        vocab_size=65536,
        rope_mode="none",
        norm="layernorm",
        rwkv=RWKVConfig(head_size=64, decay_lora_rank=64, mix_lora_rank=32),
        source="arXiv:2404.05892",
    ),
    lambda: shrink(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=224, vocab_size=512,
        rwkv=RWKVConfig(head_size=16, decay_lora_rank=8, mix_lora_rank=4)),
)
