"""minitron-8b [dense] — pruned nemotron (squared-ReLU MLP, LayerNorm).
[arXiv:2407.14679; hf]"""
from repro_torch.configs.base import ArchConfig, register, shrink

CONFIG = register(
    ArchConfig(
        name="minitron-8b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=16384,
        vocab_size=256000,
        norm="layernorm",
        act="relu2",
        rope_theta=10_000.0,
        source="arXiv:2407.14679",
    ),
    lambda: shrink(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab_size=512),
)
