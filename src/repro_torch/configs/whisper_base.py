"""whisper-base [audio] — encoder-decoder; conv frontend STUBBED
(input_specs() provides precomputed frame embeddings).
Vocab 51865 is padded to a TP-divisible multiple in the embedding table.
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ArchConfig, register, shrink

CONFIG = register(
    ArchConfig(
        name="whisper-base",
        family="audio",
        n_layers=6,               # decoder layers
        n_enc_layers=6,
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        d_ff=2048,
        vocab_size=51865,
        enc_dec=True,
        tie_embeddings=True,
        norm="layernorm",
        act="gelu",
        rope_mode="sinusoidal",
        frontend="audio",
        source="arXiv:2212.04356",
    ),
    lambda: shrink(
        CONFIG, n_layers=2, n_enc_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab_size=512),
)
