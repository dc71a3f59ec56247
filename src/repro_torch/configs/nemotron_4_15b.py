"""nemotron-4-15b [dense] — GQA, squared-ReLU MLP.
[arXiv:2402.16819; unverified]  32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    vocab_size=256000,
    attention="gqa",
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    mlp="relu2",
    rope_theta=10000.0,
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        num_layers=2,
        d_model=64,
        vocab_size=512,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
    )
