"""minitron-4b [dense] — pruned Nemotron-4 (squared-ReLU MLP, GQA).
[arXiv:2407.14679; hf]  32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    vocab_size=256000,
    attention="gqa",
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9216,
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
