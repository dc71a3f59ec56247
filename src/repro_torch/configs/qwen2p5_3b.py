"""qwen2.5-3b [dense] — GQA with QKV bias.
[hf:Qwen/Qwen2.5-0.5B; hf]  36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    vocab_size=151936,
    attention="gqa",
    num_heads=16,
    num_kv_heads=2,
    head_dim=128,
    qkv_bias=True,
    d_ff=11008,
    mlp="swiglu",
    rope_theta=1000000.0,
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
