"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 pattern.
[arXiv:2402.19427; hf]  26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    vocab_size=256000,
    attention="gqa",
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    mlp="swiglu",            # gated-GeLU in the paper; gate structure matches
    layer_pattern=("rglru", "rglru", "local_attn"),
    window=2048,
    lru_width=2560,
    conv_width=4,
    rope_theta=10000.0,
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        num_layers=6,            # 2 full (rglru, rglru, local_attn) groups
        d_model=64,
        vocab_size=512,
        num_heads=4,
        num_kv_heads=1,
        head_dim=16,
        d_ff=128,
        window=16,
        lru_width=64,
    )
