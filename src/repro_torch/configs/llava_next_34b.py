"""llava-next-34b [vlm] — transformer BACKBONE only; the anyres-tiling
vision frontend is a stub (input_specs provides precomputed patch
embeddings, per assignment).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    vocab_size=64000,
    attention="gqa",
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    mlp="swiglu",
    frontend="patch",
    rope_theta=5000000.0,
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
