"""musicgen-medium [audio] — decoder-only over EnCodec tokens; the EnCodec
frame frontend is a stub (input_specs provides precomputed frame embeddings,
per assignment).  Codebook delay-pattern interleaving is out of scope
(single-stream decoding, DESIGN.md §5).
[arXiv:2306.05284; hf]  48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    vocab_size=2048,
    attention="gqa",
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    mlp="gelu",
    frontend="frame",
    rope_theta=10000.0,
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        num_layers=2,
        d_model=64,
        vocab_size=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
    )
