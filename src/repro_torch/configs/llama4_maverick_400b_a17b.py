"""llama4-maverick-400b-a17b [moe] — 128 routed experts top-1 + shared.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048.

Assignment-line config: every layer MoE (128e top-1, expert d_ff 8192) with
one shared expert.  HF Maverick interleaves dense layers; the assignment
line wins (DESIGN.md §5, [unverified] tier).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    vocab_size=202048,
    attention="gqa",
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    mlp="swiglu",
    num_experts=128,
    top_k=1,
    num_shared_experts=1,
    moe_d_ff=8192,
    rope_theta=500000.0,
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        num_layers=2,
        d_model=64,
        vocab_size=512,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=64,
        num_experts=8,
        top_k=1,
        num_shared_experts=1,
        moe_d_ff=64,
    )
