"""deepseek-v2-236b [moe] — MLA (kv_lora=512), 2 shared + 160 routed top-6.
[arXiv:2405.04434; hf]  60L d_model=5120 128H d_ff(expert)=1536 vocab=102400.
Layer 0 uses a dense FFN (d_ff 12288) per the HF config.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    vocab_size=102400,
    attention="mla",
    num_heads=128,
    head_dim=128,             # qk_nope dim (per-head)
    d_ff=12288,               # dense-FFN width (prefix layer)
    mlp="swiglu",
    num_experts=160,
    top_k=6,
    num_shared_experts=2,
    moe_d_ff=1536,
    first_dense_layers=1,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    rope_theta=10000.0,
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        num_layers=3,
        d_model=64,
        vocab_size=512,
        num_heads=4,
        head_dim=16,
        d_ff=128,
        num_experts=8,
        top_k=2,
        num_shared_experts=1,
        moe_d_ff=32,
        first_dense_layers=1,
        q_lora_rank=32,
        kv_lora_rank=16,
        qk_nope_dim=16,
        qk_rope_dim=8,
        v_head_dim=16,
    )
