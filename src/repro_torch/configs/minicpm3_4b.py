"""minicpm3-4b [dense] — dense transformer with MLA attention.
[hf:openbmb/MiniCPM3-4B; hf]  62L d_model=2560 40H d_ff=6400 vocab=73448.
MLA dims from the HF config family: q_lora 768, kv_lora 256, qk_nope 64,
qk_rope 32, v_head 64 (mu-param residual scaling omitted — init detail,
DESIGN.md §5).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    vocab_size=73448,
    attention="mla",
    num_heads=40,
    head_dim=64,
    d_ff=6400,
    mlp="swiglu",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
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
        q_lora_rank=32,
        kv_lora_rank=16,
        qk_nope_dim=16,
        qk_rope_dim=8,
        v_head_dim=16,
    )
