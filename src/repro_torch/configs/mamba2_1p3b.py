"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]  48L d_model=2048 d_inner=4096 (expand 2),
headdim=64, ssm_state=128, vocab=50280.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    vocab_size=50280,
    attention="none",
    ssm_state=128,
    d_inner=4096,
    ssm_headdim=64,
    ssm_groups=1,
    conv_width=4,
    ssd_chunk=256,
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        num_layers=4,
        d_model=64,
        vocab_size=512,
        ssm_state=16,
        d_inner=128,
        ssm_headdim=32,
        ssd_chunk=8,
    )
