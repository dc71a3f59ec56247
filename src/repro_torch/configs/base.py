"""Architecture configuration schema + registry (a copy of the JAX
package's ``configs/base.py``; the getters import this package's configs).

One ``ArchConfig`` instance per assigned architecture lives in
``configs/<id>.py``; ``reduced()`` derives the CPU smoke-test config of the
same family (small widths, few layers/experts, tiny vocab).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Literal

LayerKind = Literal["attn", "local_attn", "rglru", "ssm"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    vocab_size: int

    # attention
    attention: str = "gqa"          # gqa | mla | none
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    rope_theta: float = 10000.0

    # MLP
    d_ff: int = 0
    mlp: str = "swiglu"             # swiglu | relu2 | gelu

    # MoE (num_experts == 0 -> dense FFN everywhere)
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0               # routed expert hidden size
    first_dense_layers: int = 0     # leading layers with dense FFN
    capacity_factor: float = 1.25

    # MLA
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    d_inner: int = 0
    ssm_headdim: int = 64
    ssm_groups: int = 1
    conv_width: int = 4
    ssd_chunk: int = 64

    # hybrid (recurrentgemma): repeating layer pattern
    layer_pattern: tuple[str, ...] = ()
    window: int = 0                 # local attention window
    lru_width: int = 0

    # modality frontend stub: none | patch | frame
    frontend: str = "none"

    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # sub-quadratic? (drives the long_500k skip rule)
    @property
    def subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def num_heads_or_1(self) -> int:
        return max(1, self.num_heads)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


ARCH_IDS = [
    "recurrentgemma_2b",
    "deepseek_v2_236b",
    "llama4_maverick_400b_a17b",
    "mamba2_1p3b",
    "minitron_4b",
    "minicpm3_4b",
    "qwen2p5_3b",
    "nemotron_4_15b",
    "llava_next_34b",
    "musicgen_medium",
    "bwt_index",                    # the paper's own workload as a config
]


def get_config(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(
        f"{__package__}.{arch_id.replace('-', '_')}")
    return mod.CONFIG


def get_reduced_config(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(
        f"{__package__}.{arch_id.replace('-', '_')}")
    return mod.reduced()
