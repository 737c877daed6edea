"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE
[arXiv:2403.19887].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Period of 8 layers = 1 attention + 7 mamba; MoE on every other layer
(4 MoE + 4 MLP per period), following the Jamba block design.

Adaptation note (DESIGN.md §Assumptions): our SSM block is the Mamba-2/SSD
formulation (ssm_state=128) rather than Jamba's Mamba-1 selective scan —
the framework's single SSM substrate is SSD, and the sharding/sync story is
identical.
"""

from repro_torch.configs.base import (ATTN, MAMBA, MLP, MOE, LayerSpec,
                                      ModelConfig, Segment, register)

_PATTERN = (
    LayerSpec(ATTN, MOE),
    LayerSpec(MAMBA, MLP),
    LayerSpec(MAMBA, MOE),
    LayerSpec(MAMBA, MLP),
    LayerSpec(MAMBA, MOE),
    LayerSpec(MAMBA, MLP),
    LayerSpec(MAMBA, MOE),
    LayerSpec(MAMBA, MLP),
)

CONFIG = register(ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    source="arXiv:2403.19887",
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    segments=(Segment(pattern=_PATTERN, repeats=9),),   # 72 layers
    num_experts=16,
    experts_per_token=2,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    rope_theta=1_000_000.0,
    optimizer="adafactor",   # 398B-class training state must fit 16 GB/chip
    supports_long_context=True,   # SSM-dominated, 1:7 attention
))
