"""dbrx-132b [moe] — 16 experts top-4, fine-grained [hf:databricks/dbrx-base].

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16e top-4.
"""

from repro_torch.configs.base import ATTN, MOE, LayerSpec, ModelConfig, Segment, register

CONFIG = register(ModelConfig(
    name="dbrx-132b",
    family="moe",
    source="hf:databricks/dbrx-base",
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    segments=(Segment(pattern=(LayerSpec(ATTN, MOE),), repeats=40),),
    num_experts=16,
    experts_per_token=4,
    rope_theta=500_000.0,
    optimizer="adafactor",   # 132B-class training state must fit 16 GB/chip
    supports_long_context=False,
))
