"""granite-moe-3b-a800m [moe] — fine-grained experts, top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base].

32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155, MoE 40e top-8.

A field-for-field copy of the reference's config, so the two compare
equal. Its ``source`` names the 1b-a400m checkpoint, while its widths are
those of granite-3.0-3b-a800m (1,536 wide, 32 layers, 40 experts, top-8);
the field is kept as the reference has it.
"""

from repro_torch.configs.base import ATTN, MOE, LayerSpec, ModelConfig, Segment, register

CONFIG = register(ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,                 # fine-grained experts
    vocab_size=49155,
    segments=(Segment(pattern=(LayerSpec(ATTN, MOE),), repeats=32),),
    num_experts=40,
    experts_per_token=8,
    rope_theta=10_000.0,
    optimizer="adam",
    supports_long_context=False,
))
