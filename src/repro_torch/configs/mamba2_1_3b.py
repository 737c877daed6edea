"""mamba2-1.3b [ssm] — SSD (state-space duality) [arXiv:2405.21060].

48L d_model=2048, attention-free, d_ff=0, vocab=50280, ssm_state=128.

A field-for-field copy of the reference's config, so the two compare
equal: 64 SSM heads of 64 over d_inner 4096, a conv of width 4 over
4,352 channels, chunk 256, the vocabulary padded to 50,432 rows, tied
embeddings.
"""

from repro_torch.configs.base import (MAMBA, NONE, LayerSpec, ModelConfig,
                                      Segment, register)

CONFIG = register(ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    source="arXiv:2405.21060",
    d_model=2048,
    num_heads=1,          # attention-free; unused
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    segments=(Segment(pattern=(LayerSpec(MAMBA, NONE),), repeats=48),),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    tie_embeddings=True,
    optimizer="adam",
    supports_long_context=True,   # O(1) recurrent decode state
))
