"""qwen2-1.5b [dense] — GQA, QKV bias [arXiv:2407.10671].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.
"""

from repro_torch.configs.base import ATTN, MLP, LayerSpec, ModelConfig, Segment, register

CONFIG = register(ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    source="arXiv:2407.10671",
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    segments=(Segment(pattern=(LayerSpec(ATTN, MLP),), repeats=28),),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    optimizer="adam",
    supports_long_context=False,
))
