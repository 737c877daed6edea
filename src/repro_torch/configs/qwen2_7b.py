"""qwen2-7b [dense] — GQA, QKV bias [arXiv:2407.10671].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
"""

from repro_torch.configs.base import ATTN, MLP, LayerSpec, ModelConfig, Segment, register

CONFIG = register(ModelConfig(
    name="qwen2-7b",
    family="dense",
    source="arXiv:2407.10671",
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    segments=(Segment(pattern=(LayerSpec(ATTN, MLP),), repeats=28),),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    optimizer="adam",
    supports_long_context=False,
))
