"""qwen1.5-4b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B].

40L d_model=2560 20H (GQA kv=20, i.e. MHA) d_ff=6912 vocab=151936.
"""

from repro_torch.configs.base import ATTN, MLP, LayerSpec, ModelConfig, Segment, register

CONFIG = register(ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    source="hf:Qwen/Qwen1.5-0.5B",
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151936,
    segments=(Segment(pattern=(LayerSpec(ATTN, MLP),), repeats=40),),
    qkv_bias=True,
    rope_theta=5_000_000.0,
    optimizer="adam",
    supports_long_context=False,
))
