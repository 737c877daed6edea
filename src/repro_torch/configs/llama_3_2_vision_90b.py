"""llama-3.2-vision-90b [vlm] — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision].

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256. Every 5th layer is
a cross-attention layer attending to projected vision-patch embeddings. The
vision encoder (ViT + projector) is a STUB, as in the reference: callers
pass precomputed patch embeddings (B, 1024, d_model).
"""

from repro_torch.configs.base import (ATTN, CROSS_ATTN, MLP, LayerSpec,
                                      ModelConfig, Segment, register)

_PATTERN = (LayerSpec(CROSS_ATTN, MLP),) + (LayerSpec(ATTN, MLP),) * 4

CONFIG = register(ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    source="hf:meta-llama/Llama-3.2-11B-Vision",
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    segments=(Segment(pattern=_PATTERN, repeats=20),),   # 100 layers
    encoder_len=1024,                                    # stub patch embeddings
    rope_theta=500_000.0,
    optimizer="adafactor",   # 90B-class training state must fit 16 GB/chip
    supports_long_context=False,  # full attention — long_500k skipped
))
