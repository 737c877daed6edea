"""gemma3-4b [dense] — 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt].

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144. Pattern is 5 sliding
-window (1024) layers per global layer; 34 = 5 full 6-layer periods + a
4-local tail (handled as a second segment so every segment scans
homogeneously).
"""

from repro_torch.configs.base import (ATTN, LOCAL_ATTN, MLP, LayerSpec,
                                      ModelConfig, Segment, register)

_PERIOD = (LayerSpec(LOCAL_ATTN, MLP),) * 5 + (LayerSpec(ATTN, MLP),)
_TAIL = (LayerSpec(LOCAL_ATTN, MLP),)

CONFIG = register(ModelConfig(
    name="gemma3-4b",
    family="dense",
    source="hf:google/gemma-3-1b-pt",
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    segments=(
        Segment(pattern=_PERIOD, repeats=5),   # 30 layers
        Segment(pattern=_TAIL, repeats=4),     # +4 local tail = 34
    ),
    window_size=1024,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    optimizer="adam",
    supports_long_context=True,   # sliding-window local attention
))
