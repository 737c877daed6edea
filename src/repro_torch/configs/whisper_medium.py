"""whisper-medium [audio] — enc-dec, conv frontend (stub) [arXiv:2212.04356].

24L d_model=1024 16H (kv=16) d_ff=4096 vocab=51865. Whisper-medium is a
24-encoder-layer / 24-decoder-layer encoder-decoder; each decoder layer has
self-attention + cross-attention + MLP, which we express as two sub-layer
specs (ATTN/none then XATTN/mlp) per decoder layer. The mel-spectrogram +
conv feature extractor is a STUB, as in the reference: callers pass
precomputed frame embeddings (B, 1500, d_model) (the port's launchers and
tests draw them from a seed).

Deviation note (the reference's): it uses RoPE in place of whisper's
learned absolute positions — positional scheme is orthogonal to the WeiPS
sync/deployment mechanics under study.
"""

from repro_torch.configs.base import (ATTN, CROSS_ATTN, ENC_ATTN, MLP,
                                      NONE, LayerSpec, ModelConfig, Segment,
                                      register)

_DEC_PATTERN = (LayerSpec(ATTN, NONE), LayerSpec(CROSS_ATTN, MLP))

CONFIG = register(ModelConfig(
    name="whisper-medium",
    family="audio",
    source="arXiv:2212.04356",
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    segments=(Segment(pattern=_DEC_PATTERN, repeats=24),),
    encoder_segments=(Segment(pattern=(LayerSpec(ENC_ATTN, MLP),), repeats=24),),
    encoder_len=1500,         # stub conv frontend output frames
    rope_theta=10_000.0,
    optimizer="adam",
    supports_long_context=False,   # bounded decoder context (448-token family)
))
