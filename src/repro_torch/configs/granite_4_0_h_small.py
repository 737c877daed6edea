"""granite-4.0-h-small [hybrid] — Mamba-2 and NoPE attention, 72
fine-grained dropless experts and a shared expert in every layer
[hf:ibm-granite/granite-4.0-h-small, config.json; model_type
granitemoehybrid]. The reference has no such architecture: a
``PortModelConfig``, in ``PORT_ONLY_ARCH_IDS``.

40L d_model=4096; Mamba-2 128 heads of 64 (d_inner 8192), state 128, one
group, conv 4 with bias, chunk 256; GQA 32 query / 8 KV heads of 128 with
no positional embedding and a softmax scale of ``attention_multiplier``
1/128; in every layer a MoE of 72 experts of width 768, top-10, gated
SiLU, dropless, beside a shared gated-SiLU expert of width 1536;
embeddings times 12, both residual branches times 0.22, logits over 16;
RMSNorm eps 1e-5; a tied vocabulary of 100,352 rows. ``layer_types``
put attention at 5, 15, 25 and 35: one period of 10 layers, 4 times.

``granite-4.0-h-small-ep8`` is one card's share of a deployment: one
period (a pipeline stage of four) and experts ``[0, 9)`` of every layer
(the 72 over 8 cards by expert parallelism); the router keeps its 72
outputs and top-10.
"""

import dataclasses

from repro_torch.configs.base import (ATTN, MAMBA, MOE, LayerSpec,
                                      PortModelConfig, Segment, register)

_PERIOD = (LayerSpec(MAMBA, MOE),) * 5 + (LayerSpec(ATTN, MOE),) \
    + (LayerSpec(MAMBA, MOE),) * 4

CONFIG = register(PortModelConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    source="hf:ibm-granite/granite-4.0-h-small",
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=768,                 # one expert's width
    vocab_size=100352,
    segments=(Segment(pattern=_PERIOD, repeats=4),),   # 40 layers
    num_experts=72,
    experts_per_token=10,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=256,
    rope_theta=10_000.0,      # published, unused: no positional embedding
    optimizer="adam",
    supports_long_context=True,   # 36 of 40 layers are Mamba-2
    tie_embeddings=True,
    shared_expert_ff=1536,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    attention_multiplier=0.0078125,
    logits_scaling=16.0,
    use_rope=False,
    moe_dropless=True,
    norm_eps=1e-5,
))

EP8_STAGE = register(dataclasses.replace(
    CONFIG, name="granite-4.0-h-small-ep8",
    segments=(Segment(pattern=_PERIOD, repeats=1),), experts_held=9))
