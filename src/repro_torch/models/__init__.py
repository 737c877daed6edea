"""The paper's sparse CTR models (LR / FM / DNN, ``models.ctr``) and the
LM path (``models.model``: attention, encoder and cross attention and
Mamba-2 mixers, ``models.ssm``, with MLP, MoE or no FFNs,
``models.moe``) in PyTorch."""
from repro_torch.models import ssm
from repro_torch.models.model import (decode_step, encode, forward,
                                      head_logits, init_cache, init_params,
                                      lm_head_weights,
                                      precompute_cross_cache)

__all__ = ["decode_step", "encode", "forward", "head_logits", "init_cache",
           "init_params", "lm_head_weights", "precompute_cross_cache",
           "ssm"]
