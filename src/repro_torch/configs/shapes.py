"""The four assigned input shapes, plus applicability rules per
architecture — the port's own copy of the reference's
``configs/shapes.py``."""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

SHAPES: dict[str, InputShape] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


def applicable(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """Whether (arch, shape) is a valid dry-run pair, with a reason for skips.

    Rules from the assignment:
      - decode shapes lower serve_step; encoder-only archs have no decode.
      - long_500k needs sub-quadratic attention: run for SSM / hybrid /
        sliding-window archs only.
    """
    if shape.kind == "decode":
        if not cfg.supports_decode:
            return False, "encoder-only architecture has no decode step"
        if shape.name == "long_500k" and not cfg.supports_long_context:
            return False, (
                "pure full-attention stack: 524k-token decode requires "
                "sub-quadratic attention (see DESIGN.md shape skips)"
            )
    return True, ""
