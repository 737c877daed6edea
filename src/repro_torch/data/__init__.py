"""Data streams of the port (``lm_batches`` so far)."""

from repro_torch.data.streams import lm_batches

__all__ = ["lm_batches"]
