"""Optimizers with named slots (FTRL ported so far)."""

from repro_torch.optim.optimizers import FTRL, Optimizer, get_optimizer

__all__ = ["FTRL", "Optimizer", "get_optimizer"]
