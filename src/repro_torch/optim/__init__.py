"""Optimizers with named slots (SGD, Adam and FTRL ported so far)."""

from repro_torch.optim.optimizers import (FTRL, SGD, Adam, Optimizer,
                                          get_optimizer)

__all__ = ["Adam", "FTRL", "Optimizer", "SGD", "get_optimizer"]
