"""Optimizers with named slots."""

from repro_torch.optim.optimizers import (FTRL, SGD, Adafactor, Adagrad, Adam,
                                          Momentum, Optimizer, get_optimizer)

__all__ = ["Adafactor", "Adagrad", "Adam", "FTRL", "Momentum", "Optimizer",
           "SGD", "get_optimizer"]
