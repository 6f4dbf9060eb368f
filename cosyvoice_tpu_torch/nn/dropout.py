"""Dropout whose masks come from an explicit torch.Generator.

The JAX package draws each dropout mask from the step's "dropout" PRNG key
when a training forward passes `deterministic=False`.  The port drops where
both hold: the module is in train() mode and a `dropout_generator` block is
open (train/step.py opens one a step, on the executor's generator); the
masks come from that generator.  Elsewhere dropout is the identity: the
inference paths leave some modules in train() mode (a fresh nn.Module is),
and they open no block.  As flax's Dropout, a kept value is divided by the
keep rate.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch
import torch.nn as nn

_state = threading.local()


@contextmanager
def dropout_generator(gen: torch.Generator):
    """Draw every dropout mask inside the block from `gen`."""
    prev = getattr(_state, "gen", None)
    _state.gen = gen
    try:
        yield gen
    finally:
        _state.gen = prev


def dropout(x: torch.Tensor, rate: float, training: bool) -> torch.Tensor:
    gen = getattr(_state, "gen", None)
    if not training or rate <= 0.0 or gen is None:
        return x
    keep = torch.rand(x.shape, generator=gen, device=gen.device) < 1.0 - rate
    return torch.where(keep.to(x.device), x / (1.0 - rate), torch.zeros_like(x))


class Dropout(nn.Module):
    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(x, self.rate, self.training)


def training_step() -> bool:
    """Whether a dropout_generator block is open (a training forward)."""
    return getattr(_state, "gen", None) is not None
