"""The kernels' PyTorch operators, under the `cosyvoice` namespace.

`define` registers one operator from its schema (no argument is mutated:
no `(a!)` in it): its plain version as the CPU kernel, the launch of the
hand-written kernel as the CUDA kernel (the dispatcher picks between them
by the tensors' device), and a fake implementation that gives the output's
shape and dtype, so torch.export traces through the operator and
an exported program calls it.  The definition is the plain
`torch.library.Library` form: `torch.library.custom_op` adds a Python
autograd layer to every call, which the host-bound flow stage pays ~2,000
times a request; the
operators have no backward, and their wrappers route a call that needs a
graph away from them (build.needs_autograd).
"""
from __future__ import annotations

from typing import Callable

import torch

LIB = torch.library.Library("cosyvoice", "DEF")


def define(schema: str, cpu: Callable, cuda: Callable, fake: Callable):
    """cosyvoice::<name> from `schema` -> its OpOverload (the call with the
    least dispatch)."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"cosyvoice::{name}", fake, lib=LIB)
    return getattr(torch.ops.cosyvoice, name).default
