"""The collectives of tensor parallelism, with their backward, and the two
vocabulary-parallel modules.  Port-only: the JAX package gets these from
GSPMD inside one program; here each rank is a process and the collectives
are explicit (Megatron-style column- and row-parallel projections).

Only all-reduce (sum) is used: gloo offers little else over CUDA tensors,
and an all-gather is an all-reduce into a zeroed buffer, which is exact.
Partial sums travel in fp32 (a bf16 activation is cast up before the
all-reduce and back after), so the row-parallel sum of a bf16 model rounds
once, as the one-card product does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from cosyvoice_tpu_torch.nn.dense import Dense


@dataclass(frozen=True, eq=False)
class ModelGroup:
    """One rank's view of its tensor-parallel group: the process group, its
    size and this rank's index in it."""

    group: object
    size: int
    rank: int


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` over `group` in place (half-width floats through fp32); None or
    a group of one is a no-op."""
    if group is None or dist.get_world_size(group) == 1:
        return t
    if t.is_floating_point() and t.element_size() < 4:
        buf = t.float()
        dist.all_reduce(buf, group=group)
        t.copy_(buf)
    else:
        dist.all_reduce(t, group=group)
    return t


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce backward: the input of a column-parallel
    projection (each rank's gradient is a partial sum)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.tp.group), None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce forward, identity backward: the output of a row-parallel
    projection or of a vocabulary-parallel lookup."""

    @staticmethod
    def forward(ctx, x, tp):
        return all_reduce_(x.clone(), tp.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """Concatenate each rank's last-dim slice (gather_dim); the backward
    keeps this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.n = tp, x.shape[-1]
        return gather_dim(x, -1, tp.rank, tp.size, tp.group)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.tp.rank, ctx.n
        return g[..., r * n:(r + 1) * n].contiguous(), None


def copy_to_model(x: torch.Tensor, tp: Optional[ModelGroup]) -> torch.Tensor:
    return x if tp is None else _CopyToModel.apply(x, tp)


def reduce_from_model(x: torch.Tensor, tp: Optional[ModelGroup]) -> torch.Tensor:
    return x if tp is None else _ReduceFromModel.apply(x, tp)


def gather_from_model(x: torch.Tensor, tp: Optional[ModelGroup]) -> torch.Tensor:
    return x if tp is None else _GatherFromModel.apply(x, tp)


def gather_dim(t: torch.Tensor, dim: int, index: int, size: int, group) -> torch.Tensor:
    """Block `index` of `size` equal blocks along `dim`, from each rank of
    `group` -> the whole tensor on every rank: an all-reduce of zero-filled
    buffers (exact; no gradient)."""
    n = t.shape[dim]
    shape = list(t.shape)
    shape[dim] = n * size
    full = t.new_zeros(shape)
    full.narrow(dim, index * n, n).copy_(t)
    return all_reduce_(full, group)


class ParallelEmbedding(nn.Embedding):
    """nn.Embedding whose table may hold one rank's block of rows: with `tp`
    set, ids outside the block look up zeros and the ranks' lookups are
    summed.  `num_embeddings` stays the whole vocabulary."""

    tp: Optional[ModelGroup] = None

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return super().forward(ids)
        n = self.weight.shape[0]
        local = ids - self.tp.rank * n
        ok = (local >= 0) & (local < n)
        out = F.embedding(torch.where(ok, local, torch.zeros_like(local)), self.weight)
        out = torch.where(ok[..., None], out, torch.zeros_like(out))
        return reduce_from_model(out, self.tp)


class ParallelDense(Dense):
    """Dense whose weight may hold one rank's block of output columns: with
    `tp` set, the ranks' outputs are gathered, so every rank sees the whole
    output (the LM head's logits: every rank samples the same token)."""

    tp: Optional[ModelGroup] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return super().forward(x)
        return gather_from_model(super().forward(copy_to_model(x, self.tp)), self.tp)
