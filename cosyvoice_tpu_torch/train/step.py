"""The train step.  Port of cosyvoice_tpu/train/step.py.

One step is the JAX package's jitted step in eager PyTorch: the forward in
train() mode under the step's generator (dropout masks and the flow's
draws), the loss in fp32, its gradients (torch.autograd.grad, every
trainable parameter; one that gets none takes zeros, as jax.grad gives),
then the optimizer (train/optim.py: clip, adam / adamw, the non-finite skip,
accumulation) and the update applied in place.  The metrics add `loss` and
`grad_norm`, the global norm of the raw gradients.

On a mesh (parallel/mesh.py) each rank runs its rows of the global batch
(`shard_batch`) on its shard of the model.  The JAX step is one program over
the global batch, whose losses divide by the global count (of valid targets,
or of mel frames x channels); so each loss function reports the count it
divided by as the metric `denom`, the step sums it over the data axis and
scales the rank's loss by local / global, and the gradients are summed over
the data axis.  A mean of the ranks' means would be wrong whenever the ranks
hold different counts.  Under tensor parallelism the gradient norm sums the
sharded leaves' squares over the model axis (train/optim.ShardedTree).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from cosyvoice_tpu_torch.nn.dropout import dropout_generator
from cosyvoice_tpu_torch.parallel.collectives import ModelGroup, all_reduce_
from cosyvoice_tpu_torch.parallel.mesh import (batch_sharding, rank_generator,
                                               shard_dims)
from cosyvoice_tpu_torch.train.optim import ShardedTree, Transform, global_norm

ROWS = "_rows"      # shard_batch's (first row, global rows) of a rank's batch


@dataclass
class TrainState:
    """The model (its trainable parameters are the state's params), the
    optimizer state and the count of steps taken.  A tensor-parallel model
    (parallel/mesh.shard_params) adds its model group `tp` and `shard_dims`,
    {param: the dim its rank's block splits}, which the step's gradient norm
    and the checkpoint read."""

    model: torch.nn.Module
    opt_state: Any
    step: int = 0
    tp: Optional[ModelGroup] = None
    shard_dims: dict = field(default_factory=dict)

    @property
    def params(self) -> dict:
        return trainable_params(self.model)


def trainable_params(model: torch.nn.Module) -> dict:
    return {k: p for k, p in model.named_parameters() if p.requires_grad}


def make_train_state(model: torch.nn.Module, tx: Transform, mesh=None,
                     specs: Optional[dict] = None) -> TrainState:
    """The state of a model, sharded over `mesh` by `specs` (shard_params's)
    when both are given."""
    params = trainable_params(model)
    tp = mesh.tp if mesh is not None else None
    dims = {k: d for k, d in shard_dims(specs or {}).items() if k in params} if tp else {}
    return TrainState(model, tx.init({k: p.detach() for k, p in params.items()}), 0,
                      tp if dims else None, dims)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The step's generator: a function of (seed, step) alone, the
    counterpart of fold_in(PRNGKey(seed), step)."""
    return torch.Generator(device=device).manual_seed((seed << 32) + step)


def all_reduce_tree_(tensors: list, group) -> None:
    """Sum a list of same-dtype tensors over `group` in place, through one
    flat buffer."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_(flat, group)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


def make_train_step(loss_fn: Callable, tx: Transform, mesh=None):
    """loss_fn(model, batch, gen) -> (loss, metrics).  Returns step(state,
    batch, gen) -> (state, metrics); the state's parameters and optimizer
    state are updated in place.  On a mesh with data > 1, loss_fn's metrics
    must hold `denom` (the count its loss divides by): a loss that is a
    batch statistic (vicreg, the GAN losses) has none and raises.  The
    metrics come back as the whole batch's on every rank."""
    data = mesh.data if mesh is not None else 1

    def step(state: TrainState, batch: dict, gen: torch.Generator):
        model = state.model
        params = trainable_params(model)
        model.train()
        if data > 1 and ROWS not in batch:
            gen = rank_generator(gen, mesh.data_rank)
        with dropout_generator(gen):
            loss, metrics = loss_fn(model, batch, gen)
        loss = loss.float()
        metrics = dict(metrics)
        denom = metrics.pop("denom", None)
        if data > 1:
            if denom is None:
                raise NotImplementedError(
                    "a data-parallel step needs the loss's denominator (metric 'denom'): "
                    "a loss that is a batch statistic (vicreg, the GAN losses) has no "
                    "rank's share of the global loss, and the JAX package trains none "
                    "on a mesh")
            denom = denom.detach().float().reshape(())
            share = denom / all_reduce_(denom.clone(), mesh.data_group).clamp_min(1)
            loss = loss * share
            metrics = {k: v.detach().float() * share for k, v in metrics.items()}
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        loss = loss.detach()
        if data > 1:
            all_reduce_tree_(list(grads.values()), mesh.data_group)
            vals = torch.stack([loss] + list(metrics.values()))
            all_reduce_(vals, mesh.data_group)
            loss, metrics = vals[0], dict(zip(metrics, vals[1:]))
        if state.shard_dims:
            grads = ShardedTree(grads, set(state.shard_dims), state.tp.group)
        with torch.no_grad():
            plain = {k: p.detach() for k, p in params.items()}
            updates, state.opt_state = tx.update(grads, state.opt_state, plain)
            if updates is not None:
                torch._foreach_add_(list(plain.values()), [updates[k] for k in plain])
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(loss=loss, grad_norm=global_norm(grads))
        state.step += 1
        return state, metrics

    return step


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's rows of a global batch (every array's leading dim split
    over the data axis, as the JAX package's P("data")), with ROWS = (first
    row, global rows) so that the flow draws its rows of the global batch's
    draws.  Other values pass through."""
    n = next(len(v) for v in batch.values()
             if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim)
    rows = batch_sharding(mesh, n)
    out = {k: v[rows] if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim else v
           for k, v in batch.items()}
    out[ROWS] = (rows.start, n)
    return out


def to_device(batch: dict, device) -> dict:
    """A host batch of numpy arrays (or tensors) -> tensors on `device`:
    integers as int64, floats as float32; other values pass through."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v)
        if isinstance(v, torch.Tensor):
            v = v.to(device=device, dtype=torch.long if not v.is_floating_point()
                     else torch.float32)
        out[k] = v
    return out


# --------------------------------------------------------------------------
# per-model loss functions
# --------------------------------------------------------------------------

def llm_loss_fn(model, batch: dict, gen: Optional[torch.Generator] = None):
    out = model(batch["text_token"], batch["text_token_len"], batch["speech_token"],
                batch["speech_token_len"])
    return out["loss"], {"acc": out["acc"], "denom": out["denom"]}


def transformer_lm_loss_fn(model, batch: dict, gen: Optional[torch.Generator] = None):
    """The v1 LM's loss without dropout, as the JAX package's train CLI runs
    it (its loss calls the module with deterministic=True by default)."""
    with dropout_generator(None):
        out = model(batch["text_token"], batch["text_token_len"], batch["speech_token"],
                    batch["speech_token_len"], batch["embedding"])
    return out["loss"], {"acc": out["acc"], "denom": out["denom"]}


def phoneme_llm_loss_fn(model, batch: dict, gen: Optional[torch.Generator] = None):
    """The Qwen2 phoneme LMs' loss, in the training forward's mode (the
    JAX CLI's phoneme branch runs it with deterministic=False)."""
    out = model(batch["text_token"], batch["text_token_len"], batch["pho_token"],
                batch["pho_token_len"], batch["speech_token"], batch["speech_token_len"],
                batch["embedding"], gen=gen)
    return out["loss"], {"acc": out["acc"], "denom": out["denom"]}


def flow_loss_fn(model, batch: dict, gen: Optional[torch.Generator] = None):
    out = model(batch["speech_token"], batch["speech_token_len"], batch["speech_feat"],
                batch["speech_feat_len"], batch["embedding"], gen=gen, rows=batch.get(ROWS))
    return out["loss"], {"denom": out["denom"]}
