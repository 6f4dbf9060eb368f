"""The train step.  Port of cosyvoice_tpu/train/step.py.

One step is the JAX package's jitted step in eager PyTorch: the forward in
train() mode under the step's generator (dropout masks and the flow's
draws), the loss in fp32, its gradients (torch.autograd.grad, every
trainable parameter; one that gets none takes zeros, as jax.grad gives),
then the optimizer (train/optim.py: clip, adam / adamw, the non-finite skip,
accumulation) and the update applied in place.  The metrics add `loss` and
`grad_norm`, the global norm of the raw gradients.

One card: a `mesh` raises (more than one card is ROADMAP Queue 1 item 11),
and the JAX package's `shard_batch` becomes `to_device`, a move to the card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from cosyvoice_tpu_torch.nn.dropout import dropout_generator
from cosyvoice_tpu_torch.train.optim import Transform, global_norm


@dataclass
class TrainState:
    """The model (its trainable parameters are the state's params), the
    optimizer state and the count of steps taken."""

    model: torch.nn.Module
    opt_state: Any
    step: int = 0

    @property
    def params(self) -> dict:
        return trainable_params(self.model)


def trainable_params(model: torch.nn.Module) -> dict:
    return {k: p for k, p in model.named_parameters() if p.requires_grad}


def make_train_state(model: torch.nn.Module, tx: Transform) -> TrainState:
    return TrainState(model, tx.init({k: p.detach() for k, p in
                                      trainable_params(model).items()}), 0)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The step's generator: a function of (seed, step) alone, the
    counterpart of fold_in(PRNGKey(seed), step)."""
    return torch.Generator(device=device).manual_seed((seed << 32) + step)


def make_train_step(loss_fn: Callable, tx: Transform, mesh=None):
    """loss_fn(model, batch, gen) -> (loss, metrics).  Returns step(state,
    batch, gen) -> (state, metrics); the state's parameters and optimizer
    state are updated in place."""
    if mesh is not None:
        raise NotImplementedError("training on more than one card (a mesh) is ROADMAP "
                                  "Queue 1 item 11")

    def step(state: TrainState, batch: dict, gen: torch.Generator):
        model = state.model
        params = trainable_params(model)
        model.train()
        with dropout_generator(gen):
            loss, metrics = loss_fn(model, batch, gen)
        loss = loss.float()
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        with torch.no_grad():
            plain = {k: p.detach() for k, p in params.items()}
            updates, state.opt_state = tx.update(grads, state.opt_state, plain)
            if updates is not None:
                torch._foreach_add_(list(plain.values()), [updates[k] for k in plain])
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(loss=loss.detach(), grad_norm=global_norm(grads))
        state.step += 1
        return state, metrics

    return step


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
    return out["loss"], {"acc": out["acc"]}


def transformer_lm_loss_fn(model, batch: dict, gen: Optional[torch.Generator] = None):
    """The v1 LM's loss without dropout, as the JAX package's train CLI runs
    it (its loss calls the module with deterministic=True by default)."""
    with dropout_generator(None):
        out = model(batch["text_token"], batch["text_token_len"], batch["speech_token"],
                    batch["speech_token_len"], batch["embedding"])
    return out["loss"], {"acc": out["acc"]}


def phoneme_llm_loss_fn(model, batch: dict, gen: Optional[torch.Generator] = None):
    """The Qwen2 phoneme LMs' loss, in the training forward's mode (the
    JAX CLI's phoneme branch runs it with deterministic=False)."""
    out = model(batch["text_token"], batch["text_token_len"], batch["pho_token"],
                batch["pho_token_len"], batch["speech_token"], batch["speech_token_len"],
                batch["embedding"], gen=gen)
    return out["loss"], {"acc": out["acc"]}


def flow_loss_fn(model, batch: dict, gen: Optional[torch.Generator] = None):
    out = model(batch["speech_token"], batch["speech_token_len"], batch["speech_feat"],
                batch["speech_feat_len"], batch["embedding"], gen=gen)
    return out["loss"], {}
