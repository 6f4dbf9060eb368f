"""Checkpoint save, resume and averaging.  Port of
cosyvoice_tpu/train/checkpoint.py.

The JAX package writes the TrainState with orbax, one directory a step; the
port writes `<ckpt_dir>/<step>/state.pt` with torch.save: the trainable
parameters (a state dict, on the CPU), the optimizer state and the step.
Both write the `info_<step>.json` sidecar beside the step directories.

A tensor-parallel state (its `tp` and `shard_dims`, train/step.py) saves in
the one-card format: its shards, and those of the optimizer state, are
gathered, and global rank 0 writes, so from_pretrained, average_model,
ckpt_resave and a one-card resume read it unchanged; restoring a full
checkpoint onto a mesh keeps each rank's block.  Every rank calls both.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

import torch

from cosyvoice_tpu_torch.parallel.collectives import gather_dim
from cosyvoice_tpu_torch.parallel.distributed import rank_and_world
from cosyvoice_tpu_torch.train.step import TrainState

STATE_FILE = "state.pt"


def _to(tree, device):
    """Every tensor of a nested dict / list state moved to `device`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


def _map_sharded(tree, dims: dict, fn):
    """fn(tensor, dim) over every tensor of a nested state that sits under a
    sharded parameter's name (the params, adam's moments, accumulated
    gradients); everything else as it is."""
    if isinstance(tree, dict):
        return {k: (fn(v, dims[k]) if k in dims and isinstance(v, torch.Tensor)
                    else _map_sharded(v, dims, fn)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_sharded(v, dims, fn) for v in tree)
    return tree


def _block(t: torch.Tensor, dim: int, tp) -> torch.Tensor:
    n = t.shape[dim] // tp.size
    return t.narrow(dim, tp.rank * n, n)


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int,
                    info: Optional[dict] = None) -> None:
    dims, tp = state.shard_dims, state.tp
    params = {k: p.detach() for k, p in state.params.items()}
    opt_state = state.opt_state
    if dims:
        gather = lambda t, d: gather_dim(t, d, tp.rank, tp.size, tp.group)  # noqa: E731
        params = _map_sharded(params, dims, gather)
        opt_state = _map_sharded(opt_state, dims, gather)
    if rank_and_world()[0] != 0:
        return
    d = os.path.join(ckpt_dir, str(step))
    os.makedirs(d, exist_ok=True)
    params = {k: p.cpu() for k, p in params.items()}
    tmp = os.path.join(d, STATE_FILE + ".tmp")
    torch.save({"params": params, "opt_state": _to(opt_state, "cpu"),
                "step": int(state.step)}, tmp)
    os.replace(tmp, os.path.join(d, STATE_FILE))
    meta = dict(info or {}, step=step, save_time=time.strftime("%d/%m/%Y %H:%M:%S"))
    with open(os.path.join(ckpt_dir, f"info_{step}.json"), "w") as f:
        json.dump(meta, f, indent=2)


def all_steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(n) for n in os.listdir(ckpt_dir)
                  if n.isdigit() and os.path.exists(os.path.join(ckpt_dir, n, STATE_FILE)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _load(ckpt_dir: str, step: int) -> dict:
    """Memory-mapped: only the tensors a caller touches are read (averaging
    reads the parameters, not the optimizer's moments)."""
    return torch.load(os.path.join(ckpt_dir, str(step), STATE_FILE), map_location="cpu",
                      weights_only=True, mmap=True)


def restore_checkpoint(ckpt_dir: str, state: TrainState,
                       step: Optional[int] = None) -> tuple[TrainState, int]:
    """Load step `step` (the latest by default) into state's model and
    optimizer state, on the model's device -> (state, step).  A
    tensor-parallel model takes its blocks of the saved whole tensors."""
    step = latest_step(ckpt_dir) if step is None else step
    assert step is not None, f"no checkpoint under {ckpt_dir}"
    saved = _load(ckpt_dir, step)
    params = state.params
    if set(saved["params"]) != set(params):
        raise KeyError(f"checkpoint parameters differ from the model's: "
                       f"{sorted(set(saved['params']) ^ set(params))[:8]}")
    device = next(iter(params.values())).device
    dims, tp = state.shard_dims, state.tp
    saved_params, opt_state = saved["params"], saved["opt_state"]
    if dims:
        saved_params = _map_sharded(saved_params, dims, lambda t, d: _block(t, d, tp))
        opt_state = _map_sharded(opt_state, dims, lambda t, d: _block(t, d, tp).clone())
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(saved_params[k])
    state.opt_state = _to(opt_state, device)
    state.step = int(saved["step"])
    return state, step


def average_checkpoints(ckpt_dir: str, last_n: int = 5) -> dict:
    """The mean of the newest `last_n` checkpoints' parameters, accumulated
    in float64, returned as float32 (bin/average_model.py)."""
    steps = all_steps(ckpt_dir)[-last_n:]
    assert steps, f"no checkpoints under {ckpt_dir}"
    acc = None
    for s in steps:
        p = {k: v.double() for k, v in _load(ckpt_dir, s)["params"].items()}
        acc = p if acc is None else {k: acc[k] + v for k, v in p.items()}
    return {k: (v / len(steps)).float() for k, v in acc.items()}
