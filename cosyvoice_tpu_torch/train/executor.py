"""Training executor: the epoch loop, periodic CV and checkpoints, metric
logging.  Port of cosyvoice_tpu/train/executor.py: `Executor`, and
`GanExecutor` for the vocoders (a discriminator step, then a generator
step, each batch).

Each step draws from its own generator, a function of (rng_seed, step)
alone (train/step.step_generator), so a resumed run repeats the draws an
unbroken one makes.  Metrics go to `metrics.jsonl` in the model directory
(one JSON object a line: tag, epoch, step and the values) and to the log.

More than one process: every rank votes before each step and all stop
when one runs out of data (`all_hosts_have_data`); rank 0 alone logs and
writes, and every rank takes part in a checkpoint (its tensor-parallel
shards are gathered); cv metrics are summed over the data axis.
"""
from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

import torch
import torch.distributed as dist

from cosyvoice_tpu_torch.nn.dropout import dropout_generator
from cosyvoice_tpu_torch.parallel.collectives import all_reduce_
from cosyvoice_tpu_torch.parallel.distributed import rank_and_world
from cosyvoice_tpu_torch.train.checkpoint import save_checkpoint
from cosyvoice_tpu_torch.train.step import TrainState, step_generator

# why GAN training stays on one process
GAN_ONE_PROCESS = ("the JAX CLI's GAN branch takes no mesh: it builds unsharded parameters "
                   "and moves each process's batch with jnp.asarray "
                   "(cosyvoice_tpu/bin/train.py:365-486), so each of its processes trains "
                   "its own copy and no gradient is exchanged; the port refuses rather than "
                   "copy that silent divergence")

logger = logging.getLogger(__name__)


def arrays_only(batch: dict) -> dict:
    """Drop non-array metadata (utterance ids, text strings)."""
    return {k: v for k, v in batch.items()
            if not isinstance(v, (str, bytes))
            and not (isinstance(v, list) and v and isinstance(v[0], str))}


def _vote_device() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def all_hosts_have_data(has_batch: bool) -> bool:
    """Every process stops together when one runs out of data (the next
    collective would hang): a sum of the ranks' "no batch" votes, which is
    their MIN of has_batch."""
    if rank_and_world()[1] == 1:
        return has_batch
    missing = torch.tensor([0.0 if has_batch else 1.0], device=_vote_device())
    return bool(all_reduce_(missing, dist.group.WORLD).item() == 0)


@dataclass
class Executor:
    train_step: Callable            # (state, batch, gen) -> (state, metrics)
    model_dir: str
    device: object = "cuda"         # where the step generators draw
    save_per_step: int = -1
    log_interval: int = 100
    rng_seed: int = 1986
    cv_step: Optional[Callable] = None  # (model, batch, gen) -> loss dict
    metrics_path: Optional[str] = None
    step: int = 0
    epoch: int = 0
    mesh: Optional[object] = None   # parallel/mesh.Mesh: cv sums over its data axis

    def __post_init__(self):
        self.writer = rank_and_world()[0] == 0
        if self.writer:
            os.makedirs(self.model_dir, exist_ok=True)
        self.metrics_path = self.metrics_path or os.path.join(self.model_dir,
                                                              "metrics.jsonl")

    def _log(self, tag: str, metrics: dict):
        if not self.writer:
            return
        rec = {"tag": tag, "epoch": self.epoch, "step": self.step,
               **{k: float(v) for k, v in metrics.items()}}
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if tag == "CV" or self.step % self.log_interval == 0:
            logger.info("%s %s", tag, rec)

    def train_one_epoch(self, state: TrainState, train_data: Iterable,
                        cv_data: Optional[Iterable] = None,
                        to_device: Callable = lambda b: b) -> TrainState:
        logger.info("Epoch %d begin", self.epoch)
        t0, n_since = time.time(), 0
        it = iter(train_data)
        while True:
            batch = next(it, None)
            if not all_hosts_have_data(batch is not None):
                break
            gen = step_generator(self.rng_seed, self.step, self.device)
            state, metrics = self.train_step(state, to_device(arrays_only(batch)), gen)
            self.step += 1
            n_since += 1
            if self.step % self.log_interval == 0:
                dt = (time.time() - t0) / max(n_since, 1)
                self._log("TRAIN", dict(metrics, sec_per_step=dt))
                t0, n_since = time.time(), 0
            if self.save_per_step > 0 and self.step % self.save_per_step == 0:
                if cv_data is not None:
                    self.cv(state, cv_data, to_device)
                save_checkpoint(self.model_dir, state, self.step, {"epoch": self.epoch})
        if cv_data is not None:
            self.cv(state, cv_data, to_device)
        save_checkpoint(self.model_dir, state, self.step,
                        {"epoch": self.epoch, "whole": True})
        self.epoch += 1
        return state

    @torch.no_grad()
    def cv(self, state: TrainState, cv_data: Iterable,
           to_device: Callable = lambda b: b) -> dict:
        """The example-weighted mean of cv_step's values over cv_data; batch
        i runs on the generator of (i, 0), as the JAX executor takes
        PRNGKey(i), in the training forward's mode.  On a mesh each data
        rank runs its own cv batches and the weighted sums are added over
        the data axis."""
        assert self.cv_step is not None
        tot, w = {}, 0
        for i, batch in enumerate(cv_data):
            n = len(batch.get("utts", [1]))
            gen = step_generator(i, 0, self.device)
            state.model.train()
            with dropout_generator(gen):
                out = self.cv_step(state.model, to_device(arrays_only(batch)), gen)
            out.pop("denom", None)
            for k, v in out.items():
                tot[k] = tot.get(k, 0.0) + float(v) * n
            w += n
        if self.mesh is not None and self.mesh.data > 1:
            keys = sorted(tot)
            sums = torch.tensor([w] + [tot[k] for k in keys], dtype=torch.float64,
                                device=_vote_device())
            all_reduce_(sums, self.mesh.data_group)
            w, tot = float(sums[0]), dict(zip(keys, sums[1:].tolist()))
        avg = {k: v / max(w, 1) for k, v in tot.items()}
        self._log("CV", avg)
        return avg


@dataclass
class GanExecutor(Executor):
    """Two-optimizer alternation: for each batch the discriminator step on
    the current generator, then the generator step on the updated
    discriminator, each with a generator of (rng_seed, step), so both
    steps draw alike.  The generator checkpoints to model_dir, the
    discriminator to model_dir + "_disc", every save_per_step steps and at
    the end of an epoch."""

    disc_step: Optional[Callable] = None   # (d_state, g_model, batch, gen)

    def train_one_epoch_gan(self, g_state: TrainState, d_state: TrainState,
                            train_data: Iterable, to_device: Callable = lambda b: b):
        if rank_and_world()[1] > 1:
            raise NotImplementedError(f"GAN training on more than one process: {GAN_ONE_PROCESS}")
        logger.info("Epoch %d begin (GAN)", self.epoch)
        t0, n_since = time.time(), 0
        it = iter(train_data)
        while True:
            batch = next(it, None)
            if not all_hosts_have_data(batch is not None):
                break
            b = to_device(arrays_only(batch))
            d_state, d_metrics = self.disc_step(
                d_state, g_state.model, b, step_generator(self.rng_seed, self.step, self.device))
            g_state, g_metrics = self.train_step(
                g_state, (d_state.model, b), step_generator(self.rng_seed, self.step, self.device))
            self.step += 1
            n_since += 1
            if self.step % self.log_interval == 0:
                dt = (time.time() - t0) / max(n_since, 1)
                self._log("TRAIN", {**{f"d_{k}": v for k, v in d_metrics.items()},
                                    **g_metrics, "sec_per_step": dt})
                t0, n_since = time.time(), 0
            if self.save_per_step > 0 and self.step % self.save_per_step == 0:
                save_checkpoint(self.model_dir, g_state, self.step, {"epoch": self.epoch})
                save_checkpoint(self.model_dir + "_disc", d_state, self.step)
        save_checkpoint(self.model_dir, g_state, self.step, {"epoch": self.epoch, "whole": True})
        save_checkpoint(self.model_dir + "_disc", d_state, self.step)
        self.epoch += 1
        return g_state, d_state
