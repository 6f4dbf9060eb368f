"""Learning-rate schedules and the optimizer.  Port of
cosyvoice_tpu/train/optim.py, which builds them from optax.

The optimizer keeps optax's semantics, not torch.optim's:
  * adam / adamw are optax's (`scale_by_adam` with eps outside the square
    root, bias correction at the inner count, adamw's decay added to the
    update before the learning rate, every step a separate `count`);
  * `clip_by_global_norm` scales by max_norm / g_norm only when g_norm >=
    max_norm, with no epsilon;
  * `apply_if_finite` skips an update whose gradients hold a NaN or an inf
    and leaves the inner state, the schedule's count included, as it was;
  * `multi_steps` (optax.MultiSteps) keeps a running mean of k
    micro-gradients and applies the inner optimizer to it on the k-th;
    as in optax, a non-finite micro-gradient stays in the mean (its reset
    multiplies by zero), so every later apply is skipped;
  * the schedule is read at the count of applied inner updates, not at the
    executor's step.
A transform is a pair of functions over dicts of tensors keyed by parameter
name: `init(params) -> state` and `update(grads, state, params) ->
(updates or None, state)`, None meaning no change this step.  States are
dicts of tensors and ints, so torch.save writes them; an update may write
the state it is given in place (the caller keeps only the one returned).
The arithmetic runs on torch._foreach_* ops over all tensors at once, in
optax's order of operations (a model has hundreds of parameter tensors,
and one launch a tensor an op made the update host-bound).

Under tensor parallelism the gradients come as a `ShardedTree`: the global
norm sums the squares of the model-sharded leaves over the model group and
counts each replicated leaf once, and the finite check is one vote of the
group, so every rank clips and skips alike.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from cosyvoice_tpu_torch.parallel.collectives import all_reduce_

Schedule = Callable[[int], torch.Tensor]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def warmup_lr(peak_lr: float, warmup_steps: int = 25000) -> Schedule:
    """wenet's WarmupLR: lr * warmup^0.5 * min(s^-0.5, s * warmup^-1.5) at
    the 1-based step s."""
    def schedule(step):
        s = torch.clamp(_f32(step) + 1.0, min=1.0)
        return peak_lr * warmup_steps ** 0.5 * torch.minimum(
            s ** -0.5, s * warmup_steps ** -1.5)

    return schedule


def constant_lr(lr: float, warmup_steps: int = 0) -> Schedule:
    def schedule(step):
        if warmup_steps <= 0:
            return _f32(lr)
        return lr * torch.clamp((_f32(step) + 1.0) / warmup_steps, max=1.0)

    return schedule


def noam_hold_annealing(peak_lr: float, warmup_steps: int, hold_steps: int,
                        decay_rate: float = 0.5, min_lr: float = 0.0) -> Schedule:
    """NeMo's NoamHoldAnnealing: linear warmup, hold, then peak * warmup^d /
    (s - hold)^d, floored at min_lr."""
    hold_total = warmup_steps + hold_steps

    def schedule(step):
        s = _f32(step) + 1.0
        warm = peak_lr * torch.clamp(s / max(warmup_steps, 1), max=1.0)
        t_wd = max(1.0, warmup_steps ** decay_rate)
        t_hd = torch.clamp((s - hold_steps) ** decay_rate, min=1.0)
        decay = torch.clamp(peak_lr * t_wd / t_hd, min=min_lr)
        return torch.where(s <= warmup_steps, warm,
                           torch.where(s <= hold_total, _f32(peak_lr), decay))

    return schedule


def cosine_annealing(peak_lr: float, max_steps: int, warmup_steps: int = 0,
                     min_lr: float = 0.0) -> Schedule:
    """NeMo's CosineAnnealing: linear warmup peak * (s + 1) / (warmup + 1),
    then a cosine from peak to min_lr over max_steps - warmup_steps."""
    def schedule(step):
        s = _f32(step)
        warm = peak_lr * (s + 1.0) / (warmup_steps + 1.0)
        frac = torch.clamp((s - warmup_steps) / max(max_steps - warmup_steps, 1), 0.0, 1.0)
        mult = 0.5 * (1.0 + torch.cos(math.pi * frac))
        decay = (peak_lr - min_lr) * mult + min_lr
        return torch.where(s < warmup_steps, warm, decay)

    return schedule


SCHEDULERS = {
    "warmuplr": warmup_lr,
    "constantlr": constant_lr,
    "NoamHoldAnnealing": noam_hold_annealing,
    "CosineAnnealing": cosine_annealing,
}


class Transform(NamedTuple):
    init: Callable
    update: Callable


def _apply(fn, tree: dict, *others) -> dict:
    """fn over the tensor lists of `tree` and of each of `others` (dicts with
    tree's keys) in tree's key order -> a dict of fn's outputs."""
    keys = list(tree)
    return dict(zip(keys, fn([tree[k] for k in keys], *([o[k] for k in keys] for o in others))))


class ShardedTree(dict):
    """A gradient dict of a tensor-parallel model: `sharded` names the leaves
    each rank holds a block of, `group` is the model group."""

    def __init__(self, tree: dict, sharded: set, group):
        super().__init__(tree)
        self.sharded, self.group = sharded, group


def _like(tree: dict, other: dict) -> dict:
    """`other` with `tree`'s sharding, where tree has one."""
    if isinstance(tree, ShardedTree):
        return ShardedTree(other, tree.sharded, tree.group)
    return other


def _sum_squares(tensors: list) -> torch.Tensor:
    if not tensors:
        return torch.zeros(())
    return torch.stack(torch._foreach_norm([t.float() for t in tensors])).square().sum()


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (fp32), as optax's; of a
    ShardedTree, over the whole model."""
    if not tree:
        return torch.zeros(())
    if not isinstance(tree, ShardedTree):
        return torch.sqrt(_sum_squares(list(tree.values())))
    dev = next(iter(tree.values())).device
    sharded = _sum_squares([v for k, v in tree.items() if k in tree.sharded]).to(dev)
    rep = _sum_squares([v for k, v in tree.items() if k not in tree.sharded]).to(dev)
    return torch.sqrt(all_reduce_(sharded, tree.group) + rep)


def clip_by_global_norm(max_norm: float) -> Transform:
    def update(grads, state, params=None):
        g_norm = float(global_norm(grads))
        if g_norm < max_norm:
            return grads, state
        return _apply(lambda g: torch._foreach_mul(torch._foreach_div(g, g_norm), max_norm),
                      grads), state

    return Transform(lambda params: {}, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Transform:
    def init(params):
        return {"count": 0, "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(grads, state, params=None):
        count = state["count"] + 1
        bc1 = float(1.0 - _f32(b1) ** count)
        bc2 = float(1.0 - _f32(b2) ** count)
        keys = list(grads)
        g = [grads[k] for k in keys]
        mu, nu = [state["mu"][k] for k in keys], [state["nu"][k] for k in keys]
        # (1 - b) * g + b * m, written into the moments
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2))
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        out = torch._foreach_div(mu, bc1)
        torch._foreach_div_(out, den)
        return dict(zip(keys, out)), {"count": count, "mu": dict(zip(keys, mu)),
                                      "nu": dict(zip(keys, nu))}

    return Transform(init, update)


def add_decayed_weights(weight_decay: float) -> Transform:
    def update(updates, state, params):
        return _apply(lambda u, p: torch._foreach_add(u, torch._foreach_mul(p, weight_decay)),
                      updates, params), state

    return Transform(lambda params: {}, update)


def scale_by_learning_rate(schedule: Schedule) -> Transform:
    """updates * -schedule(count), count advancing once an update."""
    def update(updates, state, params=None):
        step_size = float(-schedule(state["count"]))
        return (_apply(lambda u: torch._foreach_mul(u, step_size), updates),
                {"count": state["count"] + 1})

    return Transform(lambda params: {"count": 0}, update)


def chain(*transforms: Transform) -> Transform:
    def init(params):
        return [t.init(params) for t in transforms]

    def update(updates, state, params=None):
        new = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new.append(s)
        return updates, new

    return Transform(init, update)


def _all_finite(tree: dict) -> bool:
    """No NaN or inf in any tensor: each one's max |x| (NaN propagates); of
    a ShardedTree, on every rank of its group."""
    top = torch._foreach_norm(list(tree.values()), float("inf"))
    finite = torch.isfinite(torch.stack(top)).all()
    if isinstance(tree, ShardedTree):
        bad = all_reduce_((~finite).float().reshape(1), tree.group)
        return bool(bad.item() == 0)
    return bool(finite)


def apply_if_finite(inner: Transform, max_consecutive_errors: int) -> Transform:
    def init(params):
        return {"notfinite_count": 0, "last_finite": True, "total_notfinite": 0,
                "inner_state": inner.init(params)}

    def update(grads, state, params=None):
        finite = _all_finite(grads)
        bad = 0 if finite else state["notfinite_count"] + 1
        new = {"notfinite_count": bad, "last_finite": finite,
               "total_notfinite": state["total_notfinite"] + (0 if finite else 1),
               "inner_state": state["inner_state"]}
        if not finite and bad <= max_consecutive_errors:
            return None, new
        updates, new["inner_state"] = inner.update(grads, state["inner_state"], params)
        return updates, new

    return Transform(init, update)


def multi_steps(inner: Transform, every_k: int) -> Transform:
    """optax.MultiSteps(inner, every_k) with use_grad_mean: a Welford mean of
    the micro-gradients; the inner update (and the inner state) only on the
    every_k-th."""
    def init(params):
        return {"mini_step": 0, "gradient_step": 0, "inner_opt_state": inner.init(params),
                "acc_grads": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(grads, state, params=None):
        n = state["mini_step"]
        acc = state["acc_grads"]
        keys = list(acc)
        a = [acc[k] for k in keys]
        delta = torch._foreach_sub([grads[k] for k in keys], a)
        torch._foreach_div_(delta, n + 1)
        torch._foreach_add_(a, delta)
        emit = n == every_k - 1
        new = {"mini_step": (n + 1) % every_k,
               "gradient_step": state["gradient_step"] + int(emit),
               "inner_opt_state": state["inner_opt_state"], "acc_grads": acc}
        if not emit:
            return None, new
        updates, new["inner_opt_state"] = inner.update(_like(grads, acc),
                                                       state["inner_opt_state"], params)
        torch._foreach_mul_(a, 0)     # as optax's reset: a NaN stays
        return updates, new

    return Transform(init, update)


def make_optimizer(optim: str = "adam", lr: float = 1e-3, scheduler: str = "warmuplr",
                   scheduler_kwargs: Optional[dict] = None, grad_clip: float = 5.0,
                   accum_grad: int = 1, weight_decay: float = 0.0
                   ) -> tuple[Transform, Schedule]:
    """clip_by_global_norm(grad_clip) -> adam | adamw, under
    apply_if_finite, under multi_steps when accum_grad > 1 (the JAX
    package's optax chain)."""
    sched = SCHEDULERS[scheduler](lr, **(scheduler_kwargs or {}))
    if optim == "adam":
        opt = chain(scale_by_adam(), scale_by_learning_rate(sched))
    elif optim == "adamw":
        opt = chain(scale_by_adam(), add_decayed_weights(weight_decay),
                    scale_by_learning_rate(sched))
    else:
        raise ValueError(f"unknown optimizer {optim}")
    tx = apply_if_finite(chain(clip_by_global_norm(grad_clip), opt),
                         max_consecutive_errors=1000000)
    if accum_grad > 1:
        tx = multi_steps(tx, accum_grad)
    return tx, sched


def applied_updates(state) -> int:
    """The count of updates the inner optimizer has applied (the count its
    schedule is read at) in a make_optimizer state."""
    if "mini_step" in state:
        state = state["inner_opt_state"]
    return state["inner_state"][1][-1]["count"]
