"""LoRA finetuning as an overlay on a frozen model.

Port of cosyvoice_tpu/train/lora.py.  Each selected weight W gets a pair
(a [r, fan_in], b [fan_out, r]) and the model computes with W + (alpha /
r) * delta(b @ a); only the pairs train, and the base parameters are never
written.  `init_lora` draws a ~ N(0, init_std) and sets b = 0, so step 0
is the base model exactly.  The a and b arrays are the JAX package's, in
the same shapes: a flax kernel [in, out] takes a.T @ b.T, a torch
Linear.weight [out, in] takes b @ a; a flax conv kernel [k, in, out]
flattens k-major to fan_in = k * in, so a torch Conv1d weight [out, in, k]
takes (b @ a) reshaped to [out, k, in] and moved to [out, in, k].  A
weight-normed conv takes its delta on the direction `weight_v` (the JAX
package's `v`), its gain untouched.  Adapters go on Linear and Conv1d
weights (nn/dense.Dense, an unquantized models/qwen2.QDense,
nn/conv.Conv1d); a pattern that selects any other parameter of two or
more dimensions raises.

Patterns are regular expressions over the port's parameter names (`.`
joined), as the JAX package's are over '/'-joined flax paths: the recipes'
module names (`lora_conf.patterns`: q_proj / k_proj / v_proj / o_proj for
the Qwen2 body, linear_q / linear_k / linear_v / linear_out for a
conformer) become `target_pattern(names)`.

Training: `LoRAOverlay` is the module that the train state holds (its
parameters are the pairs, so the optimizer state and checkpoints cover
only them) and `lora_loss_fn(base, loss_fn, cfg)` runs a model loss over
the base with the merged weights (torch.func.functional_call; the base's
parameters are detached, and follow the overlay's train() / eval()).
`lora_state_dict` gives the `lora.npz` that bin/ckpt_resave.py
--lora_npz merges (`<name>.lora_A` / `<name>.lora_B`, the JAX package's
key form; a JAX-written file carries flax paths, which
convert.lora_overlay_from_jax maps to the port's names).

On a mesh (parallel/mesh.py) the base is sharded by the tensor-parallel
rules and `shard_overlay` gives each rank the slice of each pair whose
delta is its local weight's block: a column-parallel weight (output rows
sharded) takes its rows of b and the whole a, a row-parallel one (input
columns sharded) its columns of a and the whole b.  Each model rank then
holds a partial gradient of a whole factor, so the loss passes whole
factors through copy_to_model (identity forward, a sum over the model
group backward) and the step sees whole gradients.  Checkpoints and
`lora_state_dict` hold the whole factors, in the one-card format.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from cosyvoice_tpu_torch.models.qwen2 import QDense
from cosyvoice_tpu_torch.nn.conv import Conv1d
from cosyvoice_tpu_torch.parallel.collectives import copy_to_model, gather_dim
from cosyvoice_tpu_torch.parallel.mesh import sharded_dim


@dataclass(frozen=True)
class LoRAConfig:
    r: int = 8
    alpha: float = 16
    target_patterns: Sequence[str] = (r".*\.(q_proj|k_proj|v_proj|o_proj)\.weight$",)
    init_std: float = 0.01

    @property
    def scale(self) -> float:
        return self.alpha / self.r


def target_pattern(names: Sequence[str]) -> str:
    """The recipe's module names -> the pattern over their weights."""
    return rf".*\.({'|'.join(names)})\.weight$"


def _matches(name: str, cfg: LoRAConfig) -> bool:
    return any(re.match(p, name) for p in cfg.target_patterns)


def _check_target(model: nn.Module, name: str) -> None:
    owner, leaf = name.rsplit(".", 1) if "." in name else ("", name)
    mod = model.get_submodule(owner)
    linear = isinstance(mod, nn.Linear) or (isinstance(mod, QDense) and mod.quant == "none")
    if linear and leaf == "weight":
        return
    if isinstance(mod, Conv1d) and leaf in ("weight", "weight_v"):
        return
    raise ValueError(f"LoRA adapters go on Linear and Conv1d weights; {name} is a "
                     f"{type(mod).__name__}'s {leaf}")


def init_lora(model: nn.Module, cfg: LoRAConfig, gen: torch.Generator) -> dict:
    """{name: {"a": [r, fan_in], "b": [fan_out, r]}} (fp32, on the weight's
    device) for every parameter of model that a pattern selects and that
    has two or more dimensions, a drawn from `gen` in parameter order."""
    overlay = {}
    for name, w in model.named_parameters():
        if not _matches(name, cfg) or w.ndim < 2:
            continue
        _check_target(model, name)
        fan_out, fan_in = w.shape[0], int(np.prod(w.shape[1:]))
        a = torch.randn((cfg.r, fan_in), generator=gen, device=gen.device) * cfg.init_std
        overlay[name] = {"a": a.to(w.device),
                         "b": torch.zeros((fan_out, cfg.r), device=w.device)}
    return overlay


def lora_delta(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor, scale: float) -> torch.Tensor:
    """scale * b @ a in w's layout and dtype: a Linear weight [out, in] as
    it is, a Conv1d weight [out, in, k] from the k-major flattening."""
    d = (b.float() @ a.float()) * scale
    if w.ndim == 3:
        out, cin, k = w.shape
        d = d.reshape(out, k, cin).permute(0, 2, 1)
    return d.reshape(w.shape).to(w.dtype)


def merge_lora(params: dict, overlay: dict, cfg: LoRAConfig) -> dict:
    """The effective parameters: a new dict with W + delta for every name
    of the overlay (a 2-D weight is a Linear's, a 3-D one a Conv1d's)."""
    missing = sorted(set(overlay) - set(params))
    if missing:
        raise KeyError(f"LoRA overlay names no parameter of the model: {missing[:4]}")
    out = dict(params)
    for name, ab in overlay.items():
        w = params[name]
        out[name] = w + lora_delta(w, ab["a"].to(w.device), ab["b"].to(w.device), cfg.scale)
    return out


def _key(name: str) -> str:
    return name.replace(".", "/")


class LoRAOverlay(nn.Module):
    """The trainable pairs, as parameters (`a.<name with / for .>`,
    `b.<...>`).  A rank's overlay on a mesh (shard_overlay) also has its
    model group `tp` and `split`, {name: the factor held as a block}."""

    def __init__(self, overlay: dict, tp=None, split: Optional[dict] = None):
        super().__init__()
        self.a = nn.ParameterDict({_key(n): nn.Parameter(ab["a"].float())
                                   for n, ab in overlay.items()})
        self.b = nn.ParameterDict({_key(n): nn.Parameter(ab["b"].float())
                                   for n, ab in overlay.items()})
        self.tp, self.split = tp, dict(split or {})

    def pairs(self) -> dict:
        return {k.replace("/", "."): {"a": self.a[k], "b": self.b[k]} for k in self.a}

    def specs(self) -> dict:
        """The specs (parallel/mesh.py's form) of the factors held as blocks,
        b's rows or a's columns, for train/step.make_train_state."""
        return {f"{f}.{_key(n)}": ("model", None) if f == "b" else (None, "model")
                for n, f in self.split.items()}

    def whole_pairs(self) -> dict:
        """pairs() with the blocks gathered over the model group: the
        one-card overlay on every rank (a collective: every rank calls it)."""
        out = {}
        for name, ab in self.pairs().items():
            f = self.split.get(name)
            ab = {k: v.detach() for k, v in ab.items()}
            if f is not None:
                d = 0 if f == "b" else 1
                ab[f] = gather_dim(ab[f], d, self.tp.rank, self.tp.size, self.tp.group)
            out[name] = ab
        return out


def shard_overlay(overlay: dict, specs: dict, tp) -> LoRAOverlay:
    """A whole overlay over a base that shard_params sliced by `specs` ->
    this rank's LoRAOverlay: for a weight sharded on dim 0 (column-parallel)
    b's block of rows, on dim 1 (row-parallel) a's block of columns; the
    other factor whole.  Without a model group, the overlay as it is."""
    if tp is None:
        return LoRAOverlay(overlay)
    local, split = {}, {}
    for name, ab in overlay.items():
        d = sharded_dim(specs.get(name, ()))
        ab = dict(ab)
        if d is not None:
            f = "b" if d == 0 else "a"
            n = ab[f].shape[d] // tp.size
            ab[f] = ab[f].narrow(d, tp.rank * n, n).clone()
            split[name] = f
        local[name] = ab
    return LoRAOverlay(local, tp, split)


def lora_loss_fn(base: nn.Module, loss_fn: Callable, cfg: LoRAConfig) -> Callable:
    """loss_fn(model, batch, gen) -> fn(overlay, batch, gen): the loss of
    the base model with the overlay merged in; gradients reach only the
    overlay."""
    base.requires_grad_(False)

    def fn(overlay: LoRAOverlay, batch: dict, gen: Optional[torch.Generator] = None):
        base.train(overlay.training)
        pairs = overlay.pairs()
        for name, f in overlay.split.items():
            # the whole factor: each model rank's gradient is a partial sum
            whole = "a" if f == "b" else "b"
            pairs[name][whole] = copy_to_model(pairs[name][whole], overlay.tp)
        plain = {n: p.detach() for n, p in base.named_parameters() if n in pairs}
        merged = merge_lora(plain, pairs, cfg)
        model = lambda *a, **k: torch.func.functional_call(base, merged, a, k)  # noqa: E731
        return loss_fn(model, batch, gen)

    return fn


def lora_state_dict(overlay) -> dict:
    """An overlay (dict or LoRAOverlay, whose blocks are gathered: every rank
    calls it) -> {"<name>.lora_A": a, "<name>.lora_B": b} as float32 numpy
    arrays (np.savez writes lora.npz from it)."""
    pairs = overlay.whole_pairs() if isinstance(overlay, LoRAOverlay) else overlay
    out = {}
    for name, ab in pairs.items():
        out[f"{name}.lora_A"] = ab["a"].detach().float().cpu().numpy()
        out[f"{name}.lora_B"] = ab["b"].detach().float().cpu().numpy()
    return out


def read_lora_npz(path: str) -> dict:
    """lora.npz -> {name: {"a", "b"}} (float32 tensors), under the names
    the file carries (flax paths in a JAX-written one)."""
    data = np.load(path)
    overlay: dict = {}
    for key in data.files:
        name, kind = key.rsplit(".lora_", 1)
        overlay.setdefault(name, {})["a" if kind == "A" else "b"] = torch.from_numpy(
            np.asarray(data[key], np.float32))
    return overlay
