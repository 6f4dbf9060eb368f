"""The ("data", "model") layout of processes and the LM's tensor-parallel
rules.  Port of cosyvoice_tpu/parallel/mesh.py.

- axis "data": utterance batches (DP); gradients are summed over it.
- axis "model": tensor parallelism for the Qwen2 LM, Megatron-style:
  q/k/v and gate/up column-parallel, o/down row-parallel with one all-reduce
  each, the embeddings vocabulary-parallel, the speech head's logits
  gathered (parallel/collectives.py).

Ranks are row-major, so "model" is the inner axis: rank = data_rank *
model + model_rank, and a model group is a run of neighbouring ranks (one
host's cards).  `dcn_data` is the count of data-parallel slices across
hosts; "data" is already the outer axis, so it only has to divide `data`.

The JAX package shards any dimension its mesh axis divides (GSPMD pads and
reshards inside one program).  Here a module has to run its shards, so a
tensor shards only inside a block that its model names: a module that can
run tensor-parallel has `tp_blocks(size)` (the names, relative to it, of
its submodules that run sharded over `size` ranks) and `shard_(tp)` (take
the local config and the model group).  This module slices by the rules and
calls the hooks; it knows nothing of the models.  A rank of the Qwen2 body
holds whole heads, so its attention shards only when both the query and the
key/value head counts divide by "model"; otherwise attention is replicated
(each rank computes it alike) and only the MLP and the vocabularies shard.
Qwen2-0.5B at model = 4 (two KV heads) is that case.

A torch Linear weight is [out, in], so the JAX rule P(None, "model") on a
kernel [in, out] is a shard of dim 0 here and P("model", None) one of dim 1;
an embedding [V, D] keeps dim 0.  QDense's int8 weight is [out, in] with a
per-output `scale` [out], which shards with a column-parallel weight and is
replicated beside a row-parallel one.  A module whose tensors keep another
layout says how the rules' spec reads there (`tp_spec`): QDense's int4 and
int4xla buffers keep flax's [in(/2), out] weight and [in/g, out] scale, so
a column-parallel projection shards dim 1 of both and a row-parallel one
dim 0 of both (packed rows and scale groups); the Qwen2 body keeps a
row-parallel block whole where its rank's input rows are not whole scale
groups (models/qwen2.Qwen2Model._tp_split).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from cosyvoice_tpu_torch.parallel.collectives import ModelGroup
from cosyvoice_tpu_torch.parallel.distributed import rank_and_world


@dataclass(eq=False)
class Mesh:
    """One rank's view of the (data, model) layout: the sizes, this rank and
    the process groups of its data axis (the ranks that share its model
    index) and of its model axis (the ranks that share its rows).  With no
    groups it is a layout only, for the rules' diagnostics."""

    data: int = 1
    model: int = 1
    rank: int = 0
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def tp(self) -> Optional[ModelGroup]:
        if self.model == 1:
            return None
        return ModelGroup(self.model_group, self.model, self.model_rank)


def make_mesh(data: int = -1, model: int = 1, dcn_data: int = 1) -> Mesh:
    """Mesh(("data", "model")) over the process group (one process: 1 x 1).
    `data` -1 means world size / model.  The groups come from
    torch.distributed's init_device_mesh with row-major ranks, over the
    device type the backend runs (nccl: cuda; gloo: cpu, whose groups also
    carry CUDA tensors)."""
    rank, world = rank_and_world()
    if data == -1:
        data = world // model
    if data * model != world:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} processes, "
                         f"not {world}")
    if data % dcn_data:
        raise ValueError(f"dcn_data {dcn_data} must divide data {data}")
    if world == 1:
        return Mesh()
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))
    return Mesh(data, model, rank, dm.get_group("data"), dm.get_group("model"))


# name regex -> spec (one mesh axis or None a dim), first match wins.  Names
# are the port's state_dict keys, e.g. "llm.model.model.layers.3.self_attn.q_proj.weight".
LM_RULES: list[tuple[str, tuple]] = [
    # attention: whole heads (the output dim of q/k/v, the input dim of o)
    (r".*\.(q_proj|k_proj|v_proj)\.weight$", ("model", None)),
    (r".*\.(q_proj|k_proj|v_proj)\.(bias|scale)$", ("model",)),
    (r".*\.o_proj\.weight$", (None, "model")),
    # mlp: the intermediate dim
    (r".*\.(gate_proj|up_proj)\.weight$", ("model", None)),
    (r".*\.(gate_proj|up_proj)\.scale$", ("model",)),
    (r".*\.down_proj\.weight$", (None, "model")),
    # embeddings and the speech head: the vocabulary
    (r"(.*\.)?embed_tokens\.weight$", ("model", None)),
    (r"(.*\.)?speech_embedding\.weight$", ("model", None)),
    (r"(.*\.)?llm_decoder\.weight$", ("model", None)),
    (r"(.*\.)?llm_decoder\.bias$", ("model",)),
]


def spec_for(name: str, rules: list) -> tuple:
    for pat, spec in rules:
        if re.match(pat, name):
            return spec
    return ()


def _fits(spec: tuple, shape, mesh: Mesh) -> bool:
    """True iff every sharded dim is divisible by its mesh axis size."""
    for dim, axis in zip(shape, spec):
        if axis is not None and dim % mesh.shape[axis]:
            return False
    return True


def sharded_dim(spec: tuple) -> Optional[int]:
    """The dim a spec shards over "model" (None: replicated)."""
    return spec.index("model") if "model" in spec else None


def _tensors(model: torch.nn.Module) -> dict:
    return dict(model.named_parameters()) | dict(model.named_buffers())


def _hooked(model: torch.nn.Module) -> list:
    """(name prefix, module) of every module with the tensor-parallel hooks,
    outermost first."""
    return [(f"{p}." if p else "", m) for p, m in model.named_modules()
            if hasattr(m, "tp_blocks")]


def param_shardings(model: torch.nn.Module, mesh: Mesh, rules: list) -> dict:
    """{state_dict name: spec} for every parameter and buffer.  A rule's spec
    holds only inside a block the model names (`tp_blocks`) and where its
    axis divides the dim; every other tensor is replicated."""
    blocks = tuple(f"{head}{b}." for head, mod in _hooked(model)
                   for b in mod.tp_blocks(mesh.model))
    modules = dict(model.named_modules())
    specs = {}
    for name, t in _tensors(model).items():
        spec = spec_for(name, rules) if name.startswith(blocks) else ()
        owner, _, attr = name.rpartition(".")
        layout = getattr(modules.get(owner), "tp_spec", None)
        if layout is not None and name.startswith(blocks):
            # the spec of the module's weight in torch's layout says which
            # kind of projection it is; the module maps it onto its tensor
            own = layout(attr, spec_for(f"{owner}.weight", rules))
            spec = spec if own is None else own
        specs[name] = spec if _fits(spec, t.shape, mesh) else ()
    return specs


def sharded_bytes_fraction(model: torch.nn.Module, mesh: Mesh, rules: list) -> float:
    """Share of the parameter and buffer bytes whose spec shards a dim: a
    guard against silent whole-model replication (works on meta tensors)."""
    specs = param_shardings(model, mesh, rules)
    tot = sharded = 0
    for name, t in _tensors(model).items():
        nbytes = t.numel() * t.element_size()
        tot += nbytes
        if sharded_dim(specs[name]) is not None:
            sharded += nbytes
    return sharded / max(tot, 1)


def shard_dims(specs: dict) -> dict:
    """{name: the dim its spec shards} of the sharded tensors."""
    return {k: sharded_dim(s) for k, s in specs.items() if sharded_dim(s) is not None}


def shard_params(model: torch.nn.Module, mesh: Mesh, rules: list):
    """Slice a full model, in place, into this rank's local model: every
    module with a sharded tensor in its subtree runs its `shard_(tp)` hook
    (innermost first, so an owner sees its parts' local configs), then every
    sharded tensor keeps its model rank's block.  Returns (model, specs):
    the step and the checkpoint take the specs (train/step.make_train_state)."""
    specs = param_shardings(model, mesh, rules)
    tp = mesh.tp
    dims = shard_dims(specs)
    if tp is None or not dims:
        return model, specs
    for head, mod in reversed(_hooked(model)):
        if any(k.startswith(head) for k in dims):
            mod.shard_(tp)
    with torch.no_grad():
        for name, t in _tensors(model).items():
            if name not in dims:
                continue
            dim = dims[name]
            n = t.shape[dim] // mesh.model
            local = t.narrow(dim, tp.rank * n, n).clone()
            owner_name, _, attr = name.rpartition(".")
            owner = model.get_submodule(owner_name)
            if attr in owner._parameters:
                owner._parameters[attr].data = local
            else:
                owner._buffers[attr] = local
    return model, specs


def rank_generator(gen: torch.Generator, data_rank: int) -> torch.Generator:
    """The generator of a data rank whose rows draw on their own (sampled
    decoding, a batch of its own): data rank 0 keeps `gen`, rank r > 0
    draws from (gen's seed + r << 48) on gen's device."""
    if data_rank == 0:
        return gen
    seed = (gen.initial_seed() + (data_rank << 48)) % (1 << 64)
    return torch.Generator(device=gen.device).manual_seed(seed)


def batch_sharding(mesh: Mesh, batch_size: int) -> slice:
    """The rows of a [batch_size, ...] batch that this rank's data index
    holds (contiguous blocks, as P("data") splits the leading dim)."""
    if batch_size % mesh.data:
        raise ValueError(f"batch of {batch_size} rows does not split over data {mesh.data}")
    n = batch_size // mesh.data
    return slice(mesh.data_rank * n, (mesh.data_rank + 1) * n)
