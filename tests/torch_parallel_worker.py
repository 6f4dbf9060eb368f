"""The ranks of tests/test_torch_parallel.py's CPU clusters.

Each cluster is torch.multiprocessing.spawn over gloo with a file:// store
in the test's directory: `entry` joins the group, loads the test's inputs
(`inputs.pt`, written by the test process from the JAX package's weights),
runs one of the `run_*` functions below and saves what it returns as
`out<rank>.pt`.  This module imports torch and the port only.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from cosyvoice_tpu_torch.models.flow import FlowDraws
from cosyvoice_tpu_torch.models.llm import lm_generate
from cosyvoice_tpu_torch.parallel import distributed as dist
from cosyvoice_tpu_torch.parallel.mesh import LM_RULES, make_mesh, shard_params
from cosyvoice_tpu_torch.runtime.serving import BatchedSynthesizer
from cosyvoice_tpu_torch.train import checkpoint as ckpt
from cosyvoice_tpu_torch.train import step as tstep
from cosyvoice_tpu_torch.train.executor import Executor, all_hosts_have_data
from cosyvoice_tpu_torch.train.optim import make_optimizer


def entry(rank: int, world: int, name: str, dirpath: str) -> None:
    torch.set_num_threads(1)
    dist.init(f"file://{os.path.join(dirpath, 'store')}", world, rank, backend="gloo",
              device_type="cpu")
    try:
        inputs = torch.load(os.path.join(dirpath, "inputs.pt"), weights_only=False)
        out = globals()[f"run_{name}"](rank, world, inputs, dirpath)
        torch.save(out, os.path.join(dirpath, f"out{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu" else a.copy())


def _local_state(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _train(model, batches: list, mesh, opt: dict, loss_fn=tstep.llm_loss_fn, specs=None):
    """Steps of make_train_step over the global batches (each rank its rows,
    step i on a generator of seed i) -> (every step's metrics as floats, the
    train state)."""
    tx, _ = make_optimizer(**opt)
    state = tstep.make_train_state(model, tx, mesh, specs)
    step = tstep.make_train_step(loss_fn, tx, mesh)
    out = []
    for i, b in enumerate(batches):
        b = tstep.shard_batch(b, mesh)
        state, m = step(state, tstep.to_device(b, "cpu"), torch.Generator().manual_seed(i))
        out.append({k: float(v) for k, v in m.items()})
    return out, state


def run_dp_tp(rank: int, world: int, inputs: dict, dirpath: str) -> dict:
    """DP(2) x TP(2): the mesh, greedy lm_generate, BatchedSynthesizer, three
    LM train steps and a tensor-parallel checkpoint; greedy lm_generate over
    int4 / int4xla weights, a phoneme LM's steps and LoRA steps."""
    mesh = make_mesh(2, 2)
    res = {"shape": mesh.shape, "data_rank": mesh.data_rank, "model_rank": mesh.model_rank}

    # greedy decode: each data rank its rows, logits gathered over the model group
    lm = inputs["gen_lm"]
    shard_params(lm, mesh, LM_RULES)
    res["local_heads"] = (lm.cfg.qwen.num_heads, lm.cfg.qwen.num_kv_heads)
    a = inputs["gen_args"]
    rows = slice(mesh.data_rank * 2, mesh.data_rank * 2 + 2)
    out, count = lm_generate(lm, *(_t(x)[rows] for x in a["arrays"]),
                             torch.Generator().manual_seed(0), max_steps=a["max_steps"],
                             cache_len=a["cache_len"])
    res["gen"] = (out.numpy(), count.numpy())

    # batched serving: 3 requests, padded to 4 rows
    model = inputs["stack"]
    synth = BatchedSynthesizer(model, text_bucket=8, speech_bucket=8, mesh=mesh)
    res["wavs"] = synth.synthesize_batch(inputs["requests"], gen=torch.Generator().manual_seed(2))

    # training: the LM sharded by the rules, three steps over the global batches
    train_lm = inputs["train_lm"]
    _, specs = shard_params(train_lm, mesh, LM_RULES)
    res["train_specs"] = specs
    res["train"], state = _train(train_lm, inputs["train_batches"], mesh, inputs["opt"],
                                 specs=specs)
    res["train_state"] = _local_state(train_lm)
    # a checkpoint in the one-card format, then restored onto the mesh
    ckpt.save_checkpoint(os.path.join(dirpath, "ckpt"), state, 3)
    torch.distributed.barrier()
    fresh = inputs["fresh_lm"]
    _, specs = shard_params(fresh, mesh, LM_RULES)
    tx, _ = make_optimizer(**inputs["opt"])
    back, _ = ckpt.restore_checkpoint(os.path.join(dirpath, "ckpt"),
                                      tstep.make_train_state(fresh, tx, mesh, specs))
    mu, mu_back = (s_["inner_state"][1][0]["mu"] for s_ in (state.opt_state, back.opt_state))
    res["restored_equal"] = (all(torch.equal(v, fresh.state_dict()[k])
                                 for k, v in res["train_state"].items())
                             and all(torch.equal(mu[k], mu_back[k]) for k in mu))

    # int4 / int4xla weights sharded: greedy decode and prefix logits of the
    # data rank's rows
    for key, qlm in inputs["quant_lms"].items():
        shard_params(qlm, mesh, LM_RULES)
        arrays = [_t(x)[rows] for x in a["arrays"]]
        out, count = lm_generate(qlm, *arrays, torch.Generator().manual_seed(0),
                                 max_steps=a["max_steps"], cache_len=a["cache_len"])
        layer = qlm.body.layers[0]
        res[f"quant_{key}"] = {"gen": (out.numpy(), count.numpy()),
                               "logits": prefix_logits(qlm, arrays).numpy(),
                               "sharded": (layer.tp_attn is not None,
                                           layer.tp_mlp is not None)}

    # a phoneme LM's steps, sharded by the same rules
    pho = inputs["pho_lm"]
    _, specs = shard_params(pho, mesh, LM_RULES)
    res["pho_train"] = _train(pho, inputs["pho_batches"], mesh, inputs["opt"],
                              tstep.phoneme_llm_loss_fn, specs)[0]
    res["pho_state"], res["pho_specs"] = _local_state(pho), specs

    # LoRA over the sharded base: the whole overlay (the test's), sliced
    from cosyvoice_tpu_torch.train.lora import LoRAConfig, lora_loss_fn, shard_overlay

    r, alpha = inputs["lora_scale"]
    base, cfg = inputs["lora_lm"], LoRAConfig(r=r, alpha=alpha)
    _, specs = shard_params(base, mesh, LM_RULES)
    ov = shard_overlay(inputs["lora_pairs"], specs, mesh.tp)
    res["lora_split"] = dict(ov.split)
    res["lora_train"] = _train(ov, inputs["train_batches"], mesh, inputs["opt"],
                               lora_loss_fn(base, tstep.llm_loss_fn, cfg), ov.specs())[0]
    res["lora_whole"] = ov.whole_pairs()
    return res


def prefix_logits(lm, arrays: list) -> torch.Tensor:
    """The speech head's logits over each row's [sos, text, task, prompt
    speech] (text, text_len, prompt speech, its length: arrays[:4])."""
    with torch.no_grad():
        emb, seq_len = lm.prefill_embeds(*arrays[:4])
        return lm.decode_logits(lm._causal_hidden(emb, seq_len))


def _flow_pinned_loss(draws: list):
    """The flow's loss on the rank's rows of the global batch's pinned draws
    (step i: draws[i], the step's generator seeded i)."""
    def loss_fn(model, batch, gen):
        start, total = batch[tstep.ROWS]
        n = batch["speech_token"].shape[0]
        d = FlowDraws(**{k: torch.from_numpy(np.array(v[start:start + n]))
                         for k, v in draws[gen.initial_seed()].items()})
        out = model(batch["speech_token"], batch["speech_token_len"], batch["speech_feat"],
                    batch["speech_feat_len"], batch["embedding"], draws=d)
        return out["loss"], {"denom": out["denom"]}
    return loss_fn


def run_dp(rank: int, world: int, inputs: dict, dirpath: str) -> dict:
    """DP(2): LM and flow train steps, the executor's vote on even and uneven
    shards, and the train CLI under a 1 x 2 (tensor-parallel) mesh."""
    mesh = make_mesh(2, 1)
    res = {}
    lm = inputs["train_lm"]
    rows = tstep.batch_sharding(mesh, len(inputs["train_batches"][0]["text_token"]))
    first = tstep.to_device({k: v[rows] for k, v in inputs["train_batches"][0].items()}, "cpu")
    with torch.no_grad():
        res["local_loss"] = float(tstep.llm_loss_fn(lm, first)[0])
    shard_params(lm, mesh, LM_RULES)
    res["train"] = _train(lm, inputs["train_batches"], mesh, inputs["opt"])[0]
    res["train_state"] = _local_state(lm)
    flow = inputs["flow"]
    res["flow"] = _train(flow, inputs["flow_batches"], mesh, inputs["opt"],
                         _flow_pinned_loss(inputs["flow_draws"]))[0]
    res["flow_state"] = _local_state(flow)
    # the built-in flow loss: each rank draws its rows of the global draws
    flow2 = inputs["flow2"]
    res["flow_rows"] = _train(flow2, inputs["flow_batches"][:1], mesh, inputs["opt"],
                              tstep.flow_loss_fn)[0]

    # the executor: each rank its rows of the global batches, uneven or not
    for uneven in (False, True):
        ex_lm = inputs[f"exec_lm_{int(uneven)}"]
        tx, _ = make_optimizer(**inputs["opt"])
        state = tstep.make_train_state(ex_lm, tx)
        step = tstep.make_train_step(tstep.llm_loss_fn, tx, mesh)
        losses = []
        batches = inputs["exec_batches"]
        if uneven and rank == 1:
            batches = batches[:-1]

        def logged(st, b, gen, step=step, losses=losses):
            st, m = step(st, b, gen)
            losses.append(float(m["loss"]))
            return st, m

        ex = Executor(train_step=logged, model_dir=os.path.join(dirpath, f"exec{int(uneven)}"),
                      device="cpu", log_interval=1, mesh=mesh)
        ex.train_one_epoch(state, [tstep.shard_batch(b, mesh) for b in batches],
                           to_device=lambda b: tstep.to_device(b, "cpu"))
        res[f"exec_{int(uneven)}"] = losses
    res["vote"] = [all_hosts_have_data(rank == 0), all_hosts_have_data(True)]

    # the CLI, tensor-parallel over the two ranks: the LM, LoRA over it and
    # a phoneme LM labelled online
    from cosyvoice_tpu_torch.bin import train as train_cli

    train_cli.main(inputs["cli_argv"] + ["--mesh_model", "2"])
    train_cli.main(inputs["cli_lora_argv"] + ["--mesh_model", "2"])
    train_cli.main(inputs["cli_pho_argv"] + ["--mesh_model", "2"])
    return res


def unshard(states: list, specs: dict) -> dict:
    """The whole tensors from the model ranks' local state dicts (in
    model-rank order)."""
    from cosyvoice_tpu_torch.parallel.mesh import sharded_dim

    out = {}
    for k, v in states[0].items():
        d = sharded_dim(specs.get(k, ()))
        out[k] = v if d is None else torch.cat([s[k] for s in states], dim=d)
    return out
