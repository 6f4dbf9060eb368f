"""Training entry point.  Port of cosyvoice_tpu/bin/train.py's jsonl path
for the speech-token LMs and the flow.

Builds `--model llm` (kinds qwen2lm and transformer_lm) or `--model flow`
(kinds flow and flow_v1) from the recipe through the port's config.py,
the optimizer from the recipe's train_conf, resumes from the newest
checkpoint in --model_dir, then runs the epochs over a jsonl corpus (one
jsonl shard path a line of --train_data; each line of a shard one
utterance: text, speech as an inline list of samples or a WAV path,
sample_rate, speech_token, embedding).  On the card unless --device cpu:

  python -m cosyvoice_tpu_torch.bin.train --config conf.yaml --model llm \\
      --train_data data/train.list --model_dir exp/llm [--device cpu]

The branches that wait for later slices raise NotImplementedError naming
their ROADMAP item: the vocoders (hift, bigvgan, vits), the phoneme and
multi-code LMs, LoRA, the parquet and speaker-JSON corpora, more than one
card.
"""
from __future__ import annotations

import argparse
import logging
from typing import Optional

import torch

from cosyvoice_tpu_torch.config import build_model, load_config
from cosyvoice_tpu_torch.data import pipeline as pp
from cosyvoice_tpu_torch.device import resolve_device
from cosyvoice_tpu_torch.tokenizer.text import ByteTokenizer, QwenTokenizer
from cosyvoice_tpu_torch.train.checkpoint import latest_step, restore_checkpoint
from cosyvoice_tpu_torch.train.executor import Executor
from cosyvoice_tpu_torch.train.optim import make_optimizer
from cosyvoice_tpu_torch.train.step import (flow_loss_fn, llm_loss_fn, make_train_state,
                                            make_train_step, to_device,
                                            transformer_lm_loss_fn)

GAN_SLICE = "the GAN vocoders' training (ROADMAP Queue 1 item 10, GAN vocoders)"
PHONEME_SLICE = ("the phoneme and multi-code LMs' training (ROADMAP Queue 1 item 10, "
                 "phoneme and multi-code LMs)")
MULTI_CARD = "more than one card (ROADMAP Queue 1 item 11)"
LOSSES = {"qwen2lm": llm_loss_fn, "transformer_lm": transformer_lm_loss_fn,
          "flow": flow_loss_fn, "flow_stream": flow_loss_fn, "flow_v1": flow_loss_fn}


def get_args(argv: Optional[list] = None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--model", required=True, choices=["llm", "flow", "hift", "bigvgan", "vits"])
    p.add_argument("--train_data", required=True, help="file with one jsonl shard path a line")
    p.add_argument("--cv_data", default=None)
    p.add_argument("--model_dir", required=True)
    p.add_argument("--tokenizer_path", default=None,
                   help="a tokenizer.json (Qwen BPE); UTF-8 bytes without one")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    p.add_argument("--mesh_data", type=int, default=-1)
    p.add_argument("--mesh_model", type=int, default=1)
    p.add_argument("--mesh_dcn_data", type=int, default=1)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--coordinator_address", default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--world_size", type=int, default=None)
    p.add_argument("--lora", action="store_true")
    p.add_argument("--data_format", choices=["jsonl", "spk_json", "parquet"], default="jsonl")
    p.add_argument("--s3_ckpt", default=None)
    p.add_argument("--spk_ckpt", default=None)
    return p.parse_args(argv)


def make_dataset(list_file: str, conf: dict, tokenizer, epoch: int) -> pp.Pipeline:
    """The data section's jsonl pipeline over the shards of list_file (one
    process: every shard, shuffled by epoch)."""
    shards = [line.strip() for line in open(list_file) if line.strip()]
    shards = pp.shard_list(shards, 0, 1, epoch=epoch)
    if conf.get("batch_type", "dynamic") == "static":
        batcher = pp.static_batch(conf.get("batch_size", 8),
                                  drop_last=conf.get("drop_last", False))
    else:
        batcher = pp.dynamic_batch(conf.get("max_frames_in_batch", 2000))
    return pp.Pipeline(shards, pp.jsonl_opener, *[
        pp.filter_samples(**conf.get("filter", {})),
        pp.resample(conf.get("sample_rate", 24000)),
        pp.compute_fbank(**conf.get("fbank", {})),
        pp.tokenize(tokenizer),
        pp.shuffle(conf.get("shuffle_buf", 10000)),
        pp.sort_by_feat_len(conf.get("sort_buf", 500)),
        batcher,
        pp.padding(static_lens=conf.get("static_lens")),
    ])


def _refuse_waiting(args, conf: dict, kind: str) -> None:
    if args.model in ("hift", "bigvgan", "vits"):
        raise NotImplementedError(f"--model {args.model}: {GAN_SLICE}")
    if kind not in LOSSES:
        raise NotImplementedError(f"--model {args.model} kind {kind!r}: {PHONEME_SLICE}")
    if args.lora or conf.get("lora_conf", {}).get("enabled"):
        raise NotImplementedError(f"--lora: LoRA finetuning comes with {PHONEME_SLICE}")
    if args.data_format != "jsonl":
        raise NotImplementedError(f"--data_format {args.data_format}: {PHONEME_SLICE}")
    if args.s3_ckpt or args.spk_ckpt:
        raise NotImplementedError(f"--s3_ckpt / --spk_ckpt label online: {PHONEME_SLICE}")
    if (max(args.mesh_data, args.mesh_model, args.mesh_dcn_data) > 1
            or (args.world_size or 1) > 1 or (args.rank or 0) > 0
            or args.coordinator_address or (args.num_processes or 1) > 1
            or args.process_id):
        raise NotImplementedError(f"a mesh or several processes: {MULTI_CARD}")


def main(argv: Optional[list] = None) -> None:
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO)
    conf = load_config(args.config)
    model_conf = dict(conf[args.model])
    kind = model_conf.pop("kind")
    _refuse_waiting(args, conf, kind)
    device = resolve_device(args.device)
    train_conf = conf.get("train_conf", {})
    data_conf = conf.get("data", {})
    seed = train_conf.get("seed", 1986)
    torch.manual_seed(seed)
    model, _ = build_model(kind, model_conf)
    model.to(device)
    tokenizer = QwenTokenizer(args.tokenizer_path) if args.tokenizer_path else ByteTokenizer()

    tx, _ = make_optimizer(
        train_conf.get("optim", "adam"), train_conf.get("lr", 1e-3),
        train_conf.get("scheduler", "warmuplr"),
        train_conf.get("scheduler_conf", {"warmup_steps": 25000}),
        grad_clip=train_conf.get("grad_clip", 5.0),
        accum_grad=train_conf.get("accum_grad", 1),
        weight_decay=train_conf.get("weight_decay", 0.0))
    loss_fn = LOSSES[kind]
    state = make_train_state(model, tx)
    step = make_train_step(loss_fn, tx)
    if latest_step(args.model_dir) is not None:
        state, at = restore_checkpoint(args.model_dir, state)
        logging.info("resumed from step %d", at)

    def cv_step(m, batch, gen):
        loss, metrics = loss_fn(m, batch, gen)
        return dict(metrics, loss=loss)

    ex = Executor(train_step=step, model_dir=args.model_dir, device=device,
                  save_per_step=train_conf.get("save_per_step", -1),
                  log_interval=train_conf.get("log_interval", 100), rng_seed=seed,
                  cv_step=cv_step)
    ex.step = state.step
    move = lambda b: to_device(b, device)
    for epoch in range(args.epochs):
        ds = make_dataset(args.train_data, data_conf, tokenizer, epoch)
        cv = (list(make_dataset(args.cv_data, data_conf, tokenizer, 0))
              if args.cv_data else None)
        state = ex.train_one_epoch(state, ds, cv_data=cv, to_device=move)


if __name__ == "__main__":
    main()
