"""Training entry point.  Port of cosyvoice_tpu/bin/train.py's jsonl path
for the speech-token LMs, the flow and the GAN vocoders.

Builds `--model llm` (kinds qwen2lm and transformer_lm), `--model flow`
(kinds flow and flow_v1) or `--model hift|bigvgan|vits` from the recipe
through the port's config.py, the optimizer from the recipe's train_conf,
resumes from the newest checkpoint in --model_dir, then runs the epochs
over a jsonl corpus (one jsonl shard path a line of --train_data; each line
of a shard one utterance: text, speech as an inline list of samples or a
WAV path, sample_rate, speech_token, embedding).  A vocoder trains against
the discriminator of the recipe's gan_conf with two optimizers (train_conf
optim / lr / scheduler for the generator, optim_d / lr_d / scheduler_d for
the discriminator), a discriminator step then a generator step a batch
(train/gan.py, train/executor.GanExecutor); the discriminator checkpoints
to --model_dir + "_disc".  On the card unless --device cpu:

  python -m cosyvoice_tpu_torch.bin.train --config conf.yaml --model llm \\
      --train_data data/train.list --model_dir exp/llm [--device cpu]

As the JAX CLI, the optimizers take no weight decay (train_conf's
`weight_decay` is not read), and the step generators start from train_conf
`seed` (the JAX executor keeps its default rng seed of 1986; every recipe
sets seed 1986).  The branches that wait for later slices raise
NotImplementedError naming their ROADMAP item: the phoneme and multi-code
LMs, LoRA, the parquet and speaker-JSON corpora, more than one card.
"""
from __future__ import annotations

import argparse
import functools
import logging
from typing import Optional

import torch

from cosyvoice_tpu_torch.config import build_model, load_config
from cosyvoice_tpu_torch.data import pipeline as pp
from cosyvoice_tpu_torch.device import resolve_device
from cosyvoice_tpu_torch.tokenizer.text import ByteTokenizer, QwenTokenizer
from cosyvoice_tpu_torch.train.checkpoint import latest_step, restore_checkpoint
from cosyvoice_tpu_torch.train.executor import Executor, GanExecutor
from cosyvoice_tpu_torch.train.optim import make_optimizer
from cosyvoice_tpu_torch.train.step import (flow_loss_fn, llm_loss_fn, make_train_state,
                                            make_train_step, to_device,
                                            transformer_lm_loss_fn)

PHONEME_SLICE = ("the phoneme and multi-code LMs' training (ROADMAP Queue 1 item 10c, "
                 "phoneme and multi-code LMs)")
MULTI_CARD = "more than one card (ROADMAP Queue 1 item 11)"
LOSSES = {"qwen2lm": llm_loss_fn, "transformer_lm": transformer_lm_loss_fn,
          "flow": flow_loss_fn, "flow_stream": flow_loss_fn, "flow_v1": flow_loss_fn}
GAN_MODELS = ("hift", "bigvgan", "vits")


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


def make_dataset(list_file: str, conf: dict, tokenizer, epoch: int, gan: bool = False,
                 with_f0: bool = False) -> pp.Pipeline:
    """The data section's jsonl pipeline over the shards of list_file (one
    process: every shard, shuffled by epoch); `with_f0` adds the pitch
    targets, `gan` the waveform rows."""
    shards = [line.strip() for line in open(list_file) if line.strip()]
    shards = pp.shard_list(shards, 0, 1, epoch=epoch)
    if conf.get("batch_type", "dynamic") == "static":
        batcher = pp.static_batch(conf.get("batch_size", 8),
                                  drop_last=conf.get("drop_last", False))
    else:
        batcher = pp.dynamic_batch(conf.get("max_frames_in_batch", 2000))
    stages = [pp.filter_samples(**conf.get("filter", {})),
              pp.resample(conf.get("sample_rate", 24000)),
              pp.compute_fbank(**conf.get("fbank", {}))]
    if with_f0:
        stages.append(pp.compute_f0(sr=conf.get("sample_rate", 24000)))
    return pp.Pipeline(shards, pp.jsonl_opener, *stages, *[
        pp.tokenize(tokenizer),
        pp.shuffle(conf.get("shuffle_buf", 10000)),
        pp.sort_by_feat_len(conf.get("sort_buf", 500)),
        batcher,
        pp.padding(gan=gan, static_lens=conf.get("static_lens")),
    ])


def _refuse_waiting(args, conf: dict, kind: str) -> None:
    if args.model not in GAN_MODELS and kind not in LOSSES:
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

    if args.model in GAN_MODELS:
        run_gan_training(args, conf, model, train_conf, tokenizer, device, seed)
        return
    tx, _ = make_optimizer(
        train_conf.get("optim", "adam"), train_conf.get("lr", 1e-3),
        train_conf.get("scheduler", "warmuplr"),
        train_conf.get("scheduler_conf", {"warmup_steps": 25000}),
        grad_clip=train_conf.get("grad_clip", 5.0),
        accum_grad=train_conf.get("accum_grad", 1))
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


def gan_training(name: str, model, conf: dict, device) -> tuple:
    """The two-optimizer GAN setup of a vocoder (the JAX CLI's
    run_gan_training) -> (g_step, d_step, g_state, d_state): the
    discriminator of gan_conf (multiple = MPD + MRD, mpd, msd or mrd, with
    discriminator_conf), the loss weights and the multi-resolution mel L1
    (gan_conf mel_specs, each log_mel_spectrogram's keywords; one default
    mel without), train_conf's optimizers."""
    from cosyvoice_tpu_torch.models.discriminator import build_discriminator
    from cosyvoice_tpu_torch.models.vits import linear_spectrogram
    from cosyvoice_tpu_torch.ops.mel import log_mel_spectrogram
    from cosyvoice_tpu_torch.train.gan import (GanLossWeights, make_gan_loss_fns,
                                               make_gan_steps, make_vits_loss_fns)

    gan_conf, train_conf = conf.get("gan_conf", {}), conf.get("train_conf", {})
    weights = GanLossWeights(mel=gan_conf.get("mel_weight", 45.0),
                             feat_match=gan_conf.get("feat_match_weight", 2.0),
                             tpr=gan_conf.get("tpr_weight", 1.0),
                             tpr_tau=gan_conf.get("tpr_tau", 0.04))
    disc = build_discriminator(gan_conf.get("discriminator", "multiple"),
                               gan_conf.get("discriminator_conf")).to(device)
    sr = conf.get("data", {}).get("sample_rate", 24000)
    mel_tfs = [functools.partial(log_mel_spectrogram, sr=sr, **d)
               for d in gan_conf.get("mel_specs", [{}])]
    d_apply = lambda d, real, fake: d(real, fake)  # noqa: E731
    if name == "hift":
        g_lf, d_lf = make_gan_loss_fns(lambda m, b, g: m(b["speech_feat"], g), d_apply,
                                       mel_tfs, weights)
    elif name == "bigvgan":
        g_lf, d_lf = make_gan_loss_fns(
            lambda m, b, g: m(b["speech_token"], b["speech_token_len"], b["embedding"],
                              deterministic=False), d_apply, mel_tfs, weights)
    else:
        vcfg = model.cfg
        n_fft = (vcfg.spec_channels - 1) * 2

        def vits_apply(m, b, g):
            spec = linear_spectrogram(b["speech"], n_fft=n_fft, hop=vcfg.hop_length, win=n_fft)
            return m(b["speech_token"], b["speech_token_len"], spec,
                     b["speech_len"] // vcfg.hop_length, b["embedding"], gen=g)

        g_lf, d_lf = make_vits_loss_fns(vits_apply, d_apply, mel_tfs, vcfg.hop_length,
                                        vcfg.segment_size, weights,
                                        kl_weight=gan_conf.get("kl_weight", 1.0))
    tx_g, _ = make_optimizer(
        train_conf.get("optim", "adam"), train_conf.get("lr", 2e-4),
        train_conf.get("scheduler", "constantlr"), train_conf.get("scheduler_conf", {}),
        grad_clip=train_conf.get("grad_clip", 5.0))
    tx_d, _ = make_optimizer(
        train_conf.get("optim_d", "adam"), train_conf.get("lr_d", 2e-4),
        train_conf.get("scheduler_d", "constantlr"), train_conf.get("scheduler_d_conf", {}),
        grad_clip=train_conf.get("grad_clip", 5.0))
    g_step, d_step = make_gan_steps(g_lf, d_lf, tx_g, tx_d)
    return g_step, d_step, make_train_state(model, tx_g), make_train_state(disc, tx_d)


def run_gan_training(args, conf: dict, model, train_conf: dict, tokenizer, device,
                     seed: int) -> None:
    """The GAN loop of a vocoder: gan_training's steps over the epochs, both
    nets resumed from their directories."""
    g_step, d_step, g_state, d_state = gan_training(args.model, model, conf, device)
    if latest_step(args.model_dir) is not None:
        g_state, at = restore_checkpoint(args.model_dir, g_state)
        logging.info("resumed generator from step %d", at)
        if latest_step(args.model_dir + "_disc") is not None:
            d_state, _ = restore_checkpoint(args.model_dir + "_disc", d_state)

    ex = GanExecutor(train_step=g_step, disc_step=d_step, model_dir=args.model_dir,
                     device=device, save_per_step=train_conf.get("save_per_step", -1),
                     log_interval=train_conf.get("log_interval", 100), rng_seed=seed)
    ex.step = g_state.step
    for epoch in range(args.epochs):
        ds = make_dataset(args.train_data, conf.get("data", {}), tokenizer, epoch, gan=True,
                          with_f0=args.model == "hift")
        g_state, d_state = ex.train_one_epoch_gan(g_state, d_state, ds,
                                                  to_device=lambda b: to_device(b, device))

if __name__ == "__main__":
    main()
