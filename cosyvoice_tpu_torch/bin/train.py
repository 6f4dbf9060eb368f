"""Training entry point.  Port of cosyvoice_tpu/bin/train.py.

Builds `--model llm` (kinds qwen2lm and transformer_lm, and the Qwen2
phoneme LMs qwen2lm_phoneme, qwen2lm_phoneme_src and qwen2lm_phoneme_src2),
`--model flow` (kinds flow, flow_stream and flow_v1) or `--model
hift|bigvgan|vits` from the recipe through the port's config.py, the
optimizer from the recipe's train_conf, resumes from the newest checkpoint
in --model_dir, then runs the epochs over the corpus: --data_format jsonl
(one jsonl shard path a line of --train_data; each line of a shard one
utterance: text, speech as an inline list of samples or a WAV path,
sample_rate, speech_token, embedding), parquet (rows with audio_data WAV
bytes, speech_token and utt / spk embeddings) or spk_json (speaker-keyed
JSON files: spk -> [{utt, wav, text, phoneme, durations, embedding}]).
A vocoder trains against the discriminator of the recipe's gan_conf with
two optimizers (train_conf optim / lr / scheduler for the generator,
optim_d / lr_d / scheduler_d for the discriminator), a discriminator step
then a generator step a batch (train/gan.py, train/executor.GanExecutor);
the discriminator checkpoints to --model_dir + "_disc".  On the card
unless --device cpu:

  python -m cosyvoice_tpu_torch.bin.train --config conf.yaml --model llm \\
      --train_data data/train.list --model_dir exp/llm [--device cpu]

A phoneme LM trains on its corpus's phonemes (data.phoneme_dict is the
phoneme table), cropped at prosody marks (data.truncate_phoneme), with
its speech tokens and speaker vectors labelled online every batch
(train/online_codec.py): the frozen S3 tokenizer (the recipe's `s3`
section; --s3_ckpt a speech_tokenizer_v2.onnx) and, where the recipe has
a `speaker` section, the frozen SpeakerEmbedding (--spk_ckpt a torch .pt
state dict); without a checkpoint a label model keeps its random init,
with a warning; --cv_data is not read there, as in the JAX CLI.
--lora (or lora_conf.enabled) trains only LoRA adapters on the modules
lora_conf.patterns names (train/lora.py) of qwen2lm, transformer_lm or a
flow, and writes lora.npz after every epoch for bin/ckpt_resave.py
--lora_npz.

As the JAX CLI, the optimizers take no weight decay (train_conf's
`weight_decay` is not read), and the step generators start from train_conf
`seed` (the JAX executor keeps its default rng seed of 1986; every recipe
sets seed 1986).  Where the JAX CLI fails or silently does something else
than asked, the port raises, saying what the JAX CLI does: the phoneme
kinds whose arguments its phoneme branch does not fit
(qwen2lm_phoneme_multicode, transformer_lm_phoneme,
transformer_lm_phoneme_with_spk), --lora with a phoneme kind or a vocoder
(the JAX CLI trains every parameter), and --data_format parquet with a
phoneme kind (the JAX CLI reads the shards as jsonl).

More than one process (parallel/): one process a rank, started by torchrun
or with the --coordinator_address / --num_processes / --process_id triple;
--mesh_data x --mesh_model lays the ranks out (data -1: world / model).
The LM kind qwen2lm and the Qwen2 phoneme kinds shard by the
tensor-parallel rules (LM_RULES), as the JAX CLI's; the other kinds
replicate.  Each data rank reads its share of the shards (static batches
drop their last partial batch by default, as the JAX CLI), and a phoneme
LM's data rank labels its own batches (the ranks of a model group label
the same ones); all ranks stop together when one runs out, rank 0 logs and
checkpoints, on cuda:{LOCAL_RANK % device_count} unless --device cpu.
--lora trains the overlay over the sharded base (train/lora.shard_overlay)
and writes the whole factors:

  python -m torch.distributed.run --nproc_per_node 2 -m cosyvoice_tpu_torch.bin.train \\
      --config conf.yaml --model llm --train_data data/train.list --model_dir exp/llm \\
      --mesh_model 2 [--lora]

GAN training on more than one process raises: the JAX CLI's GAN branch
takes no mesh, so each of its processes trains a copy of its own.
"""
from __future__ import annotations

import argparse
import functools
import logging
import os
from typing import Optional

import numpy as np
import torch

from cosyvoice_tpu_torch.config import build_model, load_config
from cosyvoice_tpu_torch.data import pipeline as pp
from cosyvoice_tpu_torch.device import resolve_device
from cosyvoice_tpu_torch.parallel import distributed as dist
from cosyvoice_tpu_torch.parallel.mesh import LM_RULES, make_mesh, shard_params
from cosyvoice_tpu_torch.tokenizer.text import ByteTokenizer, QwenTokenizer
from cosyvoice_tpu_torch.train.checkpoint import latest_step, restore_checkpoint
from cosyvoice_tpu_torch.train.executor import GAN_ONE_PROCESS, Executor, GanExecutor
from cosyvoice_tpu_torch.train.optim import make_optimizer
from cosyvoice_tpu_torch.train.step import (flow_loss_fn, llm_loss_fn, make_train_state,
                                            make_train_step, phoneme_llm_loss_fn, to_device,
                                            transformer_lm_loss_fn)

LOSSES = {"qwen2lm": llm_loss_fn, "transformer_lm": transformer_lm_loss_fn,
          "flow": flow_loss_fn, "flow_stream": flow_loss_fn, "flow_v1": flow_loss_fn}
PHONEME_KINDS = ("qwen2lm_phoneme", "qwen2lm_phoneme_src", "qwen2lm_phoneme_src2")
TP_KINDS = ("qwen2lm",) + PHONEME_KINDS   # the kinds LM_RULES shard; the others replicate
GAN_MODELS = ("hift", "bigvgan", "vits")
JAX_PHONEME_BRANCH = ("the JAX CLI sends every --model llm kind with 'phoneme' in its name "
                      "to run_phoneme_llm_training")


def get_args(argv: Optional[list] = None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--model", required=True, choices=["llm", "flow", "hift", "bigvgan", "vits"])
    p.add_argument("--train_data", required=True, help="file with one shard path a line")
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
    p.add_argument("--lora", action="store_true",
                   help="train only LoRA adapters (also lora_conf.enabled); lora.npz each epoch")
    p.add_argument("--data_format", choices=["jsonl", "spk_json", "parquet"], default="jsonl")
    p.add_argument("--s3_ckpt", default=None,
                   help="speech_tokenizer_v2.onnx for the online speech-token labels")
    p.add_argument("--spk_ckpt", default=None,
                   help="SpeakerEmbedding state dict (.pt) for the online speaker vectors")
    return p.parse_args(argv)


def _shards(list_file: str, epoch: int, rank: int = 0, world_size: int = 1) -> list:
    """Rank `rank` of `world_size`'s shards of list_file, shuffled by epoch."""
    shards = [line.strip() for line in open(list_file) if line.strip()]
    return pp.shard_list(shards, rank, world_size, epoch=epoch)


def _batcher(conf: dict, default_type: str, world_size: int = 1):
    if conf.get("batch_type", default_type) == "static":
        return pp.static_batch(conf.get("batch_size", 8),
                               drop_last=conf.get("drop_last", world_size > 1))
    return pp.dynamic_batch(conf.get("max_frames_in_batch", 2000))


def _opener(data_format: str):
    """-> (source stage, stages that follow it) of a --data_format."""
    if data_format == "parquet":
        return pp.parquet_opener, [pp.decode_audio_bytes(), pp.parse_embedding()]
    if data_format == "spk_json":
        return pp.spk_json_source, []
    return pp.jsonl_opener, []


def make_dataset(list_file: str, conf: dict, tokenizer, epoch: int, gan: bool = False,
                 with_f0: bool = False, data_format: str = "jsonl", rank: int = 0,
                 world_size: int = 1) -> pp.Pipeline:
    """The data section's pipeline over rank `rank` of `world_size`'s
    shards of list_file; `with_f0` adds the pitch targets, `gan` the
    waveform rows."""
    opener, pre = _opener(data_format)
    stages = pre + [pp.filter_samples(**conf.get("filter", {})),
                    pp.resample(conf.get("sample_rate", 24000)),
                    pp.compute_fbank(**conf.get("fbank", {}))]
    if with_f0:
        stages.append(pp.compute_f0(sr=conf.get("sample_rate", 24000)))
    return pp.Pipeline(_shards(list_file, epoch, rank, world_size), opener, *stages, *[
        pp.tokenize(tokenizer),
        pp.shuffle(conf.get("shuffle_buf", 10000)),
        pp.sort_by_feat_len(conf.get("sort_buf", 500)),
        _batcher(conf, "dynamic", world_size),
        pp.padding(gan=gan, static_lens=conf.get("static_lens")),
    ])


def make_phoneme_dataset(list_file: str, conf: dict, tokenizer, pho_tokenizer, epoch: int,
                         data_format: str = "spk_json", rank: int = 0,
                         world_size: int = 1) -> pp.Pipeline:
    """The phoneme LMs' pipeline over rank `rank` of `world_size`'s shards:
    the prosody-mark crop and the factored phoneme ids after the jsonl
    stages, static batches by default, and the padded audio rows (at the
    mel hop) that the online labelers read."""
    return pp.Pipeline(_shards(list_file, epoch, rank, world_size), _opener(data_format)[0], *[
        pp.filter_samples(**conf.get("filter", {})),
        pp.truncate_phoneme_sequence(**conf.get("truncate_phoneme", {}), seed=epoch),
        pp.resample(conf.get("sample_rate", 24000)),
        pp.compute_fbank(**conf.get("fbank", {})),
        pp.tokenize(tokenizer),
        pp.tokenize_phoneme(pho_tokenizer),
        pp.shuffle(conf.get("shuffle_buf", 10000), seed=epoch),
        pp.sort_by_feat_len(conf.get("sort_buf", 500)),
        _batcher(conf, "static", world_size),
        pp.padding(gan=conf.get("fbank", {}).get("hop", 480),
                   static_lens=conf.get("static_lens")),
    ])


def _use_lora(args, conf: dict) -> bool:
    return bool(args.lora or conf.get("lora_conf", {}).get("enabled"))


def _refuse(args, conf: dict, kind: str) -> None:
    """Raise on what the port does not run, saying what the JAX CLI does there."""
    if args.model == "llm" and "phoneme" in kind and kind not in PHONEME_KINDS:
        how = ("get_delay_pattern unpacks [B, T, N] codes from the [B, T] speech tokens "
               "(ValueError)" if kind == "qwen2lm_phoneme_multicode"
               else "the module's __call__ takes other arguments (TypeError)")
        raise NotImplementedError(
            f"--model llm kind {kind!r}: {JAX_PHONEME_BRANCH}, whose model.init(text, "
            "text_len, pho, pho_len, speech_token, speech_token_len, embedding) fits only "
            f"{', '.join(PHONEME_KINDS)}; the JAX CLI fails on {kind!r}: {how}")
    if args.model not in GAN_MODELS and kind not in LOSSES and kind not in PHONEME_KINDS:
        raise NotImplementedError(f"--model {args.model} kind {kind!r}: the JAX CLI trains "
                                  f"no such kind")
    if _use_lora(args, conf) and (kind in PHONEME_KINDS or args.model in GAN_MODELS):
        where = (f"{JAX_PHONEME_BRANCH}, which returns" if kind in PHONEME_KINDS
                 else "the JAX CLI's GAN branch returns")
        raise NotImplementedError(f"--lora / lora_conf.enabled with {kind!r}: {where} before "
                                  "its LoRA block and trains every parameter")
    if args.data_format == "parquet" and kind in PHONEME_KINDS:
        raise NotImplementedError(f"--data_format parquet with {kind!r}: {JAX_PHONEME_BRANCH}, "
                                  "which reads parquet shards as jsonl")
    if _multi_process(args) and args.model in GAN_MODELS:
        raise NotImplementedError(f"GAN training under a mesh or several processes: "
                                  f"{GAN_ONE_PROCESS}")


def _multi_process(args) -> bool:
    """A mesh or more than one process asked for, by flags or by torchrun."""
    return (max(args.mesh_data, args.mesh_model, args.mesh_dcn_data) > 1
            or (args.world_size or 1) > 1 or (args.num_processes or 1) > 1
            or int(os.environ.get("WORLD_SIZE", "1")) > 1)


def _optimizer(train_conf: dict):
    return make_optimizer(
        train_conf.get("optim", "adam"), train_conf.get("lr", 1e-3),
        train_conf.get("scheduler", "warmuplr"),
        train_conf.get("scheduler_conf", {"warmup_steps": 25000}),
        grad_clip=train_conf.get("grad_clip", 5.0),
        accum_grad=train_conf.get("accum_grad", 1))[0]


def main(argv: Optional[list] = None) -> None:
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO)
    conf = load_config(args.config)
    model_conf = dict(conf[args.model])
    kind = model_conf.pop("kind")
    _refuse(args, conf, kind)
    device = resolve_device(args.device)
    dist.init(args.coordinator_address, args.num_processes, args.process_id,
              device_type=device.type)
    world = dist.rank_and_world()[1]
    mesh = make_mesh(args.mesh_data, args.mesh_model, args.mesh_dcn_data)
    if world > 1:
        device = dist.local_device(args.device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        # each data rank reads its share; the ranks of a model group read alike
        args.rank, args.world_size = mesh.data_rank, mesh.data
    args.rank, args.world_size = args.rank or 0, args.world_size or 1
    train_conf = conf.get("train_conf", {})
    data_conf = conf.get("data", {})
    seed = train_conf.get("seed", 1986)
    torch.manual_seed(seed)
    model, _ = build_model(kind, model_conf, device)
    model.to(device)
    use_lora = _use_lora(args, conf)
    if use_lora:
        from cosyvoice_tpu_torch.train.lora import (LoRAConfig, init_lora, lora_loss_fn,
                                                    shard_overlay, target_pattern)

        lora_conf = conf.get("lora_conf", {})
        pats = lora_conf.get("patterns", ["q_proj", "k_proj", "v_proj", "o_proj"])
        lcfg = LoRAConfig(r=int(lora_conf.get("rank", 8)), alpha=int(lora_conf.get("alpha", 16)),
                          target_patterns=(target_pattern(pats),))
        # drawn over the whole model, then sliced as the base is
        overlay = init_lora(model, lcfg, torch.Generator(device=device).manual_seed(seed))
        if not overlay:
            raise ValueError(f"lora patterns matched no weights: {pats}")
    specs = shard_params(model, mesh, LM_RULES)[1] if world > 1 and kind in TP_KINDS else None
    tokenizer = QwenTokenizer(args.tokenizer_path) if args.tokenizer_path else ByteTokenizer()

    if args.model in GAN_MODELS:
        run_gan_training(args, conf, model, train_conf, tokenizer, device, seed)
        return
    multi = mesh if world > 1 else None
    if kind in PHONEME_KINDS:
        run_phoneme_llm_training(args, conf, model, train_conf, tokenizer, device, seed,
                                 multi, specs)
        return
    tx = _optimizer(train_conf)
    loss_fn, train_model = LOSSES[kind], model
    if use_lora:
        loss_fn = lora_loss_fn(model, loss_fn, lcfg)
        train_model = shard_overlay(overlay, specs or {}, mesh.tp if specs else None)
        train_model.to(device)
        specs = train_model.specs()
        logging.info("LoRA finetune: %d adapters (r=%d alpha=%s)", len(overlay), lcfg.r,
                     lcfg.alpha)
    state = make_train_state(train_model, tx, mesh, specs)
    step = make_train_step(loss_fn, tx, multi)
    if latest_step(args.model_dir) is not None:
        state, at = restore_checkpoint(args.model_dir, state)
        logging.info("resumed from step %d", at)

    def cv_step(m, batch, gen):
        loss, metrics = loss_fn(m, batch, gen)
        return dict(metrics, loss=loss)

    ex = Executor(train_step=step, model_dir=args.model_dir, device=device,
                  save_per_step=train_conf.get("save_per_step", -1),
                  log_interval=train_conf.get("log_interval", 100), rng_seed=seed,
                  cv_step=cv_step, mesh=multi)
    ex.step = state.step
    move = lambda b: to_device(b, device)  # noqa: E731
    shard = dict(rank=args.rank, world_size=args.world_size)
    for epoch in range(args.epochs):
        ds = make_dataset(args.train_data, data_conf, tokenizer, epoch,
                          data_format=args.data_format, **shard)
        cv = (list(make_dataset(args.cv_data, data_conf, tokenizer, 0,
                                data_format=args.data_format, **shard))
              if args.cv_data else None)
        state = ex.train_one_epoch(state, ds, cv_data=cv, to_device=move)
        if use_lora:
            from cosyvoice_tpu_torch.train.lora import lora_state_dict

            arrays = lora_state_dict(state.model)       # gathered on every rank
            if dist.rank_and_world()[0] == 0:
                np.savez(os.path.join(args.model_dir, "lora.npz"), **arrays)


def online_labeler(conf: dict, device, s3_ckpt: Optional[str] = None,
                   spk_ckpt: Optional[str] = None):
    """The frozen label models of a phoneme recipe -> an OnlineCodecLabeler
    on `device`: the `s3` section's S3TokenizerV2 (the full-width one by
    default) from a speech_tokenizer_v2.onnx, and the `speaker` section's
    SpeakerEmbedding from a state dict, each left at its random init
    without a checkpoint."""
    from cosyvoice_tpu_torch.models.s3tokenizer import import_s3tokenizer_onnx
    from cosyvoice_tpu_torch.models.speaker import load_speaker_embedding
    from cosyvoice_tpu_torch.train.online_codec import OnlineCodecLabeler

    s3_conf = dict(conf.get("s3", {"kind": "s3tokenizer"}))
    s3_model, s3_cfg = build_model(s3_conf.pop("kind"), s3_conf, device)
    if s3_ckpt:
        s3_model = import_s3tokenizer_onnx(s3_ckpt, s3_cfg, device)
    else:
        logging.warning("no --s3_ckpt: online codec labels from RANDOM tokenizer weights "
                        "(smoke/test runs only)")
    spk_model = None
    if "speaker" in conf:
        spk_conf = dict(conf["speaker"])
        spk_model, spk_cfg = build_model(spk_conf.pop("kind"), spk_conf, device)
        if spk_ckpt:
            spk_model = load_speaker_embedding(
                spk_cfg, torch.load(spk_ckpt, map_location="cpu", weights_only=True), device)
        else:
            logging.warning("no --spk_ckpt: RANDOM speaker-embedding weights")
        spk_model.eval()
    return OnlineCodecLabeler(s3_model=s3_model.eval(), spk_model=spk_model,
                              sample_rate=conf.get("data", {}).get("sample_rate", 24000))


def run_phoneme_llm_training(args, conf: dict, model, train_conf: dict, tokenizer, device,
                             seed: int, mesh=None, specs: Optional[dict] = None) -> None:
    """A Qwen2 phoneme LM's training over the speaker-JSON (or jsonl) corpus,
    each batch labelled online (train/online_codec.online_codec_epoch); on
    `mesh` (more than one process) each data rank over its share of the
    shards, the model sharded by `specs`."""
    from cosyvoice_tpu_torch.tokenizer.phoneme import PhonemeTokenizer
    from cosyvoice_tpu_torch.train.online_codec import online_codec_epoch

    dconf = conf.get("data", {})
    pho_tok = PhonemeTokenizer(dconf["phoneme_dict"])
    labeler = online_labeler(conf, device, args.s3_ckpt, args.spk_ckpt)
    tx = _optimizer(train_conf)
    state = make_train_state(model, tx, mesh, specs)
    step = make_train_step(phoneme_llm_loss_fn, tx, mesh)
    if latest_step(args.model_dir) is not None:
        state, at = restore_checkpoint(args.model_dir, state)
        logging.info("resumed from step %d", at)
    ex = Executor(train_step=step, model_dir=args.model_dir, device=device,
                  save_per_step=train_conf.get("save_per_step", -1),
                  log_interval=train_conf.get("log_interval", 100), rng_seed=seed, mesh=mesh)
    ex.step = state.step
    data_rank = mesh.data_rank if mesh is not None else 0
    for epoch in range(args.epochs):
        ds = make_phoneme_dataset(args.train_data, dconf, tokenizer, pho_tok, epoch,
                                  args.data_format, args.rank, args.world_size)
        state = online_codec_epoch(ex, state, labeler, iter(ds),
                                   to_device=lambda b: to_device(b, device), seed=epoch,
                                   data_rank=data_rank)


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
                          with_f0=args.model == "hift", data_format=args.data_format)
        g_state, d_state = ex.train_one_epoch_gan(g_state, d_state, ds,
                                                  to_device=lambda b: to_device(b, device))


if __name__ == "__main__":
    main()
