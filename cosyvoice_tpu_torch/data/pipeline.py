"""Composable streaming data pipeline for training (host side, numpy).
Port of cosyvoice_tpu/data/pipeline.py: the stages of the jsonl corpus
path (bin/train.py --data_format jsonl), over the port's own log-mel
(ops/mel.py) and resampler (runtime/frontend.resample_poly).

A pipeline is a source iterable and a chain of stages, each a function
from an iterator of samples to an iterator; the last stages batch the
samples and pad them into numpy arrays whose lengths round up to a bucket
multiple.  The vocoders' stages are here too: `compute_f0` (HiFT's pitch
targets, ops/f0.py) and `padding(gan=...)`'s waveform rows.  The parquet
and speaker-JSON sources and the phoneme stages come with the phoneme
LMs' training (ROADMAP Queue 1 item 10c).
"""
from __future__ import annotations

import json
import random
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch


class Pipeline:
    """source iterable + chain of generator transforms."""

    def __init__(self, source: Iterable, *stages: Callable):
        self.source = source
        self.stages = list(stages)

    def __iter__(self) -> Iterator:
        it = iter(self.source)
        for stage in self.stages:
            it = stage(it)
        return it


def shard_list(items: list, rank: int, world_size: int, shuffle: bool = True,
               seed: int = 0, epoch: int = 0) -> list:
    """The shard list, shuffled by (seed + epoch), every world_size-th from rank."""
    items = list(items)
    if shuffle:
        random.Random(seed + epoch).shuffle(items)
    return items[rank::world_size]


# ---- stages (each: iterator -> iterator) ---------------------------------

def jsonl_opener(it):
    """Paths of jsonl files -> sample dicts; 'speech' is an inline list of
    samples or the path of a 16-bit PCM WAV."""
    from cosyvoice_tpu_torch.bin.inference import read_wav

    for path in it:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                s = json.loads(line)
                if isinstance(s.get("speech"), str):
                    s["speech"], s["sample_rate"] = read_wav(s["speech"])
                elif isinstance(s.get("speech"), list):
                    s["speech"] = np.asarray(s["speech"], np.float32)
                yield s


def filter_samples(max_length=10240, min_length=10, token_max_length=200,
                   token_min_length=1, min_output_input_ratio=0.0005,
                   max_output_input_ratio=30.0):
    """Length and ratio gates; lengths in 10 ms frames."""

    def stage(it):
        for s in it:
            dur_frames = len(s["speech"]) / s["sample_rate"] * 100
            if not (min_length <= dur_frames <= max_length):
                continue
            if "text_token" in s:
                n = len(s["text_token"])
                if not (token_min_length <= n <= token_max_length):
                    continue
                r = n / dur_frames
                if not (min_output_input_ratio <= r <= max_output_input_ratio):
                    continue
            yield s

    return stage


def resample(target_sr=24000, min_sample_rate=16000):
    """To target_sr (samples below min_sample_rate are dropped), then peak
    normalization where the peak exceeds 1."""

    def stage(it):
        from cosyvoice_tpu_torch.runtime.frontend import resample_poly

        for s in it:
            sr = s["sample_rate"]
            if sr != target_sr:
                if sr < min_sample_rate:
                    continue
                s["speech"] = resample_poly(s["speech"], sr, target_sr)
                s["sample_rate"] = target_sr
            peak = np.abs(s["speech"]).max()
            if peak > 1.0:
                s["speech"] = s["speech"] / peak
            yield s

    return stage


def compute_fbank(n_fft=1920, hop=480, n_mels=80, sr=24000, win: Optional[int] = None,
                  fmin: float = 0.0, fmax: float = 8000.0):
    """The canonical log-mel -> speech_feat [T, n_mels] float32 (win, fmin
    and fmax are the recipes' keys; win must equal n_fft)."""
    from cosyvoice_tpu_torch.ops.mel import log_mel_spectrogram

    def stage(it):
        for s in it:
            y = torch.as_tensor(np.asarray(s["speech"], np.float32))[None]
            mel = log_mel_spectrogram(y, n_fft=n_fft, n_mels=n_mels, sr=sr, hop=hop,
                                      win=win or n_fft, fmin=fmin, fmax=fmax)
            s["speech_feat"] = mel[0].T.numpy().astype(np.float32)
            yield s

    return stage


def compute_f0(sr=24000, frame=1024, hop=480):
    """Pitch targets: autocorr_f0 of the speech, interpolated to the mel
    length -> pitch_feat [T_mel] float32."""
    from cosyvoice_tpu_torch.ops.f0 import autocorr_f0, interp_to_len

    def stage(it):
        for s in it:
            f0 = autocorr_f0(torch.as_tensor(np.asarray(s["speech"], np.float32)), sr=sr,
                             frame=frame, hop=hop)
            s["pitch_feat"] = interp_to_len(f0, s["speech_feat"].shape[0]).numpy().astype(
                np.float32)
            yield s

    return stage


def tokenize(tokenizer):
    def stage(it):
        for s in it:
            s["text_token"] = np.asarray(tokenizer.encode(s["text"]), np.int32)
            yield s

    return stage


def shuffle(buf_size=10000, seed=0):
    def stage(it):
        rng = random.Random(seed)
        buf = []
        for s in it:
            buf.append(s)
            if len(buf) >= buf_size:
                rng.shuffle(buf)
                yield from buf
                buf = []
        rng.shuffle(buf)
        yield from buf

    return stage


def sort_by_feat_len(buf_size=500):
    """A local sort by mel length, so batches hold similar lengths."""

    def stage(it):
        buf = []
        for s in it:
            buf.append(s)
            if len(buf) >= buf_size:
                buf.sort(key=lambda x: x["speech_feat"].shape[0])
                yield from buf
                buf = []
        buf.sort(key=lambda x: x["speech_feat"].shape[0])
        yield from buf

    return stage


def static_batch(batch_size=8, drop_last=False):
    def stage(it):
        buf = []
        for s in it:
            buf.append(s)
            if len(buf) >= batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return stage


def dynamic_batch(max_frames_in_batch=2000):
    """Batch until the padded frames (longest x count) would exceed the cap."""

    def stage(it):
        buf, longest = [], 0
        for s in it:
            n = s["speech_feat"].shape[0]
            longest = max(longest, n)
            if longest * (len(buf) + 1) > max_frames_in_batch and buf:
                yield buf
                buf, longest = [], n
            buf.append(s)
        if buf:
            yield buf

    return stage


def _pad_to(arrs: list, length: int, value=0) -> np.ndarray:
    out = np.full((len(arrs), length) + arrs[0].shape[1:], value, dtype=arrs[0].dtype)
    for i, a in enumerate(arrs):
        out[i, : len(a)] = a
    return out


def round_up(n, m):
    return ((n + m - 1) // m) * m


def padding(bucket_multiple=32, static_lens: Optional[dict] = None, gan=False):
    """A list of samples -> a padded numpy batch, longest mel first: mel
    rows round up to bucket_multiple, speech tokens to half of it, text to
    8; `static_lens` pins a key's padded length (a sample past its pin
    raises).  `gan` (True, or a hop in samples; True is 480) adds the
    waveform rows: speech cut or zero-padded to L * hop samples for L mel
    rows, speech_len, and pitch_feat padded to L where the samples have
    it."""
    static_lens = static_lens or {}

    def pad_len(key, longest, multiple):
        if key in static_lens:
            assert longest <= static_lens[key], (
                f"{key}: sample length {longest} exceeds static_lens pin "
                f"{static_lens[key]}; tighten filter_samples")
            return static_lens[key]
        return round_up(longest, multiple)

    def stage(it):
        for samples in it:
            samples = sorted(samples, key=lambda s: s["speech_feat"].shape[0], reverse=True)
            batch = {"utts": [s.get("utt", "") for s in samples]}
            feat_len = np.asarray([s["speech_feat"].shape[0] for s in samples], np.int32)
            L = pad_len("speech_feat", int(feat_len.max()), bucket_multiple)
            batch["speech_feat"] = _pad_to([s["speech_feat"] for s in samples], L)
            batch["speech_feat_len"] = feat_len
            if "speech_token" in samples[0]:
                tok_len = np.asarray([len(s["speech_token"]) for s in samples], np.int32)
                Lt = pad_len("speech_token", int(tok_len.max()), bucket_multiple // 2)
                batch["speech_token"] = _pad_to(
                    [np.asarray(s["speech_token"], np.int32) for s in samples], Lt)
                batch["speech_token_len"] = tok_len
            if "text_token" in samples[0]:
                txt_len = np.asarray([len(s["text_token"]) for s in samples], np.int32)
                Lx = pad_len("text_token", int(txt_len.max()), 8)
                batch["text_token"] = _pad_to(
                    [np.asarray(s["text_token"], np.int32) for s in samples], Lx)
                batch["text_token_len"] = txt_len
            if "embedding" in samples[0]:
                batch["embedding"] = np.stack(
                    [np.asarray(s["embedding"], np.float32) for s in samples])
            if gan:
                Ls = L * (480 if gan is True else int(gan))
                batch["speech"] = _pad_to([np.asarray(s["speech"][:Ls], np.float32)
                                           for s in samples], Ls)
                batch["speech_len"] = np.minimum(
                    np.asarray([len(s["speech"]) for s in samples], np.int32), Ls)
                if "pitch_feat" in samples[0]:
                    batch["pitch_feat"] = _pad_to(
                        [np.asarray(s["pitch_feat"], np.float32) for s in samples], L)
            yield batch

    return stage
