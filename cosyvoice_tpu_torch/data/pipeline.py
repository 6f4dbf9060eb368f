"""Composable streaming data pipeline for training (host side, numpy).
Port of cosyvoice_tpu/data/pipeline.py, over the port's own log-mel
(ops/mel.py), resampler (runtime/frontend.resample_poly), WAV reader
(bin/inference.read_wav) and parquet reader (data/parquet_io.py).

A pipeline is a source iterable and a chain of stages, each a function
from an iterator of samples to an iterator; the last stages batch the
samples and pad them into numpy arrays whose lengths round up to a bucket
multiple.  The sources: jsonl shards (`jsonl_opener`), parquet shards
(`parquet_opener`, then `decode_audio_bytes` and `parse_embedding`),
speaker-keyed JSON corpora (`spk_json_source`) and kaldi directories
(`kaldi_dir_source`).  The vocoders' stages: `compute_f0` (HiFT's pitch
targets, ops/f0.py) and `padding(gan=...)`'s waveform rows.  The phoneme
LMs' stages: `truncate_phoneme_sequence` (an MFA-aligned crop at a prosody
mark), `tokenize_phoneme` and `padding`'s pho_token [B, T, 4] streams.
Every random stage draws as the JAX one does (`truncate` from the global
`random` module, the others from a seeded random.Random), so both packages
give the same samples.
"""
from __future__ import annotations

import io
import json
import logging
import os
import random
import wave
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


def parquet_opener(it):
    """Paths of parquet shards -> their rows as sample dicts (a shard that
    fails to open is skipped with a warning)."""
    from cosyvoice_tpu_torch.data.parquet_io import parquet_opener as _opener

    yield from _opener(it)


def decode_audio_bytes():
    """A parquet row's `audio_data` (16-bit PCM WAV bytes) -> speech +
    sample_rate; a row whose bytes are not such a WAV is dropped with a
    warning."""

    def stage(it):
        for s in it:
            if "audio_data" in s and "speech" not in s:
                try:
                    with wave.open(io.BytesIO(s["audio_data"])) as w:
                        sr = w.getframerate()
                        data = np.frombuffer(w.readframes(w.getnframes()), dtype=np.int16)
                        if w.getnchannels() > 1:
                            data = data.reshape(-1, w.getnchannels()).mean(axis=1)
                except (wave.Error, EOFError, ValueError) as e:
                    logging.warning("decode_audio_bytes: dropping %s (%s)",
                                    s.get("utt", "<sample>"), e)
                    continue
                s = dict(s, speech=data.astype(np.float32) / 32768.0, sample_rate=sr)
                s.pop("audio_data")
            yield s

    return stage


def parse_embedding(normalize: bool = True):
    """utt_embedding / spk_embedding list columns -> float32 vectors
    (L2-normalised, the norm floored at 1e-12); `embedding` defaults to the
    utt_embedding."""

    def stage(it):
        for s in it:
            for k in ("utt_embedding", "spk_embedding"):
                if k in s:
                    v = np.asarray(s[k], np.float32)
                    if normalize:
                        v = v / max(float(np.linalg.norm(v)), 1e-12)
                    s[k] = v
            if "utt_embedding" in s:
                s.setdefault("embedding", s["utt_embedding"])
            yield s

    return stage


def kaldi_dir_source(data_dir: str):
    """A kaldi directory (wav.scp, and text / utt2spk where present) -> one
    sample an utterance of wav.scp: utt, speech, sample_rate, text ("" when
    absent) and spk (the utt when absent)."""
    from cosyvoice_tpu_torch.bin.inference import read_wav

    def read_map(name):
        path = os.path.join(data_dir, name)
        out = {}
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    parts = line.strip().split(maxsplit=1)
                    if len(parts) == 2:
                        out[parts[0]] = parts[1]
        return out

    texts, utt2spk = read_map("text"), read_map("utt2spk")
    for utt, path in read_map("wav.scp").items():
        wav, sr = read_wav(path)
        yield {"utt": utt, "speech": wav, "sample_rate": sr, "text": texts.get(utt, ""),
               "spk": utt2spk.get(utt, utt)}


def spk_json_source(json_paths, rng_seed: int = 0, rich_sample_short_utt: bool = False):
    """Speaker-keyed JSON corpora: each file maps spk -> a list of {utt,
    wav, text, phoneme, durations, embedding, ...}.  A file's utterances
    come shuffled by a random.Random(rng_seed) that runs on across files;
    with rich_sample_short_utt an utterance under 2 s comes twice."""
    from cosyvoice_tpu_torch.bin.inference import read_wav

    r = random.Random(rng_seed)
    for path in json_paths:
        with open(path) as f:
            data = json.load(f)
        items = [(spk, u) for spk, utts in data.items() for u in utts]
        r.shuffle(items)
        for spk, u in items:
            wav, sr = read_wav(u["wav"])
            sample = {"utt": u.get("utt", u["wav"]), "speech": wav, "sample_rate": sr,
                      "spk": spk, "text": u.get("text", "")}
            for k in ("phoneme", "durations"):
                if k in u:
                    sample[k] = u[k]
            if "embedding" in u:
                sample["embedding"] = np.asarray(u["embedding"], np.float32)
            yield sample
            if rich_sample_short_utt and len(wav) / sr < 2.0:
                yield dict(sample)


def truncate(max_seconds: float = 30.0):
    """A random crop of audio longer than max_seconds, its start drawn from
    the global `random` module."""

    def stage(it):
        for s in it:
            limit = int(max_seconds * s["sample_rate"])
            if len(s["speech"]) > limit:
                start = random.randint(0, len(s["speech"]) - limit)
                s["speech"] = s["speech"][start: start + limit]
            yield s

    return stage


def truncate_phoneme_sequence(prob: float = 0.5, prosody_weights: Optional[dict] = None,
                              prosody_len: Optional[dict] = None, min_len: int = 2,
                              min_dur: float = 0.08, seed: int = 0):
    """With probability `prob` (a random.Random(seed) draw), crop a sample
    at a prosody mark (#1 / #2 / #3 past index min_len, drawn by weight):
    the audio up to the summed MFA durations through the mark, then the
    mark's silence, and the phonemes through the mark.  A sample drawn for
    the crop is dropped when its audio outlasts its durations by more than
    0.2 s or its phoneme and duration counts differ.  Needs `phoneme` and
    `durations`; other samples pass unchanged.  The durations are dropped."""
    prosody_weights = prosody_weights or {"#1": 0.5, "#2": 1.0, "#3": 1.0}
    prosody_len = prosody_len or {"#1": 0.001, "#2": 0.25, "#3": 0.35}

    def stage(it):
        r = random.Random(seed)
        for s in it:
            pho, dur = s.get("phoneme"), s.get("durations")
            if pho is None or dur is None:
                yield s
                continue
            if isinstance(pho, str):
                pho = pho.split()
            wav, sr = s["speech"], s["sample_rate"]
            if r.random() < prob:
                if len(wav) / sr - float(np.sum(dur)) > 0.2:
                    continue
                if len(pho) != len(dur):
                    continue
                idxs = [i for i, x in enumerate(pho) if x in prosody_weights and i > min_len]
                if idxs:
                    i = r.choices(idxs, [prosody_weights[pho[j]] for j in idxs])[0]
                    d = float(np.sum(np.asarray(dur[: i + 1], np.float64)))
                    if d > min_dur:
                        wav = np.pad(wav[: int(d * sr)], (0, int(prosody_len[pho[i]] * sr)))
                        pho = pho[: i + 1]
            out = dict(s, phoneme=pho, speech=wav)
            out.pop("durations", None)
            yield out

    return stage


def tokenize_phoneme(tokenizer, drop_bad: bool = True):
    """Phoneme strings -> the factored id lists pho_token, text_tone,
    text_lang, text_prsd (tokenizer/phoneme.PhonemeTokenizer.encode); a
    sample with an unknown phoneme is dropped with a warning (or, with
    drop_bad False, raises)."""

    def stage(it):
        for s in it:
            pho = s.get("phoneme")
            if pho is None:
                yield s
                continue
            if isinstance(pho, str):
                pho = pho.split()
            try:
                pho_ids, tone_ids, lang_ids, prsd_ids = tokenizer.encode(pho)
            except (KeyError, ValueError, IndexError) as e:
                logging.warning("%s: phoneme encode failed (%s), dropped", s.get("utt", "?"), e)
                if drop_bad:
                    continue
                raise
            yield dict(s, pho_token=pho_ids, text_tone=tone_ids, text_lang=lang_ids,
                       text_prsd=prsd_ids)

    return stage


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


def padding(bucket_multiple=32, static_lens: Optional[dict] = None, gan=False,
            use_spk_embedding: bool = False):
    """A list of samples -> a padded numpy batch, longest mel first: mel
    rows round up to bucket_multiple, speech tokens to half of it, text and
    phonemes to 8; `static_lens` pins a key's padded length (a sample past
    its pin raises).  Factored phoneme ids (pho_token, text_tone, text_lang,
    text_prsd) stack into pho_token [B, T, 4] with pho_token_len.  The
    embedding rows are each sample's `embedding`, or with use_spk_embedding
    its `spk_embedding` where it has one.  `gan` (True, or a hop in samples;
    True is 480) adds the waveform rows: speech cut or zero-padded to L *
    hop samples for L mel rows, speech_len, and pitch_feat padded to L
    where the samples have it."""
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
            if "text_tone" in samples[0]:
                pho_len = np.asarray([len(s["pho_token"]) for s in samples], np.int32)
                Lp = pad_len("pho_token", int(pho_len.max()), 8)
                batch["pho_token"] = np.stack(
                    [_pad_to([np.asarray(s[k], np.int32) for s in samples], Lp)
                     for k in ("pho_token", "text_tone", "text_lang", "text_prsd")], axis=-1)
                batch["pho_token_len"] = pho_len
            if "embedding" in samples[0]:
                key = "spk_embedding" if use_spk_embedding else "embedding"
                batch["embedding"] = np.stack(
                    [np.asarray(s.get(key, s["embedding"]), np.float32) for s in samples])
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
