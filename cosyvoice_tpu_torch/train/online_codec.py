"""Online-codec training: the labels of each batch computed during training.

Port of cosyvoice_tpu/train/online_codec.py.  Each padded audio batch runs
through the frozen S3 speech tokenizer (models/s3tokenizer.S3TokenizerV2)
for its speech-token targets and, where the recipe has a speaker model,
through the frozen SpeakerEmbedding (models/speaker.py) over a 10 s crop
of each row (repeat-padded when shorter) for its speaker vectors, so no
offline labelling pass is needed.  The audio is resampled to 16 kHz on the
host, and each row's whisper log-mel (over the padded row) and both label
models run on the models' device under torch.inference_mode(), queued
ahead of the train step on the same stream; the labels stay there.  A
row's mel length is max(n16 // 160 - 1, 4) for its n16 samples at 16 kHz.

Where the JAX package takes PRNGKey(seed + i) for batch i, the port takes
a torch.Generator seeded seed + i, on the labeler's device.  On a mesh each
data rank labels its own batches: data rank r > 0 draws its posterior
samples through parallel/mesh.rank_generator(gen, r), as the train step
draws, and its crops from a numpy generator of (seed, r); the ranks of a
model group label alike.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from cosyvoice_tpu_torch.models.s3tokenizer import whisper_log_mel
from cosyvoice_tpu_torch.models.speaker import speaker_features
from cosyvoice_tpu_torch.parallel.mesh import rank_generator
from cosyvoice_tpu_torch.runtime.frontend import resample_poly


def random_crop_or_repeat(wav: np.ndarray, target_len: int,
                          rng: np.random.Generator) -> np.ndarray:
    """A target_len crop at a start drawn from rng, or the audio tiled to
    target_len when shorter."""
    if len(wav) >= target_len:
        start = int(rng.integers(0, len(wav) - target_len + 1))
        return wav[start: start + target_len]
    reps = -(-target_len // len(wav))
    return np.tile(wav, reps)[:target_len]


@dataclass
class OnlineCodecLabeler:
    """Frozen label models: a padded audio batch -> speech tokens and
    speaker vectors."""

    s3_model: torch.nn.Module                  # S3TokenizerV2, eval, on its device
    spk_model: Optional[torch.nn.Module] = None  # SpeakerEmbedding
    spk_crop_seconds: float = 10.0
    sample_rate: int = 24000

    @property
    def device(self) -> torch.device:
        return next(self.s3_model.parameters()).device

    def label_batch(self, batch: dict, rng: np.random.Generator,
                    gen: Optional[torch.Generator] = None,
                    spk_noise: Optional[list] = None) -> dict:
        """{"speech" [B, S], "speech_len" [B], ...} -> the batch with
        speech_token [B, T] / speech_token_len [B] and, with a speaker
        model, embedding [B, D], as tensors on the labeler's device.  The
        crops draw from `rng`, the posterior samples from `gen`, or
        `spk_noise` (a tensor a row) pins them."""
        speech = np.asarray(batch["speech"], np.float32)
        lens = np.asarray(batch["speech_len"])
        B, dev = speech.shape[0], self.device
        wav16 = resample_poly(speech, self.sample_rate, 16000)
        mel_lens = [max(int(lens[i] * 16000 / self.sample_rate) // 160 - 1, 4)
                    for i in range(B)]
        with torch.inference_mode():
            mels = torch.stack([whisper_log_mel(torch.as_tensor(wav16[i], device=dev),
                                                self.s3_model.cfg.n_mels) for i in range(B)])
            toks, tok_len = self.s3_model(mels, torch.tensor(mel_lens, device=dev))
            out = dict(batch, speech_token=toks, speech_token_len=tok_len)
            if self.spk_model is not None:
                crop = int(self.spk_crop_seconds * self.sample_rate)
                embs = []
                for i in range(B):
                    w = random_crop_or_repeat(speech[i, : lens[i]], crop, rng)
                    feats = speaker_features(self.spk_model.cfg, w, dev)
                    noise = None if spk_noise is None else spk_noise[i]
                    embs.append(self.spk_model.embed(*feats, noise=noise, gen=gen)[0])
                out["embedding"] = torch.stack(embs).float()
        # inference tensors cannot be saved for a backward: plain copies
        return {k: v.clone() if isinstance(v, torch.Tensor) and v.is_inference() else v
                for k, v in out.items()}


def online_codec_epoch(executor, state, labeler: OnlineCodecLabeler, audio_batches,
                       cv_batches=None, to_device=lambda b: b, seed: int = 0,
                       data_rank: int = 0):
    """One epoch of `executor` over audio_batches, each labelled first: its
    crops from np.random.default_rng(seed), its posterior samples from a
    generator seeded seed + i for batch i (data rank `data_rank`'s draws of
    them on a mesh)."""
    rng = np.random.default_rng(seed if data_rank == 0 else (seed, data_rank))

    def labeled(it):
        for i, b in enumerate(it):
            gen = torch.Generator(device=labeler.device).manual_seed(seed + i)
            yield labeler.label_batch(b, rng, rank_generator(gen, data_rank))

    cv = list(labeled(cv_batches)) if cv_batches is not None else None
    return executor.train_one_epoch(state, labeled(audio_batches), cv_data=cv,
                                    to_device=to_device)
