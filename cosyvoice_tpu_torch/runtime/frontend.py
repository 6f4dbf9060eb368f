"""Frontend: text -> tokens, prompt audio -> (speech tokens, mel, speaker vector).

Port of cosyvoice_tpu/runtime/frontend.py: the model inputs of the sft
(a registered speaker's vector from `spk2info`), zero-shot, cross-lingual,
instruct2 (CosyVoice2), instruct (CosyVoice v1) and voice-conversion
modes.  The speech tokenizer and speaker embedder are injected callables
(`runtime/api.from_pretrained` wires the port's S3 tokenizer and CAMPPlus);
the 24 kHz prompt mel comes from ops/mel on `device` (the GPU unless the caller passes "cpu"); CosyVoice v1 uses
sample_rate 22050, mel_n_fft 1024, mel_hop 256.  `text_normalizer`
replaces the built-in text normalization.  Zero-shot keeps feat ==
2 * token length at 24 kHz.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from math import gcd
from typing import Callable, Optional, Union

import numpy as np
import torch

from cosyvoice_tpu_torch.device import resolve_device
from cosyvoice_tpu_torch.ops.mel import log_mel_spectrogram
from cosyvoice_tpu_torch.runtime import textnorm


def resample_poly(x: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    from scipy.signal import resample_poly as _rp

    g = gcd(orig_sr, new_sr)
    return _rp(x, new_sr // g, orig_sr // g, axis=-1).astype(np.float32)


@dataclass
class CosyVoiceFrontEnd:
    tokenizer: object                              # .encode(text) -> ids
    speech_tokenizer: Optional[Callable] = None    # wav16k [S] -> token ids [T]
    spk_embedder: Optional[Callable] = None        # wav16k [S] -> vector [D]
    spk2info: dict = field(default_factory=dict)   # spk_id -> {"embedding": vector}
    sample_rate: int = 24000
    n_mels: int = 80
    mel_n_fft: int = 1920
    mel_hop: int = 480
    device: Union[str, torch.device, None] = None  # None: the GPU
    text_normalizer: Optional[Callable] = None     # (text, split) -> list[str] | str

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _extract_text_token(self, text: str) -> np.ndarray:
        return np.asarray(self.tokenizer.encode(text), np.int32)

    def _extract_speech_feat(self, speech: np.ndarray) -> np.ndarray:
        wav = torch.as_tensor(speech[None], dtype=torch.float32, device=self.device)
        mel = log_mel_spectrogram(wav, n_fft=self.mel_n_fft, n_mels=self.n_mels,
                                  sr=self.sample_rate, hop=self.mel_hop,
                                  win=self.mel_n_fft, fmax=min(8000.0, self.sample_rate / 2))
        return mel[0].T.cpu().numpy()  # [T, n_mels]

    def _extract_speech_token(self, speech_16k: np.ndarray) -> np.ndarray:
        if self.speech_tokenizer is None:
            raise ValueError("no speech tokenizer wired")
        if len(speech_16k) / 16000 > 30:
            raise ValueError("prompt audio must be <= 30 s")
        return np.asarray(self.speech_tokenizer(speech_16k), np.int32)

    def _extract_spk_embedding(self, speech_16k: np.ndarray) -> np.ndarray:
        if self.spk_embedder is None:
            raise ValueError("no speaker embedder wired")
        return np.asarray(self.spk_embedder(speech_16k), np.float32)

    def text_normalize(self, text: str, split: bool = True):
        """The segments of `text` (its normalized string with split=False),
        by `text_normalizer` when one is given, else textnorm's rules."""
        if self.text_normalizer is not None:
            return self.text_normalizer(text, split)
        return textnorm.basic_normalize(text, self.tokenizer.encode, split)

    def frontend_sft(self, tts_text: str, spk_id: str) -> dict:
        emb = np.asarray(self.spk2info[spk_id]["embedding"], np.float32)
        return {"text": self._extract_text_token(tts_text), "llm_embedding": emb,
                "flow_embedding": emb}

    def frontend_zero_shot(self, tts_text: str, prompt_text: str,
                           prompt_speech_16k: np.ndarray) -> dict:
        text = self._extract_text_token(tts_text)
        ptext = self._extract_text_token(prompt_text)
        feat = self._extract_speech_feat(
            resample_poly(prompt_speech_16k, 16000, self.sample_rate))
        token = self._extract_speech_token(prompt_speech_16k)
        if self.sample_rate == 24000:
            n = min(feat.shape[0] // 2, len(token))
            feat, token = feat[: 2 * n], token[:n]
        emb = self._extract_spk_embedding(prompt_speech_16k)
        return {"text": text, "prompt_text": ptext,
                "llm_prompt_speech_token": token, "flow_prompt_speech_token": token,
                "prompt_speech_feat": feat, "llm_embedding": emb, "flow_embedding": emb}

    def frontend_cross_lingual(self, tts_text: str, prompt_speech_16k: np.ndarray) -> dict:
        """Zero-shot inputs without the prompt text and the LM's prompt speech."""
        d = self.frontend_zero_shot(tts_text, "", prompt_speech_16k)
        del d["prompt_text"], d["llm_prompt_speech_token"]
        return d

    def frontend_instruct2(self, tts_text: str, instruct_text: str,
                           prompt_speech_16k: np.ndarray) -> dict:
        """The instruction as the prompt text; the LM gets no prompt speech."""
        d = self.frontend_zero_shot(tts_text, instruct_text + "<|endofprompt|>",
                                    prompt_speech_16k)
        del d["llm_prompt_speech_token"]
        return d

    def frontend_instruct(self, tts_text: str, spk_id: str, instruct_text: str) -> dict:
        """CosyVoice v1's instruct mode: the sft inputs without the LM's
        speaker vector (the instruction carries the style), the instruction
        (ended by "<endofprompt>") as the prompt text."""
        d = self.frontend_sft(tts_text, spk_id)
        del d["llm_embedding"]
        d["prompt_text"] = self._extract_text_token(instruct_text + "<endofprompt>")
        return d

    def frontend_vc(self, source_speech_16k: np.ndarray,
                    prompt_speech_16k: np.ndarray) -> dict:
        """Voice conversion: the source's speech tokens, re-synthesized in the
        prompt's voice (no LM stage)."""
        feat = self._extract_speech_feat(
            resample_poly(prompt_speech_16k, 16000, self.sample_rate))
        return {"source_speech_token": self._extract_speech_token(source_speech_16k),
                "flow_prompt_speech_token": self._extract_speech_token(prompt_speech_16k),
                "prompt_speech_feat": feat,
                "flow_embedding": self._extract_spk_embedding(prompt_speech_16k)}
