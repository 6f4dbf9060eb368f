"""CosyVoice2 inference pipeline: LM -> flow -> vocoder (non-streaming).

Port of cosyvoice_tpu/runtime/model.py::CosyVoice2Model for `tts(stream=False)`:
one LM decode over the whole text, one flow call over prompt ++ generated
tokens (padded to a multiple of the 50-token hop), one HiFT call over the
generated mel (padded to a multiple of 32 frames).  The decode length comes
from the smallest static bucket covering the reference's 20x-text bound,
clamped at `max_decode_tokens`, and a decode that hits that ceiling logs a
truncation warning.  `runtime/serving.py` batches the same three stages.
Streaming synthesis is not ported yet.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F

from cosyvoice_tpu_torch.device import resolve_device
from cosyvoice_tpu_torch.models.flow import CausalMaskedDiffWithXvec
from cosyvoice_tpu_torch.models.hift import HiFTGenerator
from cosyvoice_tpu_torch.models.llm import Qwen2LM, lm_generate


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _derive_decode_buckets(cap: int) -> tuple:
    """Static decode-length buckets (200, 400, ..., cap)."""
    b, bs = 200, []
    while b < cap:
        bs.append(b)
        b *= 2
    return tuple(bs) + (cap,)


def _pick_bucket(buckets: tuple, cap: int, allowed: int) -> int:
    for b in buckets:
        if allowed <= b:
            return b
    return cap


def _interp_linear(mel: np.ndarray, new_len: int) -> np.ndarray:
    """torch F.interpolate(mode='linear', align_corners=False) on [T, C]."""
    T = mel.shape[0]
    pos = (np.arange(new_len) + 0.5) * T / new_len - 0.5
    lo = np.clip(np.floor(pos).astype(int), 0, T - 1)
    hi = np.clip(lo + 1, 0, T - 1)
    w = np.clip(pos - lo, 0.0, 1.0)[:, None]
    return mel[lo] * (1 - w) + mel[hi] * w


@dataclass
class CosyVoice2Model:
    """Drives the three stages on `device` (default: the GPU)."""

    llm: Qwen2LM
    flow: CausalMaskedDiffWithXvec
    hift: HiFTGenerator
    # hard cap on generated speech tokens per segment (KV-cache ceiling)
    max_decode_tokens: int = 800
    decode_buckets: Optional[tuple] = None
    # pinned CFM noise [1, N, 80]; None uses the CFM's own seed-0 buffer
    flow_noise: Optional[torch.Tensor] = None
    device: Optional[str] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        for m in (self.llm, self.flow, self.hift):
            m.to(self.device).eval()
        if self.decode_buckets is None:
            self.decode_buckets = _derive_decode_buckets(self.max_decode_tokens)
        self.token_hop_len = 2 * self.flow.cfg.input_frame_rate      # 50
        self.ratio = self.flow.cfg.token_mel_ratio                   # 2
        self.hop_samples = self.hift.cfg.upsample_scale              # 480 at 24 kHz

    def decode_cap(self, new_text_len: int) -> int:
        allowed = int(new_text_len * self.llm.cfg.max_token_text_ratio)
        return _pick_bucket(self.decode_buckets, self.max_decode_tokens, allowed)

    def _tensor(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def llm_generate(self, text_tokens: np.ndarray, prompt_text_len: int,
                     prompt_speech_tokens: np.ndarray,
                     gen: Optional[torch.Generator]) -> np.ndarray:
        """The full AR decode; returns the emitted token ids."""
        text = self._tensor(text_tokens, torch.long)[None]
        psp = self._tensor(prompt_speech_tokens, torch.long)[None]
        new_text = text.shape[1] - prompt_text_len
        allowed = int(new_text * self.llm.cfg.max_token_text_ratio)
        cap = self.decode_cap(new_text)
        cache_len = round_up(2 + text.shape[1] + psp.shape[1] + cap, 128)
        out, count = lm_generate(
            self.llm, text, self._tensor([text.shape[1]], torch.long), psp,
            self._tensor([psp.shape[1]], torch.long),
            self._tensor([int(new_text * self.llm.cfg.min_token_text_ratio)], torch.long),
            self._tensor([min(allowed, cap)], torch.long), gen, max_steps=cap,
            cache_len=cache_len)
        n = int(count[0])
        self._warn_if_capped(n, allowed, cap)
        return out[0, :n].cpu().numpy()

    def _warn_if_capped(self, count: int, allowed: int, cap: int) -> None:
        if count >= cap and allowed > cap:
            logging.warning("LM decode TRUNCATED at the static cap: emitted %d tokens "
                            "(~%.1f s audio) but the 20x-text bound allows %d; raise "
                            "max_decode_tokens", count,
                            count / self.flow.cfg.input_frame_rate, allowed)

    def pinned_noise(self, frames: int) -> Optional[torch.Tensor]:
        """The first `frames` frames of the pinned CFM noise [1, N, 80] (None
        without one: the CFM then slices its own seed-0 buffer)."""
        if self.flow_noise is None:
            return None
        noise = torch.as_tensor(self.flow_noise)
        if noise.shape[1] < frames:
            raise ValueError(f"flow_noise buffer ({noise.shape[1]} frames) too short "
                             f"for {frames} mel frames")
        return noise[:, :frames]

    def _flow(self, tokens, prompt_tokens, prompt_feat, embedding) -> torch.Tensor:
        """Flow over prompt ++ tokens (padded to a hop multiple); returns the
        generated mel [frames, 80]."""
        tok = np.concatenate([np.asarray(prompt_tokens, np.int64),
                              np.asarray(tokens, np.int64)])
        n = len(tok)
        bucket = max(round_up(n, self.token_hop_len), self.token_hop_len)
        tok = np.pad(tok, (0, bucket - n))
        mel = self.flow.inference(self._tensor(tok, torch.long)[None],
                                  self._tensor([n], torch.long),
                                  self._tensor(prompt_feat, torch.float32)[None],
                                  self._tensor(embedding, torch.float32)[None],
                                  noise=self.pinned_noise(self.ratio * bucket))
        return mel[0, :self.ratio * (n - len(prompt_tokens))]

    def _vocode(self, mel: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        """HiFT over mel [frames, 80], padded to a multiple of 32 frames."""
        n = mel.shape[0]
        mel_pad = F.pad(mel.float(), (0, 0, 0, round_up(n, 32) - n))
        wav, _ = self.hift.inference(mel_pad[None], gen=gen)
        return wav[0, :n * self.hop_samples]

    def token2wav(self, tokens, prompt_tokens, prompt_feat, embedding,
                  speed: float = 1.0) -> np.ndarray:
        mel = self._flow(tokens, prompt_tokens, prompt_feat, embedding)
        if speed != 1.0:
            mel = self._tensor(_interp_linear(mel.cpu().numpy(),
                                              int(mel.shape[0] / speed)), torch.float32)
        # the HiFT source noise restarts per request, so a request's waveform
        # does not depend on what was synthesized before it
        return self._vocode(mel, torch.Generator().manual_seed(0)).cpu().numpy()

    def tts(self, text_tokens: np.ndarray, prompt_text_len: int,
            llm_prompt_speech_token: np.ndarray, flow_prompt_speech_token: np.ndarray,
            prompt_speech_feat: np.ndarray, flow_embedding: np.ndarray,
            stream: bool = False, speed: float = 1.0,
            gen: Optional[torch.Generator] = None) -> Iterator[dict]:
        """Yield {'tts_speech': np.ndarray [S]} (one chunk: non-streaming)."""
        if stream:
            raise NotImplementedError("streaming synthesis is not ported yet")
        if gen is None:
            gen = torch.Generator().manual_seed(time.time_ns() % (1 << 31))
        tokens = self.llm_generate(text_tokens, prompt_text_len,
                                   llm_prompt_speech_token, gen)
        yield {"tts_speech": self.token2wav(
            tokens, np.asarray(flow_prompt_speech_token, np.int64),
            np.asarray(prompt_speech_feat, np.float32),
            np.asarray(flow_embedding, np.float32), speed)}
