"""Kaldi-compatible fbank features (torchaudio.compliance.kaldi.fbank at the
reference's arguments: 80 bins, 16 kHz, dither 0).

Port of cosyvoice_tpu/ops/kaldi.py: int16-scaled samples, 25 ms frames at a
10 ms shift with snip-edges, per-frame DC removal, pre-emphasis 0.97 (the
first sample against itself), the Povey window, the power spectrum of a
512-point rfft, HTK-mel triangular banks (20 Hz to Nyquist) and a natural
log floored at 1.1921e-7.  Runs on the device of `wav`.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


@lru_cache(maxsize=None)
def _povey_window(n: int) -> np.ndarray:
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / (n - 1))
    return (hann ** 0.85).astype(np.float32)


def _mel(f):
    return 1127.0 * np.log(1.0 + f / 700.0)


@lru_cache(maxsize=None)
def _kaldi_mel_banks(num_bins: int, fft_len: int, sr: int,
                     low_freq: float = 20.0, high_freq: float = 0.0) -> np.ndarray:
    """[num_bins, fft_len//2+1] triangular banks on the HTK mel scale."""
    nyq = sr / 2.0
    high = nyq + high_freq if high_freq <= 0 else high_freq
    mel_low, mel_high = _mel(low_freq), _mel(high)
    delta = (mel_high - mel_low) / (num_bins + 1)
    mel_f = _mel(np.arange(fft_len // 2 + 1) * sr / fft_len)
    banks = np.zeros((num_bins, len(mel_f)), np.float32)
    for b in range(num_bins):
        left = mel_low + b * delta
        center, right = left + delta, left + 2 * delta
        up = (mel_f - left) / (center - left)
        down = (right - mel_f) / (right - center)
        banks[b] = np.maximum(0.0, np.minimum(up, down))
    return banks


def kaldi_fbank(wav: torch.Tensor, num_mel_bins: int = 80, sr: int = 16000,
                frame_length_ms: float = 25.0, frame_shift_ms: float = 10.0,
                preemphasis: float = 0.97, remove_dc: bool = True,
                eps: float = 1.1921e-7) -> torch.Tensor:
    """wav [S] float in [-1, 1] -> [T, num_mel_bins] log-mel, T = 1 + (S - 400) // 160."""
    wav = wav.float() * 32768.0
    flen = int(sr * frame_length_ms / 1000)
    shift = int(sr * frame_shift_ms / 1000)
    frames = wav.unfold(0, flen, shift)                          # [T, flen]
    if remove_dc:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    pre = torch.cat([frames[:, :1], frames[:, :-1]], dim=-1)
    frames = frames - preemphasis * pre
    frames = frames * torch.as_tensor(_povey_window(flen), device=wav.device)
    nfft = _next_pow2(flen)
    spec = torch.fft.rfft(F.pad(frames, (0, nfft - flen)), dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    banks = torch.as_tensor(_kaldi_mel_banks(num_mel_bins, nfft, sr), device=wav.device)
    return torch.log((power @ banks.T).clamp_min(eps))
