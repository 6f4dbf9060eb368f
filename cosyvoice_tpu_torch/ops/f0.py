"""F0 (pitch) targets for the HiFT GAN's f0 loss.  Port of
cosyvoice_tpu/ops/f0.py: a normalized-autocorrelation tracker over framed
audio, then linear interpolation to the mel length.  fp32 throughout, as
the JAX package computes it; the argmax over lags takes the first of equal
maxima, as jnp.argmax does."""
from __future__ import annotations

import torch


def autocorr_f0(wav: torch.Tensor, sr: int = 24000, frame: int = 1024, hop: int = 480,
                fmin: float = 60.0, fmax: float = 400.0) -> torch.Tensor:
    """wav [S] -> f0 [T] in Hz, 0 where unvoiced (peak correlation <= 0.5
    or mean energy <= 1e-6); T = max((S - frame) // hop + 1, 1)."""
    wav = wav.float()
    S = wav.shape[-1]
    T = max((S - frame) // hop + 1, 1)
    idx = torch.arange(T, device=wav.device)[:, None] * hop + torch.arange(
        frame, device=wav.device)[None, :]
    # an index past the end clamps, as a JAX gather does
    frames = wav[idx.clamp(max=S - 1)]
    frames = frames - frames.mean(dim=-1, keepdim=True)
    lag_min = int(sr / fmax)
    lag_max = min(int(sr / fmin), frame - 1)
    energy = torch.sum(frames * frames, dim=-1) + 1e-9
    corrs = []
    for lag in range(lag_min, lag_max):
        a, b = frames[:, :frame - lag], frames[:, lag:]
        corrs.append(torch.sum(a * b, dim=-1)
                     / (torch.sqrt(torch.sum(a * a, -1) * torch.sum(b * b, -1)) + 1e-9))
    corr = torch.stack(corrs, dim=-1)                     # [T, n_lags]
    peak, best = corr.max(dim=-1)
    # torch.max may return any index of a tied maximum: take the first
    lags = torch.arange(corr.shape[-1], device=wav.device)
    best = torch.where(corr == peak[:, None], lags, corr.shape[-1]).amin(dim=-1)
    # a tensor over a tensor: torch takes `scalar / tensor` as the scalar times
    # the reciprocal, one rounding more than the JAX package's division
    lag = (lag_min + best).float()
    f0 = torch.full_like(lag, float(sr)) / lag
    voiced = (peak > 0.5) & (energy / frame > 1e-6)
    return torch.where(voiced, f0, torch.zeros_like(f0))


def interp_to_len(x: torch.Tensor, new_len: int) -> torch.Tensor:
    """Linear interpolation [T] -> [new_len] at half-sample centres."""
    T = x.shape[0]
    pos = (torch.arange(new_len, device=x.device, dtype=torch.float32) + 0.5) * T / new_len - 0.5
    lo = torch.floor(pos).long().clamp(0, T - 1)
    hi = (lo + 1).clamp(0, T - 1)
    w = (pos - lo).clamp(0.0, 1.0)
    return x[lo] * (1 - w) + x[hi] * w
