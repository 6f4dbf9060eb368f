"""HiFT vocoder: neural-source-filter + iSTFT-net hybrid (mel -> waveform).

Port of cosyvoice_tpu/models/hift.py.  Parity notes kept from the JAX
package: the activation before conv_post is leaky_relu with slope 0.01 (not
lrelu_slope); reflection-pad (1, 0) follows the LAST upsample only; the
magnitude is clipped at 1e2 before the iSTFT (its log clamped at 5 first:
the same values, but a log-magnitude past exp's fp32 range gets a zero
gradient, where the JAX package's min(exp(x), 1e2) gets NaN).
The f0 predictor, the sine source and the iSTFT head stay fp32; the conv
stack runs in `dtype`.
The NSF source's random phases and noise come from an explicit
torch.Generator (drawn on that generator's device), or from one generator a
row so that a batched call draws each row's noise as its own B=1 call would;
`deterministic` zeroes them for parity tests.  Parameter names follow the reference checkpoint.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from cosyvoice_tpu_torch.nn.conv import Conv1d, ConvTranspose1d
from cosyvoice_tpu_torch.nn.dense import Dense
from cosyvoice_tpu_torch.ops.activations import snake
from cosyvoice_tpu_torch.ops.stft import hann_window, istft, stft

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# log-magnitudes are clamped here before exp: exp(5) > the 1e2 clip, so the
# clipped magnitude is unchanged, and exp never overflows to inf (whose
# product with the clip's zero gradient is NaN)
MAG_LOG_CAP = 5.0


@dataclass(frozen=True)
class HiFTConfig:
    in_channels: int = 80
    base_channels: int = 512
    nb_harmonics: int = 8
    sampling_rate: int = 24000
    nsf_alpha: float = 0.1
    nsf_sigma: float = 0.003
    nsf_voiced_threshold: float = 10.0
    upsample_rates: Sequence[int] = (8, 5, 3)
    upsample_kernel_sizes: Sequence[int] = (16, 11, 7)
    istft_n_fft: int = 16
    istft_hop_len: int = 4
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    source_resblock_kernel_sizes: Sequence[int] = (7, 7, 11)
    source_resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    lrelu_slope: float = 0.1
    audio_limit: float = 0.99
    f0_cond_channels: int = 512
    dtype: str = "float32"        # conv-stack compute dtype
    approx_sin: bool = False      # polynomial sine in the snake activations

    @property
    def upsample_scale(self) -> int:
        return int(np.prod(self.upsample_rates)) * self.istft_hop_len


class Snake(nn.Module):
    def __init__(self, channels: int, approx_sin: bool = False):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(channels))
        self.approx_sin = approx_sin

    def forward(self, x):
        return snake(x, self.alpha, approx_sin=self.approx_sin)


class ResBlock(nn.Module):
    """MRF residual block: (snake -> dilated conv -> snake -> conv) per dilation."""

    def __init__(self, channels: int, kernel_size: int, dilations: Sequence[int],
                 approx_sin: bool = False):
        super().__init__()
        pad = lambda d: (kernel_size * d - d) // 2
        self.convs1 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, padding=pad(d), dilation=d,
                   weight_norm=True) for d in dilations)
        self.convs2 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, padding=pad(1), weight_norm=True)
            for _ in dilations)
        self.activations1 = nn.ModuleList(Snake(channels, approx_sin) for _ in dilations)
        self.activations2 = nn.ModuleList(Snake(channels, approx_sin) for _ in dilations)

    def forward(self, x):
        for c1, c2, a1, a2 in zip(self.convs1, self.convs2, self.activations1,
                                  self.activations2):
            x = x + c2(a2(c1(a1(x))))
        return x


class ConvRNNF0Predictor(nn.Module):
    """mel [B, T, in] -> f0 [B, T] (Hz)."""

    def __init__(self, in_channels: int, cond_channels: int):
        super().__init__()
        layers = []
        for i in range(5):
            layers += [Conv1d(in_channels if i == 0 else cond_channels, cond_channels, 3,
                              padding=1, weight_norm=True), nn.ELU()]
        self.condnet = nn.ModuleList(layers)
        self.classifier = Dense(cond_channels, 1)

    def forward(self, mel):
        x = mel
        for layer in self.condnet:
            x = layer(x)
        return torch.abs(self.classifier(x)[..., 0])


class SourceModuleHnNSF(nn.Module):
    """f0 [B, L] at the sample rate -> harmonic source [B, L, 1]."""

    def __init__(self, cfg: HiFTConfig, deterministic: bool = False):
        super().__init__()
        self.cfg, self.deterministic = cfg, deterministic
        self.l_linear = Dense(cfg.nb_harmonics + 1, 1)

    def forward(self, f0: torch.Tensor, gen: Optional[torch.Generator] = None):
        cfg = self.cfg
        H = cfg.nb_harmonics + 1
        harm = torch.arange(1, H + 1, dtype=f0.dtype, device=f0.device)
        fmat = f0[..., None] * harm / cfg.sampling_rate
        theta = 2.0 * np.pi * (torch.cumsum(fmat, dim=1) % 1.0)
        if self.deterministic:
            phase = torch.zeros((f0.shape[0], 1, H), dtype=f0.dtype, device=f0.device)
            noise_unit = torch.zeros_like(theta)
        else:
            if gen is None:
                raise ValueError("a non-deterministic HiFT needs a torch.Generator")
            # one generator for the batch, or one a row (each row then draws
            # what a B=1 call on its generator draws)
            gens = list(gen) if isinstance(gen, (list, tuple)) else None
            if gens is not None and len(gens) != f0.shape[0]:
                raise ValueError(f"{len(gens)} generators for {f0.shape[0]} rows")
            rows = [(g, 1) for g in gens] if gens is not None else [(gen, f0.shape[0])]
            phase, noise_unit = [], []
            for g, n in rows:
                phase.append(torch.rand((n, 1, H), generator=g, device=g.device))
                noise_unit.append(torch.randn((n,) + theta.shape[1:], generator=g,
                                              device=g.device))
            phase = (torch.cat(phase) * 2 * np.pi - np.pi).to(f0.device, f0.dtype)
            phase[:, :, 0] = 0.0
            noise_unit = torch.cat(noise_unit).to(f0.device, f0.dtype)
        sine = cfg.nsf_alpha * torch.sin(theta + phase)
        uv = (f0 > cfg.nsf_voiced_threshold).to(f0.dtype)[..., None]
        noise_amp = uv * cfg.nsf_sigma + (1.0 - uv) * cfg.nsf_alpha / 3.0
        sine = sine * uv + noise_amp * noise_unit
        return torch.tanh(self.l_linear(sine)), uv


class HiFTGenerator(nn.Module):
    """mel [B, T, 80] -> waveform [B, T * upsample_scale]."""

    def __init__(self, cfg: HiFTConfig = HiFTConfig(), deterministic: bool = False):
        super().__init__()
        self.cfg = cfg
        approx = cfg.approx_sin
        n_stft = cfg.istft_n_fft + 2
        self.f0_predictor = ConvRNNF0Predictor(cfg.in_channels, cfg.f0_cond_channels)
        self.m_source = SourceModuleHnNSF(cfg, deterministic)
        self.conv_pre = Conv1d(cfg.in_channels, cfg.base_channels, 7, padding=3,
                               weight_norm=True)
        self.ups = nn.ModuleList()
        self.source_downs = nn.ModuleList()
        self.source_resblocks = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        down_cum = np.cumprod([1] + list(cfg.upsample_rates[::-1][:-1]))[::-1]
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            ch = cfg.base_channels // (2 ** (i + 1))
            self.ups.append(ConvTranspose1d(2 * ch, ch, k, u, padding=(k - u) // 2,
                                            weight_norm=True))
            du = int(down_cum[i])
            self.source_downs.append(Conv1d(n_stft, ch, 1) if du == 1 else
                                     Conv1d(n_stft, ch, du * 2, stride=du, padding=du // 2))
            self.source_resblocks.append(ResBlock(
                ch, cfg.source_resblock_kernel_sizes[i],
                cfg.source_resblock_dilation_sizes[i], approx))
            for rk, rd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                self.resblocks.append(ResBlock(ch, rk, rd, approx))
        self.conv_post = Conv1d(cfg.base_channels // (2 ** len(cfg.upsample_rates)),
                                n_stft, 7, padding=3, weight_norm=True)

    def _source(self, mel, gen):
        f0 = self.f0_predictor(mel)
        f0_up = torch.repeat_interleave(f0, self.cfg.upsample_scale, dim=-1)
        s, _ = self.m_source(f0_up, gen)
        return s, f0

    def decode(self, mel: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        """Synthesis from mel [B, T, 80] + source s [B, L, 1]."""
        cfg = self.cfg
        n_fft, hop = cfg.istft_n_fft, cfg.istft_hop_len
        cdt = _DTYPES[cfg.dtype]
        win = hann_window(n_fft, torch.float32, mel.device)
        s_re, s_im = stft(s[..., 0].float(), n_fft, hop, win, center=True)
        s_stft = torch.cat([s_re, s_im], dim=1).transpose(1, 2).to(cdt)
        x = self.conv_pre(mel.to(cdt))
        nk = len(cfg.resblock_kernel_sizes)
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, cfg.lrelu_slope))
            if i == len(self.ups) - 1:
                x = torch.cat([x[:, 1:2], x], dim=1)  # ReflectionPad1d((1, 0))
            x = x + self.source_resblocks[i](self.source_downs[i](s_stft))
            xs = torch.zeros_like(x)
            for j in range(nk):
                xs = xs + self.resblocks[i * nk + j](x)
            x = xs / nk
        x = self.conv_post(F.leaky_relu(x, 0.01)).float()
        nb = n_fft // 2 + 1
        mag = torch.exp(x[..., :nb].clamp_max(MAG_LOG_CAP)).clamp_max(1e2)
        phase = torch.sin(x[..., nb:])
        wav = istft((mag * torch.cos(phase)).transpose(1, 2),
                    (mag * torch.sin(phase)).transpose(1, 2), n_fft, hop, win, center=True)
        return wav.clamp(-cfg.audio_limit, cfg.audio_limit)

    def forward(self, mel: torch.Tensor, gen: Optional[torch.Generator] = None):
        """The training forward: mel [B, T, 80] -> (wav [B, T * upsample_scale],
        predicted f0 [B, T]), with gradients as the caller has them and the
        source's noise from `gen`."""
        s, f0 = self._source(mel, gen)
        return self.decode(mel, s), f0

    @torch.no_grad()
    def inference(self, mel: torch.Tensor, cache_source: Optional[torch.Tensor] = None,
                  gen: Optional[torch.Generator] = None):
        """mel [B, T, 80] -> (wav [B, T * upsample_scale], source [B, L, 1]);
        `cache_source` [B, Lc, 1] is spliced over the head of the new source;
        `gen` is one torch.Generator or a list of one a row."""
        s, _ = self._source(mel, gen)
        if cache_source is not None and cache_source.shape[1] > 0:
            s = torch.cat([cache_source.to(s.dtype), s[:, cache_source.shape[1]:]], dim=1)
        return self.decode(mel, s), s
