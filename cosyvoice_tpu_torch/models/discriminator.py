"""GAN discriminators and losses for the vocoders' training.

Port of cosyvoice_tpu/models/discriminator.py (the reference's
hifigan/discriminator.py and utils/losses.py):
- `DiscriminatorP` / `MultiPeriodDiscriminator`: the waveform folded by a
  period into a 2-D map, weight-normed (k, 1) convolutions;
- `DiscriminatorR` / `MultiResolutionDiscriminator`: a peak-normalised
  STFT (ops/stft.py) cut into five frequency bands, each through its own
  weight-normed 2-D stack, the bands joined on the frequency axis;
- `MultipleDiscriminator`: MPD + MRD, the recipes' default;
- `DiscriminatorS` / `MultiScaleDiscriminator`: 1-D grouped convolutions at
  three scales (2x mean pools between), the first spectrally normed;
- the losses: feature matching, LSGAN discriminator and generator, the
  tanh-margin relativistic TPR loss and the multi-resolution mel L1.

The 2-D maps are channels-first [B, C, time, width] (torch's layout; the
JAX package's are [B, time, width, C]), so a feature map here is the JAX
one with its channels moved to axis 1; a score flattens in the same
(time, width) order.  A multi-discriminator runs the real and the
generated waveforms through each net as one batch.  Parameter names follow
the reference checkpoints (`discriminators.{i}.convs.{j}`,
`band_convs.{b}.{j}`, `mpd.*` / `mrd.*`, weight_g / weight_v, and
weight_orig / weight_u / weight_v under spectral norm).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from cosyvoice_tpu_torch.nn.conv import Conv1d, Conv2d
from cosyvoice_tpu_torch.ops.stft import hann_window, reflect_pad, stft

LRELU_SLOPE = 0.1


def _run_pair(nets, prep: Callable, y: torch.Tensor, y_hat: torch.Tensor):
    """Each net of `nets` on [y; y_hat] as one batch -> (real scores,
    generated scores, real feature maps, generated feature maps)."""
    B = y.shape[0]
    both = torch.cat([y, y_hat.to(y.dtype)], dim=0)
    y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
    for i, d in enumerate(nets):
        score, fmap = d(prep(i, both))
        y_d_rs.append(score[:B])
        y_d_gs.append(score[B:])
        fmap_rs.append([f[:B] for f in fmap])
        fmap_gs.append([f[B:] for f in fmap])
    return y_d_rs, y_d_gs, fmap_rs, fmap_gs


class DiscriminatorP(nn.Module):
    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        chans = (1, 32, 128, 512, 1024)
        self.convs = nn.ModuleList(
            Conv2d(cin, cout, (kernel_size, 1), (stride, 1), (2, 0), weight_norm=True)
            for cin, cout in zip(chans[:-1], chans[1:]))
        self.convs.append(Conv2d(1024, 1024, (kernel_size, 1), (1, 1), (2, 0),
                                 weight_norm=True))
        self.conv_post = Conv2d(1024, 1, (3, 1), (1, 1), (1, 0), weight_norm=True)

    def forward(self, x: torch.Tensor):
        """x [B, T] -> (score [B, N], feature maps [B, C, T/p, p])."""
        B, T = x.shape
        p = self.period
        if T % p:
            x = reflect_pad(x, 0, p - T % p)
        h = x.reshape(B, 1, -1, p)
        fmap = []
        for conv in self.convs:
            h = F.leaky_relu(conv(h), LRELU_SLOPE)
            fmap.append(h)
        h = self.conv_post(h)
        fmap.append(h)
        return h.reshape(B, -1), fmap


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11)):
        super().__init__()
        self.discriminators = nn.ModuleList(DiscriminatorP(p) for p in periods)

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        return _run_pair(self.discriminators, lambda i, x: x, y, y_hat)


BANDS = ((0.0, 0.1), (0.1, 0.25), (0.25, 0.5), (0.5, 0.75), (0.75, 1.0))
# (kernel, stride, padding) of each band's five convolutions
BAND_CONVS = (((3, 9), (1, 1), (1, 4)), ((3, 9), (1, 2), (1, 4)), ((3, 9), (1, 2), (1, 4)),
              ((3, 9), (1, 2), (1, 4)), ((3, 3), (1, 1), (1, 1)))


class DiscriminatorR(nn.Module):
    def __init__(self, window_length: int, channels: int = 32, hop_factor: float = 0.25,
                 bands: Sequence[tuple[float, float]] = BANDS):
        super().__init__()
        self.window_length, self.hop_factor, self.bands = window_length, hop_factor, bands
        self.band_convs = nn.ModuleList(
            nn.ModuleList(Conv2d(2 if i == 0 else channels, channels, k, s, p,
                                 weight_norm=True) for i, (k, s, p) in enumerate(BAND_CONVS))
            for _ in bands)
        self.conv_post = Conv2d(channels, 1, (3, 3), (1, 1), (1, 1), weight_norm=True)

    def spectrogram(self, x: torch.Tensor) -> list:
        """x [B, S] -> the bands of its STFT, each [B, 2 (re, im), T, F_band]."""
        x = x - x.mean(dim=-1, keepdim=True)
        x = 0.8 * x / (x.abs().amax(dim=-1, keepdim=True) + 1e-9)
        n_fft = self.window_length
        re, im = stft(x, n_fft, int(n_fft * self.hop_factor),
                      hann_window(n_fft, x.dtype, x.device), center=True)
        spec = torch.stack([re, im], dim=1).transpose(2, 3)      # [B, 2, T, F]
        nf = n_fft // 2 + 1
        return [spec[..., int(b0 * nf):int(b1 * nf)] for b0, b1 in self.bands]

    def forward(self, x: torch.Tensor):
        """x [B, S] -> (score [B, 1, T, F'], feature maps)."""
        fmap, outs = [], []
        for band, convs in zip(self.spectrogram(x), self.band_convs):
            h = band
            for i, conv in enumerate(convs):
                h = F.leaky_relu(conv(h), 0.1)
                if i > 0:
                    fmap.append(h)
            outs.append(h)
        h = self.conv_post(torch.cat(outs, dim=3))
        fmap.append(h)
        return h, fmap


class MultiResolutionDiscriminator(nn.Module):
    def __init__(self, fft_sizes: Sequence[int] = (2048, 1024, 512)):
        super().__init__()
        self.discriminators = nn.ModuleList(DiscriminatorR(w) for w in fft_sizes)

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        return _run_pair(self.discriminators, lambda i, x: x, y, y_hat)


class MultipleDiscriminator(nn.Module):
    """MPD + MRD, the MRD scores flattened to [B, N]."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 fft_sizes: Sequence[int] = (2048, 1024, 512)):
        super().__init__()
        self.mpd = MultiPeriodDiscriminator(periods)
        self.mrd = MultiResolutionDiscriminator(fft_sizes)

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        r1, r2 = self.mpd(y, y_hat), self.mrd(y, y_hat)
        flat = lambda t: t.reshape(t.shape[0], -1)  # noqa: E731
        return (r1[0] + [flat(t) for t in r2[0]], r1[1] + [flat(t) for t in r2[1]],
                r1[2] + r2[2], r1[3] + r2[3])


# (channels, kernel, stride, padding, groups) of DiscriminatorS's convolutions
SCALE_CONVS = ((128, 15, 1, 7, 1), (128, 41, 2, 20, 4), (256, 41, 2, 20, 16),
               (512, 41, 4, 20, 16), (1024, 41, 4, 20, 16), (1024, 41, 1, 20, 16),
               (1024, 5, 1, 2, 1))


class DiscriminatorS(nn.Module):
    """Scale discriminator over channels-last [B, T, C]; weight norm, or
    spectral norm with `sn_iters` power iterations a forward (nn/conv.py)."""

    def __init__(self, use_spectral_norm: bool = False, sn_iters: int = 0):
        super().__init__()
        kw = dict(weight_norm=not use_spectral_norm, spectral_norm=use_spectral_norm,
                  sn_iters=sn_iters if use_spectral_norm else 0)
        cins = (1,) + tuple(c for c, *_ in SCALE_CONVS[:-1])
        self.convs = nn.ModuleList(Conv1d(cin, c, k, stride=s, padding=p, groups=g, **kw)
                                   for cin, (c, k, s, p, g) in zip(cins, SCALE_CONVS))
        self.conv_post = Conv1d(SCALE_CONVS[-1][0], 1, 3, padding=1, **kw)

    def forward(self, x: torch.Tensor):
        """x [B, T] -> (score [B, N], feature maps [B, T', C])."""
        h = x[..., None]
        fmap = []
        for conv in self.convs:
            h = F.leaky_relu(conv(h), LRELU_SLOPE)
            fmap.append(h)
        h = self.conv_post(h)
        fmap.append(h)
        return h.reshape(h.shape[0], -1), fmap


def avg_pool_421(x: torch.Tensor) -> torch.Tensor:
    """torch AvgPool1d(4, 2, padding=2) with count_include_pad=True on [B, T]."""
    return F.avg_pool1d(x[:, None], 4, 2, padding=2, count_include_pad=True)[:, 0]


class MultiScaleDiscriminator(nn.Module):
    """Three scale discriminators, 2x mean pools between; the first
    spectrally normed."""

    def __init__(self, sn_iters: int = 0):
        super().__init__()
        self.discriminators = nn.ModuleList(
            DiscriminatorS(use_spectral_norm=(i == 0), sn_iters=sn_iters) for i in range(3))

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        def prep(i, x):
            for _ in range(i):
                x = avg_pool_421(x)
            return x
        return _run_pair(self.discriminators, prep, y, y_hat)


def import_msd_torch(sd: dict) -> dict:
    """A reference MultiScaleDiscriminator state_dict -> the port's
    (strict): discriminators.0 spectrally normed (weight_orig plus the
    weight_u / weight_v power-iteration buffers), 1 and 2 weight-normed."""
    out = {}
    for i in range(3):
        names = ("weight_orig", "weight_u", "weight_v") if i == 0 else ("weight_g", "weight_v")
        for conv in [f"convs.{j}" for j in range(len(SCALE_CONVS))] + ["conv_post"]:
            for leaf in names + ("bias",):
                key = f"discriminators.{i}.{conv}.{leaf}"
                out[key] = torch.as_tensor(sd[key]).float()
    return out


DISCRIMINATORS = {"multiple": MultipleDiscriminator, "mpd": MultiPeriodDiscriminator,
                  "msd": MultiScaleDiscriminator, "mrd": MultiResolutionDiscriminator}


def build_discriminator(name: str = "multiple", conf: dict | None = None) -> nn.Module:
    """gan_conf's `discriminator` and `discriminator_conf` -> the module."""
    return DISCRIMINATORS[name](**{k: tuple(v) if isinstance(v, list) else v
                                   for k, v in (conf or {}).items()})


# ---- losses -------------------------------------------------------------

def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl - gl))
    return loss * 2.0


def discriminator_loss(reals, gens) -> torch.Tensor:
    loss = 0.0
    for dr, dg in zip(reals, gens):
        loss = loss + torch.mean((1.0 - dr) ** 2) + torch.mean(dg ** 2)
    return loss


def generator_loss(gens) -> torch.Tensor:
    loss = 0.0
    for dg in gens:
        loss = loss + torch.mean((1.0 - dg) ** 2)
    return loss


def _median(x: torch.Tensor) -> torch.Tensor:
    """The median of all of x, the mean of the two middle values when the
    count is even (jnp.median; torch.median takes the lower one)."""
    s = x.reshape(-1).sort().values
    n = s.numel()
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def tpr_loss(reals, gens, tau: float) -> torch.Tensor:
    """Tanh-margin pairwise relativistic loss: over the pairs where the real
    score is below the generated one plus the median margin, the mean
    squared distance of the margin from its median, capped at tau."""
    loss = 0.0
    for dr, dg in zip(reals, gens):
        diff = dr - dg
        m = _median(diff)
        sel = (dr < dg + m).to(diff.dtype)
        l_rel = torch.sum(sel * (diff - m) ** 2) / torch.clamp(torch.sum(sel), min=1.0)
        loss = loss + tau - F.relu(tau - l_rel)
    return loss


def mel_l1_loss(real: torch.Tensor, gen: torch.Tensor, mel_transforms) -> torch.Tensor:
    loss = 0.0
    for tf in mel_transforms:
        loss = loss + torch.mean(torch.abs(tf(gen) - tf(real)))
    return loss
