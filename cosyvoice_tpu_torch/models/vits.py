"""VITS decoder: speech tokens -> waveform through a normalizing-flow VAE.

Port of cosyvoice_tpu/models/vits.py (the reference's vits/models.py,
vits/attentions.py and speaker/modules.py), channels-last [B, T, C] as the
JAX package is:
- the prior encoder `enc_p`: token embedding x sqrt(hidden), up to two 2x
  UpsampleConformerEncoders (each doubles the lengths), a post-norm encoder
  of windowed relative attention (learned +-4 relative key and value
  tables, pad keys filled with -1e4) and a 1x1 projection to (m, logs);
- the posterior encoder `enc_q` (linear spectrum -> a gated WaveNet stack ->
  (m, logs) -> a reparameterised sample), also the LAM speaker encoder's;
- `flow`: mean-only affine couplings, each followed by a channel flip, run
  backwards at inference;
- `dec`: a HiFiGAN generator (weight-normed transposed convolutions, the
  mean of its ResBlock1s, a final leaky ReLU of slope 0.01, conv_post
  without bias, tanh).
`VitsDecoder.inference` draws z_p = m_p + noise * exp(logs_p) * noise_scale
from an explicit `noise` tensor [B, T, inter] (the JAX draw's layout) or a
torch.Generator.  Parameter names follow the reference checkpoint
(`enc_p.encoder.attn_layers.{i}.emb_rel_k`, `flow.flows.{2i}.enc.in_layers.{j}`,
`dec.resblocks.{i*nk+j}.convs1.{d}`, ...), so a reference state_dict loads
with strict=True (`load_vits`).

`VitsDecoder.forward` is the training forward: the posterior sample of the
linear spectrum through the flow, and the generator on a random segment of
`segment_size // hop` frames of it (the start drawn per row, then clamped
so the segment ends inside the frames, as jax.lax.dynamic_slice clamps);
`vits_kl_loss` is its KL term.

The stochastic-duration pieces (DDSConv, ConvFlow, ElementwiseAffine,
flip_flow, log_flow) are ported for the module's surface; the shipped
recipes do not run them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from cosyvoice_tpu_torch.device import resolve_device
from cosyvoice_tpu_torch.models.conformer import ConformerConfig, UpsampleConformerEncoder
from cosyvoice_tpu_torch.nn.conv import Conv1d, ConvTranspose1d
from cosyvoice_tpu_torch.ops.masks import make_non_pad_mask
from cosyvoice_tpu_torch.ops.splines import piecewise_rational_quadratic_transform
from cosyvoice_tpu_torch.ops.stft import hann_window, reflect_pad, stft

LRELU_SLOPE = 0.1


def normal_noise(like: torch.Tensor, noise: Optional[torch.Tensor],
                 gen: Optional[torch.Generator]) -> torch.Tensor:
    """`noise` if given, else a standard normal draw shaped like `like` from
    `gen` on the generator's own device (a CPU generator gives the same draws
    whichever device the model is on), moved to `like`'s device."""
    if noise is None:
        noise = torch.randn(like.shape, generator=gen,
                            device=gen.device if gen is not None else like.device)
    return noise.to(like.device, like.dtype)


class ChanLayerNorm(nn.Module):
    """LayerNorm over channels (the reference's speaker/modules.LayerNorm,
    `gamma` / `beta`): two-pass variance, eps 1e-5."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.gamma, self.beta, self.eps)


def _expand_rel(emb: torch.Tensor, T: int, W: int) -> torch.Tensor:
    """[1, 2W+1, D] -> [1, 2T-1, D]: zero relative offsets past the window."""
    pad = max(T - (W + 1), 0)
    start = max((W + 1) - T, 0)
    return F.pad(emb, (0, 0, pad, pad))[:, start:start + 2 * T - 1]


def _rel_to_abs(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, 2T-1] relative logits -> [B, H, T, T] absolute."""
    B, H, T, _ = x.shape
    xf = F.pad(F.pad(x, (0, 1)).reshape(B, H, T * 2 * T), (0, T - 1))
    return xf.reshape(B, H, T + 1, 2 * T - 1)[:, :, :T, T - 1:]


def _abs_to_rel(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, T] absolute weights -> [B, H, T, 2T-1] relative."""
    B, H, T, _ = x.shape
    xf = F.pad(F.pad(x, (0, T - 1)).reshape(B, H, T * (2 * T - 1)), (T, 0))
    return xf.reshape(B, H, T, 2 * T)[:, :, :, 1:]


class WindowRelAttention(nn.Module):
    """1x1-conv q/k/v/o self-attention with learned relative key and value
    tables over offsets -window..window, shared by the heads."""

    def __init__(self, channels: int, heads: int, window_size: int = 4):
        super().__init__()
        self.heads, self.window_size = heads, window_size
        D = channels // heads
        self.conv_q, self.conv_k, self.conv_v, self.conv_o = (
            Conv1d(channels, channels, 1) for _ in range(4))
        self.emb_rel_k = nn.Parameter(torch.randn(1, 2 * window_size + 1, D) * D ** -0.5)
        self.emb_rel_v = nn.Parameter(torch.randn(1, 2 * window_size + 1, D) * D ** -0.5)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
        """x [B, T, C], attn_mask [B, T, T] (True: attend) -> [B, T, C]."""
        B, T, C = x.shape
        H, W = self.heads, self.window_size
        D = C // H
        split = lambda t: t.reshape(B, T, H, D).transpose(1, 2)       # [B, H, T, D]
        q = split(self.conv_q(x)) / math.sqrt(D)
        k, v = split(self.conv_k(x)), split(self.conv_v(x))
        rel_k = _expand_rel(self.emb_rel_k, T, W)[0]                   # [2T-1, D]
        scores = q @ k.transpose(-1, -2) + _rel_to_abs(q @ rel_k.T)
        scores = scores.masked_fill(~attn_mask[:, None], -1e4)
        p = torch.softmax(scores, dim=-1)
        out = p @ v + _abs_to_rel(p) @ _expand_rel(self.emb_rel_v, T, W)[0]
        return self.conv_o(out.transpose(1, 2).reshape(B, T, C))


class VitsFFN(nn.Module):
    def __init__(self, channels: int, filter_channels: int, kernel_size: int):
        super().__init__()
        pad = kernel_size // 2
        self.conv_1 = Conv1d(channels, filter_channels, kernel_size, padding=pad)
        self.conv_2 = Conv1d(filter_channels, channels, kernel_size, padding=pad)

    def forward(self, x, mask):
        m = mask[..., None].to(x.dtype)
        return self.conv_2(torch.relu(self.conv_1(x * m)) * m) * m


class VitsEncoder(nn.Module):
    """Post-norm: x = LN(x + attn(x)); x = LN(x + ffn(x)), per layer."""

    def __init__(self, channels: int, filter_channels: int, heads: int, n_layers: int,
                 kernel_size: int = 1):
        super().__init__()
        self.attn_layers = nn.ModuleList(WindowRelAttention(channels, heads)
                                         for _ in range(n_layers))
        self.norm_layers_1 = nn.ModuleList(ChanLayerNorm(channels) for _ in range(n_layers))
        self.ffn_layers = nn.ModuleList(VitsFFN(channels, filter_channels, kernel_size)
                                        for _ in range(n_layers))
        self.norm_layers_2 = nn.ModuleList(ChanLayerNorm(channels) for _ in range(n_layers))

    def forward(self, x, mask):
        attn_mask = mask[:, :, None] & mask[:, None, :]
        m = mask[..., None].to(x.dtype)
        x = x * m
        for attn, n1, ffn, n2 in zip(self.attn_layers, self.norm_layers_1, self.ffn_layers,
                                     self.norm_layers_2):
            x = n1(x + attn(x, attn_mask))
            x = n2(x + ffn(x, mask))
        return x * m


class WN(nn.Module):
    """Gated WaveNet stack: weight-normed dilated convs, tanh * sigmoid
    gates, residual and skip 1x1 convs (the last layer's skip only, `hidden`
    wide); with gin_channels a weight-normed `cond_layer` of g, sliced a
    layer."""

    def __init__(self, hidden: int, kernel_size: int, dilation_rate: int, n_layers: int,
                 gin_channels: int = 0):
        super().__init__()
        self.hidden, self.n_layers = hidden, n_layers
        if gin_channels:
            self.cond_layer = Conv1d(gin_channels, 2 * hidden * n_layers, 1, weight_norm=True)
        self.in_layers = nn.ModuleList()
        self.res_skip_layers = nn.ModuleList()
        for i in range(n_layers):
            d = dilation_rate ** i
            self.in_layers.append(Conv1d(hidden, 2 * hidden, kernel_size, dilation=d,
                                         padding=(kernel_size * d - d) // 2, weight_norm=True))
            rs = 2 * hidden if i < n_layers - 1 else hidden
            self.res_skip_layers.append(Conv1d(hidden, rs, 1, weight_norm=True))

    def forward(self, x, mask, g: Optional[torch.Tensor] = None):
        """x [B, T, hidden], mask [B, T], g [B, 1, gin] or None."""
        h = self.hidden
        m = mask[..., None].to(x.dtype)
        out = torch.zeros_like(x)
        g_all = self.cond_layer(g) if g is not None else None
        for i, (conv, rs_conv) in enumerate(zip(self.in_layers, self.res_skip_layers)):
            x_in = conv(x)
            if g_all is not None:
                x_in = x_in + g_all[..., 2 * h * i:2 * h * (i + 1)]
            acts = torch.tanh(x_in[..., :h]) * torch.sigmoid(x_in[..., h:])
            rs = rs_conv(acts)
            if i < self.n_layers - 1:
                x = (x + rs[..., :h]) * m
                out = out + rs[..., h:]
            else:
                out = out + rs
        return out * m


class PosteriorEncoder(nn.Module):
    """Linear spectrum -> 1x1 pre -> WN -> 1x1 proj -> (m, logs) -> z =
    (m + noise * exp(logs)) * mask (the reference's `enc_q`)."""

    def __init__(self, in_channels: int, out_channels: int, hidden: int, kernel_size: int = 5,
                 dilation_rate: int = 1, n_layers: int = 16, gin_channels: int = 0):
        super().__init__()
        self.pre = Conv1d(in_channels, hidden, 1)
        self.enc = WN(hidden, kernel_size, dilation_rate, n_layers, gin_channels)
        self.proj = Conv1d(hidden, 2 * out_channels, 1)

    def forward(self, spec, spec_len, g: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None, gen: Optional[torch.Generator] = None):
        """spec [B, T, in], spec_len [B] -> (z, m, logs, mask)."""
        mask = make_non_pad_mask(spec_len, spec.shape[1])
        m_ = mask[..., None].to(spec.dtype)
        h = self.enc(self.pre(spec) * m_, mask, g)
        m, logs = (self.proj(h) * m_).chunk(2, dim=-1)
        z = (m + normal_noise(m, noise, gen) * torch.exp(logs)) * m_
        return z, m, logs, mask


class ResidualCouplingLayer(nn.Module):
    """Mean-only affine coupling: x1 += post(WN(pre(x0)))."""

    def __init__(self, channels: int, hidden: int, kernel_size: int, dilation_rate: int,
                 n_layers: int, gin_channels: int = 0):
        super().__init__()
        self.half = channels // 2
        self.pre = Conv1d(self.half, hidden, 1)
        self.enc = WN(hidden, kernel_size, dilation_rate, n_layers, gin_channels)
        self.post = Conv1d(hidden, self.half, 1)

    def forward(self, x, mask, g=None, reverse: bool = False):
        m_ = mask[..., None].to(x.dtype)
        x0, x1 = x[..., :self.half], x[..., self.half:]
        h = self.enc(self.pre(x0) * m_, mask, g)
        m = self.post(h) * m_
        x1 = (x1 - m) * m_ if reverse else m + x1 * m_
        return torch.cat([x0, x1], dim=-1)


class Flip(nn.Module):
    """The channel flip between couplings (no parameters)."""

    def forward(self, x):
        return torch.flip(x, dims=[-1])


class ResidualCouplingBlock(nn.Module):
    """n_flows x [coupling, flip] (`flows.{2i}` are the couplings)."""

    def __init__(self, channels: int, hidden: int, kernel_size: int = 5,
                 dilation_rate: int = 1, n_layers: int = 4, n_flows: int = 4,
                 gin_channels: int = 0):
        super().__init__()
        self.flows = nn.ModuleList()
        for _ in range(n_flows):
            self.flows.append(ResidualCouplingLayer(channels, hidden, kernel_size,
                                                    dilation_rate, n_layers, gin_channels))
            self.flows.append(Flip())

    def forward(self, x, mask, g=None, reverse: bool = False):
        pairs = list(zip(self.flows[::2], self.flows[1::2]))
        if not reverse:
            for layer, flip in pairs:
                x = flip(layer(x, mask, g))
        else:
            for layer, flip in reversed(pairs):
                x = layer(flip(x), mask, g, reverse=True)
        return x


class VitsResBlock1(nn.Module):
    """HiFiGAN ResBlock1 (leaky ReLU 0.1, weight-normed convs)."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, dilation=d,
                   padding=(kernel_size * d - d) // 2, weight_norm=True) for d in dilations)
        self.convs2 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, padding=(kernel_size - 1) // 2,
                   weight_norm=True) for _ in dilations)

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + c2(F.leaky_relu(c1(F.leaky_relu(x, LRELU_SLOPE)), LRELU_SLOPE))
        return x


class VitsGenerator(nn.Module):
    def __init__(self, in_channels: int, upsample_initial_channel: int,
                 upsample_rates: Sequence[int], upsample_kernel_sizes: Sequence[int],
                 resblock_kernel_sizes: Sequence[int],
                 resblock_dilation_sizes: Sequence[Sequence[int]], gin_channels: int = 0):
        super().__init__()
        ch = upsample_initial_channel
        self.nk = len(resblock_kernel_sizes)
        self.conv_pre = Conv1d(in_channels, ch, 7, padding=3)
        if gin_channels:
            self.cond = Conv1d(gin_channels, ch, 1)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            prev, ch = ch, upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(ConvTranspose1d(prev, ch, k, u, padding=(k - u) // 2,
                                            weight_norm=True))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(VitsResBlock1(ch, rk, rd))
        self.conv_post = Conv1d(ch, 1, 7, padding=3, bias=False)

    def forward(self, x, g: Optional[torch.Tensor] = None):
        """x [B, T, inter], g [B, 1, gin] -> wav [B, T * prod(rates)]."""
        x = self.conv_pre(x)
        if g is not None:
            x = x + self.cond(g)
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            xs = x * 0.0
            for j in range(self.nk):
                xs = xs + self.resblocks[i * self.nk + j](x)
            x = xs / self.nk
        return torch.tanh(self.conv_post(F.leaky_relu(x, 0.01))[..., 0])


@dataclass(frozen=True)
class VitsConfig:
    n_vocab: int = 6561
    spec_channels: int = 513
    inter_channels: int = 192
    hidden_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    upsample_rates: Sequence[int] = (5, 4, 3, 2, 2)
    upsample_initial_channel: int = 512
    upsample_kernel_sizes: Sequence[int] = (10, 8, 6, 4, 4)
    segment_size: int = 9600
    gin_channels: int = 512
    sample_rate: int = 24000
    frame_rate: int = 25
    token_upsample_ratio: int = 4
    up_enc1: Optional[ConformerConfig] = None   # optional 2x conformer upsamplers
    up_enc2: Optional[ConformerConfig] = None

    @property
    def hop_length(self) -> int:
        return self.sample_rate // self.frame_rate // self.token_upsample_ratio


def __getattr__(name: str):
    """RECIPE: examples/tts_vc/cosyvoice2/conf/cosyvoice2_vits_tts.yaml's
    `vits:` section (25 Hz tokens, two 2x conformers, 240x to 24 kHz: 960
    samples a token), read from the recipe by config.recipe_config on first
    use."""
    if name == "RECIPE":
        from cosyvoice_tpu_torch.config import recipe_config

        return recipe_config("cosyvoice2/conf/cosyvoice2_vits_tts.yaml", "vits")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class TextEncoder(nn.Module):
    """The prior encoder (`enc_p`)."""

    def __init__(self, cfg: VitsConfig):
        super().__init__()
        self.hidden = cfg.hidden_channels
        self.emb = nn.Embedding(cfg.n_vocab, cfg.hidden_channels)
        self.up_enc1 = UpsampleConformerEncoder(cfg.up_enc1) if cfg.up_enc1 else None
        self.up_enc2 = UpsampleConformerEncoder(cfg.up_enc2) if cfg.up_enc2 else None
        self.encoder = VitsEncoder(cfg.hidden_channels, cfg.filter_channels, cfg.n_heads,
                                   cfg.n_layers, cfg.kernel_size)
        self.proj = Conv1d(cfg.hidden_channels, 2 * cfg.inter_channels, 1)

    def forward(self, tokens, token_len):
        """tokens [B, T], token_len [B] -> (x, m, logs, mask, lengths), at
        2^(upsample conformers) x the token rate."""
        x = self.emb(tokens) * math.sqrt(self.hidden)
        for enc in (self.up_enc1, self.up_enc2):
            if enc is not None:
                x, _ = enc(x, token_len)
                token_len = token_len * 2
        mask = make_non_pad_mask(token_len, x.shape[1])
        x = self.encoder(x, mask)
        m, logs = (self.proj(x) * mask[..., None].to(x.dtype)).chunk(2, dim=-1)
        return x, m, logs, mask, token_len


class VitsDecoder(nn.Module):
    def __init__(self, cfg: VitsConfig = VitsConfig()):
        super().__init__()
        self.cfg = cfg
        self.enc_p = TextEncoder(cfg)
        self.enc_q = PosteriorEncoder(cfg.spec_channels, cfg.inter_channels,
                                      cfg.hidden_channels, 5, 1, 16, cfg.gin_channels)
        self.flow = ResidualCouplingBlock(cfg.inter_channels, cfg.hidden_channels,
                                          gin_channels=cfg.gin_channels)
        self.dec = VitsGenerator(cfg.inter_channels, cfg.upsample_initial_channel,
                                 cfg.upsample_rates, cfg.upsample_kernel_sizes,
                                 cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes,
                                 cfg.gin_channels)

    def forward(self, tokens: torch.Tensor, token_len: torch.Tensor, spec: torch.Tensor,
                spec_len: torch.Tensor, g: torch.Tensor, gen: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None, ids: Optional[torch.Tensor] = None):
        """The training forward: tokens [B, T], spec [B, T', spec_channels]
        (T' = T * 2^(conformers)), g [B, gin] -> (wav segment [B,
        segment_size], (ids, x_mask, y_mask, z, z_p, m_p, logs_p, m_q,
        logs_q)).  The posterior's noise [B, T', inter] and the segment
        starts ids [B] (in frames) are drawn from `gen` in that order, or
        pinned by `noise` / `ids`."""
        cfg = self.cfg
        g3 = g[:, None, :]
        _, m_p, logs_p, x_mask, _ = self.enc_p(tokens, token_len)
        z, m_q, logs_q, y_mask = self.enc_q(spec, spec_len, g3, noise=noise, gen=gen)
        z_p = self.flow(z, y_mask, g3, reverse=False)
        frames = cfg.segment_size // cfg.hop_length
        if ids is None:
            max_start = torch.clamp(spec_len - frames, min=1)
            u = torch.rand(z.shape[0], generator=gen,
                           device=gen.device if gen is not None else z.device)
            ids = (u.to(z.device) * max_start).long()
        o = self.dec(segments(z, ids, frames), g3)
        return o, (ids, x_mask, y_mask, z, z_p, m_p, logs_p, m_q, logs_q)

    @torch.no_grad()
    def inference(self, tokens: torch.Tensor, token_len: torch.Tensor, g: torch.Tensor,
                  noise: Optional[torch.Tensor] = None, gen: Optional[torch.Generator] = None,
                  noise_scale: float = 0.5) -> torch.Tensor:
        """tokens [B, T] (valid ids), token_len [B], g [B, gin] -> wav
        [B, T * 2^(conformers) * prod(rates)]; `noise` [B, T', inter] pins the
        prior draw, else it comes from `gen`."""
        g3 = g[:, None, :]
        _, m_p, logs_p, mask, _ = self.enc_p(tokens, token_len)
        z_p = m_p + normal_noise(m_p, noise, gen) * torch.exp(logs_p) * noise_scale
        z = self.flow(z_p, mask, g3, reverse=True)
        return self.dec(z * mask[..., None].to(z.dtype), g3)


def segments(x: torch.Tensor, starts: torch.Tensor, size: int) -> torch.Tensor:
    """x [B, T, ...] -> x[b, s_b : s_b + size] for each row, each start
    clamped to [0, T - size] (jax.lax.dynamic_slice_in_dim's clamp)."""
    T = x.shape[1]
    if size > T:
        raise ValueError(f"a segment of {size} from {T} rows")
    s = starts.to(x.device).long().clamp(0, T - size)
    idx = s[:, None] + torch.arange(size, device=x.device)
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(-1, -1, *x.shape[2:])
    return torch.gather(x, 1, idx)


def vits_kl_loss(z_p, logs_q, m_p, logs_p, mask) -> torch.Tensor:
    """The masked KL between the flowed posterior and the prior, summed over
    channels and frames, over the count of valid frames (mask [B, T])."""
    m = mask[..., None].float()
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * ((z_p - m_p) ** 2) * torch.exp(-2.0 * logs_p)
    return torch.sum(kl * m) / torch.clamp(torch.sum(mask.float()), min=1.0)


def load_vits(cfg: Optional[VitsConfig] = None, state_dict: Optional[dict] = None,
              device=None) -> VitsDecoder:
    """A VitsDecoder (default: RECIPE) in eval mode on `device` (default:
    the GPU), with a reference-named state_dict loaded strictly when one is
    given."""
    model = VitsDecoder(cfg or __getattr__("RECIPE"))
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model.to(resolve_device(device)).eval()


def linear_spectrogram(y: torch.Tensor, n_fft: int = 1024, hop: int = 240,
                       win: int = 1024) -> torch.Tensor:
    """y [B, S] -> the magnitude linear spectrum [B, T, n_fft // 2 + 1]:
    reflect-padded by (n_fft - hop) // 2 a side, uncentred frames,
    sqrt(re^2 + im^2 + 1e-6) (the posterior encoder's input)."""
    pad = (n_fft - hop) // 2
    y = reflect_pad(y, pad, pad)
    re, im = stft(y, n_fft, hop, hann_window(n_fft, y.dtype, y.device), center=False)
    return torch.sqrt(re * re + im * im + 1e-6).transpose(1, 2)


# ---- the stochastic-duration flow plumbing ------------------------------

class DDSConv(nn.Module):
    """Dilated depth-separable conv stack (dilation kernel_size^i), each
    layer LN -> gelu -> 1x1 -> LN -> gelu, residual."""

    def __init__(self, channels: int, kernel_size: int, n_layers: int):
        super().__init__()
        self.convs_sep = nn.ModuleList()
        self.convs_1x1 = nn.ModuleList()
        self.norms_1 = nn.ModuleList()
        self.norms_2 = nn.ModuleList()
        for i in range(n_layers):
            d = kernel_size ** i
            self.convs_sep.append(Conv1d(channels, channels, kernel_size, groups=channels,
                                         dilation=d, padding=(kernel_size * d - d) // 2))
            self.convs_1x1.append(Conv1d(channels, channels, 1))
            self.norms_1.append(ChanLayerNorm(channels))
            self.norms_2.append(ChanLayerNorm(channels))

    def forward(self, x, mask, g=None):
        m = mask[..., None].to(x.dtype)
        if g is not None:
            x = x + g
        for sep, n1, c1x1, n2 in zip(self.convs_sep, self.norms_1, self.convs_1x1,
                                     self.norms_2):
            y = F.gelu(n1(sep(x * m)))
            x = x + F.gelu(n2(c1x1(y)))
        return x * m


class ConvFlow(nn.Module):
    """Rational-quadratic spline coupling over the second half of the
    channels, its bins from a DDSConv of the first half."""

    def __init__(self, in_channels: int, filter_channels: int, kernel_size: int,
                 n_layers: int, num_bins: int = 10, tail_bound: float = 5.0):
        super().__init__()
        self.half, self.num_bins, self.tail_bound = in_channels // 2, num_bins, tail_bound
        self.filter_channels = filter_channels
        self.pre = Conv1d(self.half, filter_channels, 1)
        self.convs = DDSConv(filter_channels, kernel_size, n_layers)
        self.proj = Conv1d(filter_channels, self.half * (3 * num_bins - 1), 1)

    def forward(self, x, mask, g=None, reverse: bool = False):
        """x [B, T, C], mask [B, T] -> x' (reverse) or (x', logdet [B])."""
        n, m = self.num_bins, mask[..., None].to(x.dtype)
        x0, x1 = x[..., :self.half], x[..., self.half:]
        h = self.proj(self.convs(self.pre(x0), mask, g=g)) * m
        B, T = h.shape[:2]
        h = h.reshape(B, T, self.half, 3 * n - 1).transpose(1, 2)      # [B, half, T, 3n-1]
        scale = math.sqrt(self.filter_channels)
        y1, logabsdet = piecewise_rational_quadratic_transform(
            x1.transpose(1, 2), h[..., :n] / scale, h[..., n:2 * n] / scale, h[..., 2 * n:],
            inverse=reverse, tails="linear", tail_bound=self.tail_bound)
        x = torch.cat([x0, y1.transpose(1, 2)], dim=-1) * m
        if reverse:
            return x
        return x, (logabsdet * mask[:, None, :].to(x.dtype)).sum(dim=(1, 2))


class ElementwiseAffine(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.m = nn.Parameter(torch.zeros(channels))
        self.logs = nn.Parameter(torch.zeros(channels))

    def forward(self, x, mask, reverse: bool = False):
        m = mask[..., None].to(x.dtype)
        if not reverse:
            return (self.m + torch.exp(self.logs) * x) * m, (self.logs * m).sum(dim=(1, 2))
        return (x - self.m) * torch.exp(-self.logs) * m


def flip_flow(x, reverse: bool = False):
    """The channel flip as a flow (logdet 0)."""
    y = torch.flip(x, dims=[-1])
    return y if reverse else (y, x.new_zeros(x.shape[0]))


def log_flow(x, mask, reverse: bool = False):
    m = mask[..., None].to(x.dtype)
    if not reverse:
        y = torch.log(x.clamp_min(1e-5)) * m
        return y, -y.sum(dim=(1, 2))
    return torch.exp(x) * m
