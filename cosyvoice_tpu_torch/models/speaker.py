"""The production 512-d speaker embedding (timbre + style): the LAM stack.

Port of cosyvoice_tpu/models/speaker.py (the reference's
speaker/speaker_encoder.py SpeakerEmbedding, speaker/style_encoder.py and
speaker/modules.py), channels-last:
- timbre: CAMPPlus (models/campplus.py, 192-d) on kaldi fbank 80 at 16 kHz
  with per-utterance mean removal;
- the posterior encoder (models/vits.py PosteriorEncoder: WN of 16 layers,
  no conditioning) over the 1024-point, hop-300 linear spectrum at 24 kHz,
  whose reparameterised sample z = (m + noise * exp(logs)) * mask takes an
  explicit `noise` [B, T, inter] (the JAX draw's layout) or a generator;
- StyleEncoderV2: spectral Linear-Mish layers, two Conv1dGLUs and a
  self-attention (scores over sqrt(d_model), pad keys at -inf, a residual
  without norm) a layer, then a masked mean pool with the count floored at 1;
- GlobalStyleTokensV2: 6 layers of 4096 tanh'd tokens, 8-head attention
  scaled by 1 / sqrt(512 / 8), each layer querying with the last one's output;
- the additive fuser: style + speaker_adapter(timbre) (512 x 192, no bias)
  when the widths differ, else timbre + style.
A length-0 row is NaN, as in the JAX package (every key of its attention
is masked).  Parameter names follow the reference checkpoint
(`speaker_encoder.*` is CAMPPlus under its own names,
`style_encoder.spectral_layers.{i}.0.fc`, `gst.embeds.{i}`,
`speaker_adapter.style_fuser`, ...), so a reference state_dict loads with
strict=True (`load_speaker_embedding`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from cosyvoice_tpu_torch.device import resolve_device
from cosyvoice_tpu_torch.models.campplus import CAMPPlus, CAMPPlusConfig
from cosyvoice_tpu_torch.models.vits import PosteriorEncoder, linear_spectrogram
from cosyvoice_tpu_torch.nn.conv import Conv1d
from cosyvoice_tpu_torch.nn.dense import Dense
from cosyvoice_tpu_torch.ops.kaldi import kaldi_fbank
from cosyvoice_tpu_torch.ops.masks import make_non_pad_mask


class _LinearNorm(nn.Module):
    """The reference's LinearNorm: a Linear under `fc`."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True):
        super().__init__()
        self.fc = Dense(in_dim, out_dim, bias=bias)

    def forward(self, x):
        return self.fc(x)


class _ConvNorm(nn.Module):
    """The reference's ConvNorm: a Conv1d under `conv`."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int):
        super().__init__()
        self.conv = Conv1d(in_dim, out_dim, kernel_size, padding=(kernel_size - 1) // 2)

    def forward(self, x):
        return self.conv(x)


class Conv1dGLU(nn.Module):
    """conv -> GLU, residual."""

    def __init__(self, channels: int, kernel_size: int):
        super().__init__()
        self.channels = channels
        self.conv1 = _ConvNorm(channels, 2 * channels, kernel_size)

    def forward(self, x):
        h = self.conv1(x)
        return x + h[..., :self.channels] * torch.sigmoid(h[..., self.channels:])


class StyleMHA(nn.Module):
    """Self-attention scaled by 1 / sqrt(d_model) (not the head width), pad
    keys at -inf, a residual without norm."""

    def __init__(self, heads: int, d_model: int):
        super().__init__()
        self.heads, self.d_model = heads, d_model
        self.w_qs, self.w_ks, self.w_vs, self.fc = (Dense(d_model, d_model) for _ in range(4))

    def forward(self, x, pad: torch.Tensor):
        """x [B, T, d_model], pad [B, T] (True at padded rows)."""
        B, T, _ = x.shape
        H = self.heads
        split = lambda t: t.reshape(B, T, H, -1).transpose(1, 2)
        q, k, v = split(self.w_qs(x)), split(self.w_ks(x)), split(self.w_vs(x))
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(self.d_model)
        p = torch.softmax(scores.masked_fill(pad[:, None, None, :], float("-inf")), dim=-1)
        return x + self.fc((p @ v).transpose(1, 2).reshape(B, T, -1))


class StyleEncoderV2(nn.Module):
    def __init__(self, in_dim: int, hidden: int = 256, out_dim: int = 512,
                 kernel_size: int = 5, heads: int = 4, num_layers: int = 6):
        super().__init__()
        self.in_fc = _LinearNorm(in_dim, hidden)
        # the reference's Linear, Mish, Dropout, Linear, Mish, Dropout
        self.spectral_layers = nn.ModuleList(
            nn.Sequential(_LinearNorm(hidden, hidden), nn.Mish(), nn.Identity(),
                          _LinearNorm(hidden, hidden), nn.Mish(), nn.Identity())
            for _ in range(num_layers))
        self.temporal_layers = nn.ModuleList(
            nn.Sequential(Conv1dGLU(hidden, kernel_size), Conv1dGLU(hidden, kernel_size))
            for _ in range(num_layers))
        self.attn_layers = nn.ModuleList(StyleMHA(heads, hidden) for _ in range(num_layers))
        self.fc = _LinearNorm(hidden, out_dim)

    def forward(self, x, valid: torch.Tensor):
        """x [B, T, in_dim], valid [B, T] bool -> [B, out_dim]."""
        pad = ~valid
        keep = valid[..., None].to(x.dtype)
        x = self.in_fc(x)
        for spectral, temporal, attn in zip(self.spectral_layers, self.temporal_layers,
                                            self.attn_layers):
            x = attn(temporal(spectral(x)) * keep, pad)
        x = self.fc(x) * keep
        return x.sum(dim=1) / valid.sum(dim=1, keepdim=True).clamp_min(1).to(x.dtype)


class GSTAttention(nn.Module):
    """Multi-head attention of a query onto given keys (no biases), scaled by
    1 / sqrt(key_dim)."""

    def __init__(self, query_dim: int, key_dim: int, num_units: int, num_heads: int):
        super().__init__()
        self.num_heads, self.key_dim = num_heads, key_dim
        self.W_query = Dense(query_dim, num_units, bias=False)
        self.W_key = Dense(key_dim, num_units, bias=False)
        self.W_value = Dense(key_dim, num_units, bias=False)

    def forward(self, query, keys):
        """query [B, Tq, query_dim], keys [Tk, key_dim] (shared by the rows)
        -> [B, Tq, num_units]."""
        B, Tq, _ = query.shape
        H = self.num_heads
        q = self.W_query(query).reshape(B, Tq, H, -1).transpose(1, 2)     # [B, H, Tq, d]
        k = self.W_key(keys).reshape(keys.shape[0], H, -1).transpose(0, 1)  # [H, Tk, d]
        v = self.W_value(keys).reshape(keys.shape[0], H, -1).transpose(0, 1)
        p = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(self.key_dim), dim=-1)
        return (p @ v).transpose(1, 2).reshape(B, Tq, -1)


class GlobalStyleTokensV2(nn.Module):
    def __init__(self, token_num: int = 4096, embed_dim: int = 512, num_heads: int = 8,
                 num_layers: int = 6):
        super().__init__()
        dk = embed_dim // num_heads
        self.embeds = nn.ParameterList(nn.Parameter(torch.randn(token_num, dk) * 0.5)
                                       for _ in range(num_layers))
        self.attentions = nn.ModuleList(GSTAttention(embed_dim, dk, embed_dim, num_heads)
                                        for _ in range(num_layers))

    def forward(self, style_vec):
        """[B, E] -> [B, 1, E]."""
        q = style_vec[:, None, :]
        for tokens, attn in zip(self.embeds, self.attentions):
            q = attn(q, torch.tanh(tokens))
        return q


@dataclass(frozen=True)
class SpeakerEmbeddingConfig:
    spec_channels: int = 513
    inter_channels: int = 512
    hidden_channels: int = 512
    speaker_emb_dim: int = 512
    sampling_rate: int = 24000
    hop_length: int = 300
    filter_length: int = 1024
    fbank_sr: int = 16000
    campplus: CAMPPlusConfig = field(default_factory=lambda: CAMPPlusConfig(
        embedding_size=192))
    style_hidden: int = 256
    style_heads: int = 4
    style_kernel: int = 5
    style_layers: int = 6
    gst_tokens: int = 4096
    gst_heads: int = 8
    gst_layers: int = 6


class _StyleFuser(nn.Module):
    """The reference's StyleFuser (Add): the timbre's projection under
    `style_fuser`."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.style_fuser = Dense(in_dim, out_dim, bias=False)

    def forward(self, x):
        return self.style_fuser(x)


class SpeakerEmbedding(nn.Module):
    # the posterior encoder feeds the style encoder
    post_enc = True

    def __init__(self, cfg: SpeakerEmbeddingConfig = SpeakerEmbeddingConfig()):
        super().__init__()
        self.cfg = cfg
        self.speaker_encoder = CAMPPlus(cfg.campplus)
        if self.post_enc:
            self.enc_q = PosteriorEncoder(cfg.spec_channels, cfg.inter_channels,
                                          cfg.hidden_channels, 5, 1, 16, 0)
        self.style_encoder = StyleEncoderV2(
            cfg.inter_channels if self.post_enc else cfg.spec_channels, cfg.style_hidden,
            cfg.speaker_emb_dim, cfg.style_kernel, cfg.style_heads, cfg.style_layers)
        self.gst = GlobalStyleTokensV2(cfg.gst_tokens, cfg.speaker_emb_dim, cfg.gst_heads,
                                       cfg.gst_layers)
        self.speaker_adapter = (_StyleFuser(cfg.campplus.embedding_size, cfg.speaker_emb_dim)
                                if cfg.speaker_emb_dim != cfg.campplus.embedding_size
                                else None)
        self.eval()

    def timbre(self, fbank):
        """fbank [B, Tf, 80] (16 kHz kaldi, mean-removed) -> [B, 192]."""
        return self.speaker_encoder(fbank)

    def style(self, spec, spec_len, noise: Optional[torch.Tensor] = None,
              gen: Optional[torch.Generator] = None):
        """spec [B, Ts, 513] (the 24 kHz linear spectrum), spec_len [B] ->
        the style encoder's vector [B, speaker_emb_dim] (before the GST)."""
        mask = make_non_pad_mask(spec_len, spec.shape[1])
        if self.post_enc:
            spec = self.enc_q(spec, spec_len, noise=noise, gen=gen)[0]
        return self.style_encoder(spec, mask)

    def fuse(self, timbre, style):
        """timbre [B, 192], the style encoder's vector -> [B, speaker_emb_dim]."""
        style = self.gst(style)[:, 0]
        if self.speaker_adapter is not None:
            return style + self.speaker_adapter(timbre)
        return timbre + style

    def embed(self, fbank, spec, spec_len, noise: Optional[torch.Tensor] = None,
              gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """forward with gradients (a training forward that co-trains the
        speaker vector: models/llm_v1_phoneme.TransformerLMPhonemeWithSpk)."""
        return self.fuse(self.timbre(fbank), self.style(spec, spec_len, noise, gen))

    @torch.no_grad()
    def forward(self, fbank, spec, spec_len, noise: Optional[torch.Tensor] = None,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """-> [B, speaker_emb_dim]; `noise` [B, Ts, inter] pins the posterior
        sample, else it comes from `gen`."""
        return self.embed(fbank, spec, spec_len, noise, gen)


class SpeakerEmbeddingWoPostEnc(SpeakerEmbedding):
    """The variant without the posterior encoder: the style encoder reads
    the linear spectrum itself (no sample, so no noise)."""

    post_enc = False


def speaker_features(cfg: SpeakerEmbeddingConfig, wave_24k: np.ndarray, device):
    """24 kHz wav [S] -> (fbank [1, Tf, 80], spec [1, Ts, 513], spec_len [1])
    on `device`: resampled to 16 kHz for the fbank (per-utterance mean
    removed), the linear spectrum at 24 kHz."""
    from cosyvoice_tpu_torch.runtime.frontend import resample_poly

    wav = np.asarray(wave_24k, np.float32)
    wav16 = resample_poly(wav, cfg.sampling_rate, cfg.fbank_sr)
    fb = kaldi_fbank(torch.as_tensor(wav16, device=device))
    fb = fb - fb.mean(dim=0, keepdim=True)
    spec = linear_spectrogram(torch.as_tensor(wav, device=device)[None], cfg.filter_length,
                              cfg.hop_length, cfg.filter_length)
    return fb[None], spec, torch.tensor([spec.shape[1]], device=device)


def speaker_embed(model: SpeakerEmbedding, wave_24k: np.ndarray,
                  gen: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None) -> np.ndarray:
    """24 kHz wav -> the speaker vector [speaker_emb_dim], on the model's
    device (the features too)."""
    device = next(model.parameters()).device
    return model(*speaker_features(model.cfg, wave_24k, device), noise=noise,
                 gen=gen)[0].float().cpu().numpy()


def load_speaker_embedding(cfg: SpeakerEmbeddingConfig = SpeakerEmbeddingConfig(),
                           state_dict: Optional[dict] = None, device=None) -> SpeakerEmbedding:
    """A SpeakerEmbedding in eval mode on `device` (default: the GPU), with a
    reference-named state_dict loaded strictly when one is given."""
    model = SpeakerEmbedding(cfg)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model.to(resolve_device(device)).eval()
