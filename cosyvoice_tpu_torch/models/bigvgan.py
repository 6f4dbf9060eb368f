"""BigVGAN vocoder: speech tokens -> 24 kHz waveform with anti-aliased
Snake/SnakeBeta activations.

Port of cosyvoice_tpu/models/bigvgan.py: token embedding (pad ids clamped to
0, pad rows zeroed) -> optional two 2x UpsampleConformerEncoders -> proj ->
conv_pre + speaker cond -> per-stage transposed-conv upsample + speaker cond
+ the average of the AMP resblocks -> activation_post -> conv_post -> tanh,
with the aux mel head (`mel_proj`) after encoder2 when there is one, else
after conv_pre + cond_layer.  Runs in fp32, as the JAX package does.

Every anti-aliased activation (`AAAct`) runs the fused kernel
(`ops/kernels/snake_aa.py`, K7) with `use_pallas_act`, else the composite
`ops/resample.py::anti_alias_activation` (the kaiser-sinc filter and the 2x
resamplers live there too); the two differ in the first and
last ~6 samples of each activation by design.  With gradients on, the
composite runs under torch.utils.checkpoint: the backward recomputes its
2x-rate intermediates rather than keeping them, so a training forward
keeps little more than the convolutions' inputs, and the recipe's batch
fits on one card (the JAX package leaves this to XLA).  The convolutions
stay cuDNN, as the JAX package leaves them to XLA.  Parameter names follow the reference
checkpoint (`ups.{i}.0`, `resblocks.{i*nk+j}.convs1.{d}`,
`resblocks.{...}.activations.{a}.act.alpha`, `encoder1.*`, ...), so a
reference `bigvgan.pt` state_dict loads with strict=True.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from cosyvoice_tpu_torch.device import resolve_device
from cosyvoice_tpu_torch.models.conformer import ConformerConfig, UpsampleConformerEncoder
from cosyvoice_tpu_torch.nn.conv import Conv1d, ConvTranspose1d
from cosyvoice_tpu_torch.nn.dense import Dense
from cosyvoice_tpu_torch.nn.dropout import dropout_generator
from cosyvoice_tpu_torch.ops.kernels.snake_aa import snake_aa
from cosyvoice_tpu_torch.ops.masks import make_non_pad_mask
from cosyvoice_tpu_torch.ops.resample import anti_alias_activation


@dataclass(frozen=True)
class BigVGANConfig:
    vocab_size: int = 6561
    input_size: int = 512
    output_size: int = 1024
    mel_bin: int = 80
    resblock: str = "1"
    upsample_rates: Sequence[int] = (4, 4, 4, 4, 2, 2)
    upsample_kernel_sizes: Sequence[int] = (8, 8, 4, 4, 4, 4)
    upsample_initial_channel: int = 1536
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    speaker_embedding_dim: int = 512
    cond_in_each_up_layer: bool = True
    activation: str = "snakebeta"
    snake_logscale: bool = True
    encoder1: Optional[ConformerConfig] = None  # optional 2x conformer upsamplers
    encoder2: Optional[ConformerConfig] = None
    # every AAAct through the fused kernel (K7; the JAX package's name for
    # its Pallas twin), else the composite
    use_pallas_act: bool = False


def __getattr__(name: str):
    """RECIPE: examples/tts_vc/cosyvoice2/conf/cosyvoice2_bigvgan_tts.yaml
    (the token->wav recipe: 25 Hz tokens, two 2x conformer encoders, 240x to
    24 kHz), read from the recipe by config.recipe_config on first use."""
    if name == "RECIPE":
        from cosyvoice_tpu_torch.config import recipe_config

        return recipe_config("cosyvoice2/conf/cosyvoice2_bigvgan_tts.yaml", "bigvgan")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


class _SnakeParams(nn.Module):
    """The reference's `Activation1d.act`: per-channel alpha (and beta),
    zeros under logscale, else ones."""

    def __init__(self, channels: int, with_beta: bool, logscale: bool):
        super().__init__()
        init = torch.zeros if logscale else torch.ones
        self.alpha = nn.Parameter(init(channels))
        self.beta = nn.Parameter(init(channels)) if with_beta else None


class AAAct(nn.Module):
    """Anti-aliased Snake ("snake") or SnakeBeta ("snakebeta") over [B, T, C]."""

    def __init__(self, channels: int, activation: str = "snakebeta", logscale: bool = True,
                 use_kernel: bool = False):
        super().__init__()
        if activation not in ("snake", "snakebeta"):
            raise ValueError(f"AAAct: activation must be snake|snakebeta, got {activation}")
        self.logscale, self.use_kernel = logscale, use_kernel
        self.act = _SnakeParams(channels, activation == "snakebeta", logscale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha, beta = self.act.alpha, self.act.beta
        if self.use_kernel:
            # the conv outputs are channels-first in memory; K7 reads and
            # writes that layout as it is
            return snake_aa(x, alpha, beta, self.logscale)
        if torch.is_grad_enabled():
            return checkpoint(anti_alias_activation, x, alpha, beta, self.logscale,
                              use_reentrant=False)
        return anti_alias_activation(x, alpha, beta, self.logscale)


class AMPBlock1(nn.Module):
    """(aa-act -> dilated conv -> aa-act -> conv) per dilation, residual."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations: Sequence[int] = (1, 3, 5),
                 activation: str = "snakebeta", logscale: bool = True, use_kernel: bool = False):
        super().__init__()
        self.convs1 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, dilation=d,
                   padding=_get_padding(kernel_size, d), weight_norm=True) for d in dilations)
        self.convs2 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, padding=_get_padding(kernel_size),
                   weight_norm=True) for _ in dilations)
        self.activations = nn.ModuleList(
            AAAct(channels, activation, logscale, use_kernel) for _ in range(2 * len(dilations)))

    def forward(self, x):
        for i, (c1, c2) in enumerate(zip(self.convs1, self.convs2)):
            xt = c2(self.activations[2 * i + 1](c1(self.activations[2 * i](x))))
            x = x + xt
        return x


class AMPBlock2(nn.Module):
    """The convs1-only variant: (aa-act -> dilated conv) per dilation, residual."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations: Sequence[int] = (1, 3, 5),
                 activation: str = "snakebeta", logscale: bool = True, use_kernel: bool = False):
        super().__init__()
        self.convs1 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, dilation=d,
                   padding=_get_padding(kernel_size, d), weight_norm=True) for d in dilations)
        self.activations = nn.ModuleList(
            AAAct(channels, activation, logscale, use_kernel) for _ in dilations)

    def forward(self, x):
        for conv, act in zip(self.convs1, self.activations):
            x = x + conv(act(x))
        return x


class BigVGAN(nn.Module):
    def __init__(self, cfg: BigVGANConfig = BigVGANConfig()):
        super().__init__()
        self.cfg = cfg
        ch0, spk = cfg.upsample_initial_channel, cfg.speaker_embedding_dim
        self.input_embedding = nn.Embedding(cfg.vocab_size, cfg.input_size)
        dim = cfg.input_size
        for name in ("encoder1", "encoder2"):
            enc = getattr(cfg, name)
            if enc is not None:
                setattr(self, name, UpsampleConformerEncoder(enc))
                dim = enc.dim
            else:
                setattr(self, name, None)
        self.encoder_proj = Dense(dim, cfg.output_size)
        self.mel_proj = Dense(dim if cfg.encoder2 is not None else ch0, cfg.mel_bin)
        self.conv_pre = Conv1d(cfg.output_size, ch0, 7, padding=3, weight_norm=True)
        self.cond_layer = Conv1d(spk, ch0, 1)
        self.ups = nn.ModuleList()
        self.conds = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        block_cls = AMPBlock1 if cfg.resblock == "1" else AMPBlock2
        ch = ch0
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            prev, ch = ch, ch0 // (2 ** (i + 1))
            self.ups.append(nn.ModuleList([ConvTranspose1d(prev, ch, k, u, padding=(k - u) // 2,
                                                           weight_norm=True)]))
            if cfg.cond_in_each_up_layer:
                self.conds.append(Conv1d(spk, ch, 1))
            for rk, rd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                self.resblocks.append(block_cls(ch, rk, rd, cfg.activation, cfg.snake_logscale,
                                                cfg.use_pallas_act))
        self.activation_post = AAAct(ch, cfg.activation, cfg.snake_logscale, cfg.use_pallas_act)
        self.conv_post = Conv1d(ch, 1, 7, padding=3, weight_norm=True)

    def forward(self, token: torch.Tensor, token_len: torch.Tensor,
                speaker_embedding: torch.Tensor,
                deterministic: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
        """token [B, T] (pad ids may be negative), token_len [B],
        speaker_embedding [B, spk_dim] -> (wav [B, T * prod(rates) * 2^n_enc],
        aux mel [B, T', mel_bin]).  deterministic (inference): no gradients,
        no dropout.  deterministic=False is the training forward: gradients
        as the caller has them, the conformers' dropout on the step's
        generator (nn/dropout.py); with use_pallas_act and gradients on, K7
        raises (it has no backward)."""
        if deterministic:
            with torch.no_grad(), dropout_generator(None):
                return self._forward(token, token_len, speaker_embedding)
        return self._forward(token, token_len, speaker_embedding)

    def _forward(self, token, token_len, speaker_embedding):
        cfg = self.cfg
        mask = make_non_pad_mask(token_len, token.shape[1])
        x = self.input_embedding(token.clamp_min(0)) * mask[..., None]
        mel = None
        for enc in (self.encoder1, self.encoder2):
            if enc is not None:
                x, _ = enc(x, token_len)
                token_len = token_len * 2
        if self.encoder2 is not None:
            mel = self.mel_proj(x)
        x = self.conv_pre(self.encoder_proj(x))
        spk = speaker_embedding[:, None, :]                  # [B, 1, spk_dim]
        x = x + self.cond_layer(spk)
        if self.encoder2 is None:
            mel = self.mel_proj(x)
        nk = len(cfg.resblock_kernel_sizes)
        for i, up in enumerate(self.ups):
            x = up[0](x)
            if cfg.cond_in_each_up_layer:
                x = x + self.conds[i](spk)
            xs = x * 0.0
            for j in range(nk):
                xs = xs + self.resblocks[i * nk + j](x)
            x = xs / nk
        x = self.conv_post(self.activation_post(x))
        return torch.tanh(x[..., 0]), mel


def load_bigvgan(cfg: Optional[BigVGANConfig] = None, state_dict: Optional[dict] = None,
                 device=None) -> BigVGAN:
    """A BigVGAN (default: RECIPE) in eval mode on `device` (default: the
    GPU), with a reference-named state_dict loaded strictly when one is
    given."""
    model = BigVGAN(cfg or __getattr__("RECIPE"))
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model.to(resolve_device(device)).eval()
