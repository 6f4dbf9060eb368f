"""CAM++ speaker verification network (16 kHz prompt audio -> speaker vector).

Port of cosyvoice_tpu/models/campplus.py in the reference's own layout
([B, C, T]) and under its module names (`head.*`, `xvector.*`), which are the
initializer names of a released `campplus.onnx`: an FCM 2-D residual front,
a TDNN stem of stride 2, three CAM dense-TDNN blocks (12 / 24 / 16 layers,
growth 32, bottleneck 128, dilations 1 / 2 / 2) each followed by a halving
transit layer, statistics pooling (mean ++ unbiased std) and a dense head
with an affine-free BatchNorm.  Every BatchNorm runs in eval mode on its
running statistics.  A CAM layer gates its local convolution with the
global mean plus a 100-frame average pooling in ceil mode, whose last
segment averages only the frames it holds.  The frontend feeds kaldi fbank
80 with per-utterance mean normalization, at the prompt's exact length (the
pooled statistics would change under padding).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from cosyvoice_tpu_torch.ops.kaldi import kaldi_fbank
from cosyvoice_tpu_torch.utils.checkpoint import load_by_name
from cosyvoice_tpu_torch.utils.onnx_io import read_onnx_tensors


@dataclass(frozen=True)
class CAMPPlusConfig:
    feat_dim: int = 80
    embedding_size: int = 192  # the released campplus.onnx
    growth_rate: int = 32
    bn_size: int = 4
    init_channels: int = 128
    blocks: Sequence[tuple[int, int, int]] = ((12, 3, 1), (24, 3, 2), (16, 3, 2))


def nonlinear(config: str, channels: int) -> nn.Sequential:
    """The reference's 'batchnorm-relu' / 'batchnorm_' stacks."""
    seq = nn.Sequential()
    for name in config.split("-"):
        if name == "relu":
            seq.add_module("relu", nn.ReLU())
        elif name == "batchnorm":
            seq.add_module("batchnorm", nn.BatchNorm1d(channels))
        elif name == "batchnorm_":
            seq.add_module("batchnorm", nn.BatchNorm1d(channels, affine=False))
        else:
            raise ValueError(f"unknown nonlinearity {name!r}")
    return seq


class BasicResBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, (stride, 1), 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.shortcut = nn.Sequential()
        if stride != 1 or in_planes != planes:
            self.shortcut = nn.Sequential(nn.Conv2d(in_planes, planes, 1, (stride, 1), bias=False),
                                          nn.BatchNorm2d(planes))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(out)) + self.shortcut(x))


class FCM(nn.Module):
    """2-D conv front: [B, F, T] -> [B, m_channels * F', T] (F' = F / 8, rounded up)."""

    def __init__(self, feat_dim: int = 80, m_channels: int = 32, num_blocks=(2, 2)):
        super().__init__()
        self.conv1 = nn.Conv2d(1, m_channels, 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(m_channels)
        self.layer1 = nn.Sequential(*[BasicResBlock(m_channels, m_channels, 2 if i == 0 else 1)
                                      for i in range(num_blocks[0])])
        self.layer2 = nn.Sequential(*[BasicResBlock(m_channels, m_channels, 2 if i == 0 else 1)
                                      for i in range(num_blocks[1])])
        self.conv2 = nn.Conv2d(m_channels, m_channels, 3, (2, 1), 1, bias=False)
        self.bn2 = nn.BatchNorm2d(m_channels)
        f = feat_dim
        for _ in range(3):              # three stride-2 convolutions along F
            f = (f + 1) // 2
        self.out_channels = m_channels * f

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x.unsqueeze(1))))
        out = self.layer2(self.layer1(out))
        out = F.relu(self.bn2(self.conv2(out)))
        return out.reshape(out.shape[0], out.shape[1] * out.shape[2], out.shape[3])


class TDNNLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int):
        super().__init__()
        self.linear = nn.Conv1d(in_channels, out_channels, kernel_size, stride,
                                padding=(kernel_size - 1) // 2, bias=False)
        self.nonlinear = nonlinear("batchnorm-relu", out_channels)

    def forward(self, x):
        return self.nonlinear(self.linear(x))


class CAMLayer(nn.Module):
    """A local convolution gated by sigmoid(mlp(global mean + segment pooling))."""

    def __init__(self, bn_channels: int, out_channels: int, kernel_size: int, dilation: int,
                 reduction: int = 2, seg_len: int = 100):
        super().__init__()
        self.seg_len = seg_len
        self.linear_local = nn.Conv1d(bn_channels, out_channels, kernel_size,
                                      padding=(kernel_size - 1) // 2 * dilation,
                                      dilation=dilation, bias=False)
        self.linear1 = nn.Conv1d(bn_channels, bn_channels // reduction, 1)
        self.linear2 = nn.Conv1d(bn_channels // reduction, out_channels, 1)

    def forward(self, x):
        y = self.linear_local(x)
        T = x.shape[-1]
        # ceil mode without padding: the last segment averages its real frames only
        seg = F.avg_pool1d(x, self.seg_len, self.seg_len, ceil_mode=True)
        seg = seg.repeat_interleave(self.seg_len, dim=-1)[..., :T]
        context = x.mean(dim=-1, keepdim=True) + seg
        m = self.linear2(F.relu(self.linear1(context)))
        return y * torch.sigmoid(m)


class CAMDenseTDNNLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, bn_channels: int,
                 kernel_size: int, dilation: int):
        super().__init__()
        self.nonlinear1 = nonlinear("batchnorm-relu", in_channels)
        self.linear1 = nn.Conv1d(in_channels, bn_channels, 1, bias=False)
        self.nonlinear2 = nonlinear("batchnorm-relu", bn_channels)
        self.cam_layer = CAMLayer(bn_channels, out_channels, kernel_size, dilation)

    def forward(self, x):
        return self.cam_layer(self.nonlinear2(self.linear1(self.nonlinear1(x))))


class CAMDenseTDNNBlock(nn.Module):
    """Dense connectivity: each layer's output is appended to its input."""

    def __init__(self, num_layers: int, in_channels: int, out_channels: int,
                 bn_channels: int, kernel_size: int, dilation: int):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"tdnnd{i + 1}", CAMDenseTDNNLayer(
                in_channels + i * out_channels, out_channels, bn_channels, kernel_size,
                dilation))

    def forward(self, x):
        for layer in self.children():
            x = torch.cat([x, layer(x)], dim=1)
        return x


class TransitLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.nonlinear = nonlinear("batchnorm-relu", in_channels)
        self.linear = nn.Conv1d(in_channels, out_channels, 1, bias=False)

    def forward(self, x):
        return self.linear(self.nonlinear(x))


class StatsPool(nn.Module):
    def forward(self, x):
        return torch.cat([x.mean(dim=-1), x.std(dim=-1, unbiased=True)], dim=-1)


class DenseLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.linear = nn.Conv1d(in_channels, out_channels, 1, bias=False)
        self.nonlinear = nonlinear("batchnorm_", out_channels)

    def forward(self, x):
        return self.nonlinear(self.linear(x.unsqueeze(-1)).squeeze(-1))


class CAMPPlus(nn.Module):
    def __init__(self, cfg: CAMPPlusConfig = CAMPPlusConfig()):
        super().__init__()
        self.cfg = cfg
        self.head = FCM(feat_dim=cfg.feat_dim)
        channels = self.head.out_channels
        self.xvector = nn.Sequential()
        self.xvector.add_module("tdnn", TDNNLayer(channels, cfg.init_channels, 5, stride=2))
        channels = cfg.init_channels
        for i, (n_layers, k, d) in enumerate(cfg.blocks):
            self.xvector.add_module(f"block{i + 1}", CAMDenseTDNNBlock(
                n_layers, channels, cfg.growth_rate, cfg.bn_size * cfg.growth_rate, k, d))
            channels += n_layers * cfg.growth_rate
            self.xvector.add_module(f"transit{i + 1}", TransitLayer(channels, channels // 2))
            channels //= 2
        self.xvector.add_module("out_nonlinear", nonlinear("batchnorm-relu", channels))
        self.xvector.add_module("stats", StatsPool())
        self.xvector.add_module("dense", DenseLayer(2 * channels, cfg.embedding_size))
        self.eval()

    def train(self, mode: bool = True) -> "CAMPPlus":
        """Every BatchNorm stays in eval mode (the JAX module's training
        forwards read the running statistics too), so a training forward
        that embeds through CAMPPlus neither normalises by its batch nor
        moves the statistics."""
        super().train(mode)
        for m in self.modules():
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.eval()
        return self

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """feats [B, T, feat_dim] (kaldi fbank, mean-normed) -> [B, embedding_size]."""
        return self.xvector(self.head(feats.transpose(1, 2)))


def campplus_embed(model: CAMPPlus, wav_16k: np.ndarray) -> np.ndarray:
    """kaldi fbank 80 (dither 0), per-utterance mean normalization, CAMPPlus
    -> the speaker vector, on the model's device."""
    device = next(model.parameters()).device
    with torch.inference_mode():
        feat = kaldi_fbank(torch.as_tensor(np.asarray(wav_16k, np.float32), device=device),
                           num_mel_bins=model.cfg.feat_dim)
        feat = feat - feat.mean(dim=0, keepdim=True)
        return model(feat[None])[0].float().cpu().numpy()


def make_campplus_frontend_fn(model: CAMPPlus) -> Callable[[np.ndarray], np.ndarray]:
    """`wav16k [S] -> speaker vector [embedding_size]` for CosyVoiceFrontEnd,
    at the prompt's exact length."""
    return lambda wav_16k: campplus_embed(model, wav_16k)


def import_campplus_onnx(path: str, cfg: CAMPPlusConfig = CAMPPlusConfig(),
                         device=None) -> CAMPPlus:
    """A released `campplus.onnx` -> CAMPPlus on `device` (None: the GPU).

    The file is a torch export of the reference module, so its initializers
    carry the module's state_dict names; they load by name (BatchNorm's
    `num_batches_tracked` is not read, a missing weight raises KeyError)."""
    from cosyvoice_tpu_torch.device import resolve_device

    model = CAMPPlus(cfg)
    load_by_name(model, read_onnx_tensors(path), path)
    return model.to(resolve_device(device)).eval()
