"""1-D convolutions on channels-last [B, T, C] tensors, with torch-exact
shape/padding semantics and optional weight norm.

Port of cosyvoice_tpu/nn/conv.py.  Parameters are stored in torch's layout
and under the reference checkpoints' names: Conv1d `weight` [out, in/groups, k]
(or `weight_g` [out, 1, 1] + `weight_v` with weight norm, one norm per output
channel), ConvTranspose1d `weight` [in, out, k] (or `weight_g` [in, 1, 1] +
`weight_v`, one norm per input channel).  The JAX package's `pack_conv_weights`
/ `lane_pack` are left out: they regroup the same multiply-accumulates to fill
the TPU's 128 lanes and have exact numerics, so the port has nothing to gain.

Spectral norm (the scale discriminator's first net) follows the JAX
package, not torch.nn.utils.spectral_norm: weight = W / sigma with sigma =
u^T W_mat v, where the buffers `weight_u` / `weight_v` are imported from a
reference checkpoint or drawn at random, and `sn_iters` power iterations
refresh them without gradient on each forward and are not kept (torch's
version keeps one iteration's state from call to call).  `Conv2d` is
torch.nn.Conv2d on channels-first [B, C, H, W] maps (the discriminators'),
with optional weight norm (`weight_g` [out, 1, 1, 1], one norm per output
channel).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def _l2n(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """F.normalize(dim=0, eps=1e-12) of a vector."""
    return x / torch.clamp(torch.linalg.vector_norm(x), min=eps)


def _spectral(module: nn.Module) -> torch.Tensor:
    w = module.weight_orig
    w_mat = w.reshape(w.shape[0], -1)
    u, v = module.weight_u, module.weight_v
    if module.sn_iters:
        with torch.no_grad():
            wm = w_mat.detach()
            for _ in range(module.sn_iters):
                v = _l2n(wm.T @ u)
                u = _l2n(wm @ v)
    return w / (u @ w_mat @ v)


def _weight(module: nn.Module, norm_dims: tuple) -> torch.Tensor:
    if module.weight_norm:
        v = module.weight_v
        return module.weight_g * v / torch.sqrt(torch.sum(v * v, dim=norm_dims, keepdim=True))
    if getattr(module, "spectral_norm", False):
        return _spectral(module)
    return module.weight


class Conv1d(nn.Module):
    """torch.nn.Conv1d on [B, T, C]; padding is an int or (left, right)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int | tuple[int, int] = 0,
                 dilation: int = 1, groups: int = 1, bias: bool = True,
                 weight_norm: bool = False, spectral_norm: bool = False, sn_iters: int = 0):
        super().__init__()
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.padding = padding if isinstance(padding, tuple) else (padding, padding)
        self.weight_norm, self.spectral_norm, self.sn_iters = weight_norm, spectral_norm, sn_iters
        shape = (out_channels, in_channels // groups, kernel_size)
        init = torch.randn(shape) * (in_channels * kernel_size) ** -0.5
        if weight_norm:
            self.weight_g = nn.Parameter(torch.ones(out_channels, 1, 1))
            self.weight_v = nn.Parameter(init)
        elif spectral_norm:
            self.weight_orig = nn.Parameter(init)
            self.register_buffer("weight_u", _l2n(torch.randn(out_channels)))
            self.register_buffer("weight_v", _l2n(torch.randn(shape[1] * kernel_size)))
        else:
            self.weight = nn.Parameter(init)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = _weight(self, (1, 2)).to(x.dtype)
        h = F.pad(x.transpose(1, 2), self.padding)
        y = F.conv1d(h, w, None, self.stride, 0, self.dilation, self.groups).transpose(1, 2)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class ConvTranspose1d(nn.Module):
    """torch.nn.ConvTranspose1d (output_padding 0) on [B, T, C]."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 weight_norm: bool = False):
        super().__init__()
        self.stride, self.padding, self.weight_norm = stride, padding, weight_norm
        shape = (in_channels, out_channels, kernel_size)
        if weight_norm:
            self.weight_g = nn.Parameter(torch.ones(in_channels, 1, 1))
            self.weight_v = nn.Parameter(torch.randn(shape) * (in_channels * kernel_size) ** -0.5)
        else:
            self.weight = nn.Parameter(torch.randn(shape) * (in_channels * kernel_size) ** -0.5)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = _weight(self, (1, 2)).to(x.dtype)
        y = F.conv_transpose1d(x.transpose(1, 2), w, None, self.stride,
                               self.padding).transpose(1, 2)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class CausalConv1d(Conv1d):
    """Left-padded conv: output at t sees inputs <= t."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 dilation: int = 1, bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size,
                         padding=((kernel_size - 1) * dilation, 0),
                         dilation=dilation, bias=bias)


class Conv2d(nn.Module):
    """torch.nn.Conv2d on [B, C, H, W]; padding (ph, pw) on both sides."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: tuple[int, int],
                 stride: tuple[int, int] = (1, 1), padding: tuple[int, int] = (0, 0),
                 bias: bool = True, weight_norm: bool = False):
        super().__init__()
        self.stride, self.padding, self.weight_norm = tuple(stride), tuple(padding), weight_norm
        shape = (out_channels, in_channels, *kernel_size)
        init = torch.randn(shape) * (in_channels * kernel_size[0] * kernel_size[1]) ** -0.5
        if weight_norm:
            self.weight_g = nn.Parameter(torch.ones(out_channels, 1, 1, 1))
            self.weight_v = nn.Parameter(init)
        else:
            self.weight = nn.Parameter(init)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = _weight(self, (1, 2, 3)).to(x.dtype)
        return F.conv2d(x, w, None if self.bias is None else self.bias.to(x.dtype),
                        self.stride, self.padding)
