"""LayerNorm and GroupNorm with flax.linen's numerics (fp32 fast-variance
stats, output dtype promote(x, params)) under torch.nn's parameter names.
`fused` routes the LayerNorm, with an optional following mish, through the
fused_layer_norm kernel (the flow estimator's serving path)."""
from __future__ import annotations

import torch
import torch.nn as nn

from cosyvoice_tpu_torch.ops.kernels.fused_norm import fused_layer_norm, layer_norm_plain


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, fused: bool = False,
                 act: str = "none"):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps, self.fused, self.act = eps, fused, act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:   # the kernel takes rows in place: conv outputs are strided
            return fused_layer_norm(x.contiguous(), self.weight, self.bias, self.eps,
                                    self.act)
        return layer_norm_plain(x, self.weight, self.bias, self.eps, self.act)


def group_norm_plain(x: torch.Tensor, groups: int, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """flax.linen.GroupNorm on channels-last x [B, ..., C]: statistics over
    every non-batch axis of each group of C / groups channels, in fp32 with
    the fast-variance form E[x^2] - E[x]^2 (clamped at 0, as in flax; not
    torch.nn.GroupNorm's two-pass variance); output dtype promote(x, scale,
    bias)."""
    out_dtype = torch.promote_types(torch.promote_types(x.dtype, scale.dtype), bias.dtype)
    B, C = x.shape[0], x.shape[-1]
    xf = x.float().reshape(B, -1, groups, C // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = ((xf * xf).mean(dim=(1, 3), keepdim=True) - mean * mean).clamp_min(0.0)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return (y * scale.float() + bias.float()).to(out_dtype)


class GroupNorm(nn.Module):
    """GroupNorm with flax's numerics (group_norm_plain) under
    torch.nn.GroupNorm's parameter names, on channels-last input."""

    def __init__(self, groups: int, channels: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.groups, self.eps = groups, eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_plain(x, self.groups, self.weight, self.bias, self.eps)
