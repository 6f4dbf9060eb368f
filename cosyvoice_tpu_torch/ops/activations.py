"""Activations: Snake and SnakeBeta (vocoders), Swish, Mish, and the serving
polynomial sine.  Port of cosyvoice_tpu/ops/activations.py."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def fast_sin(x: torch.Tensor) -> torch.Tensor:
    """Polynomial sine (serving `approx_sin`): range-reduce to turns
    t = x/2pi - round(x/2pi) and evaluate a degree-9 odd polynomial for
    sin(2 pi t); max abs error 6e-6, below bf16 resolution."""
    t = x * 0.15915494309189535          # 1/(2 pi)
    t = t - torch.round(t)               # [-0.5, 0.5] turns
    t2 = t * t
    p = -74.4709398448 + t2 * 32.7688270164
    p = 81.3654923803 + t2 * p
    p = -41.3311225804 + t2 * p
    return t * (6.2830540822 + t2 * p)


def snake(x: torch.Tensor, alpha: torch.Tensor, alpha_logscale: bool = False,
          eps: float = 1e-9, approx_sin: bool = False) -> torch.Tensor:
    """x + (1/alpha) * sin^2(alpha * x); alpha broadcasts over the channel axis."""
    if alpha_logscale:
        alpha = torch.exp(alpha)
    s = (fast_sin if approx_sin else torch.sin)(alpha * x)
    return x + (1.0 / (alpha + eps)) * s * s


def snake_beta(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
               alpha_logscale: bool = True, eps: float = 1e-9) -> torch.Tensor:
    """x + (1/beta) * sin^2(alpha * x): BigVGAN's SnakeBeta."""
    if alpha_logscale:
        alpha = torch.exp(alpha)
        beta = torch.exp(beta)
    s = torch.sin(alpha * x)
    return x + (1.0 / (beta + eps)) * s * s


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))
