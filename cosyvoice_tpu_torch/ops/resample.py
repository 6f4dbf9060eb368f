"""Kaiser-sinc anti-aliasing around BigVGAN's Snake activations: 2x upsample
-> Snake/SnakeBeta -> 2x decimate, as depthwise convolutions on channels-last
[B, T, C] tensors over edge-replicated pads.

Port of the composite in cosyvoice_tpu/models/bigvgan.py (the XLA route of
`AAAct`); `ops/kernels/snake_aa.py` holds the fused kernel.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from cosyvoice_tpu_torch.ops.activations import snake, snake_beta


@lru_cache(maxsize=None)
def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """[kernel_size] fp32 lowpass FIR (Kaiser-windowed sinc, julius lineage)."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    A = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if A > 50.0:
        beta = 0.1102 * (A - 8.7)
    elif A >= 21.0:
        beta = 0.5842 * (A - 21) ** 0.4 + 0.07886 * (A - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    if even:
        time = np.arange(-half_size, half_size) + 0.5
    else:
        time = np.arange(kernel_size) - half_size
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    filt = filt / filt.sum()
    return filt.astype(np.float32)


RATIO = 2
TAPS = 12          # int(6 * RATIO // 2) * 2


def _filter(x: torch.Tensor) -> torch.Tensor:
    filt = torch.as_tensor(kaiser_sinc_filter1d(0.5 / RATIO, 0.6 / RATIO, TAPS),
                           dtype=x.dtype, device=x.device)
    return filt.view(1, 1, TAPS).expand(x.shape[-1], 1, TAPS)


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """Anti-aliased 2x upsample [B, T, C] -> [B, 2T, C]."""
    pad = TAPS // RATIO - 1
    pad_left = pad * RATIO + (TAPS - RATIO) // 2
    pad_right = pad * RATIO + (TAPS - RATIO + 1) // 2
    h = F.pad(x.transpose(1, 2), (pad, pad), mode="replicate")
    y = RATIO * F.conv_transpose1d(h, _filter(x), stride=RATIO, groups=x.shape[-1])
    return y[..., pad_left: y.shape[-1] - pad_right].transpose(1, 2)


def downsample2(x: torch.Tensor) -> torch.Tensor:
    """Anti-aliased 2x decimation [B, T, C] -> [B, T/2, C]."""
    h = F.pad(x.transpose(1, 2), (TAPS // 2 - 1, TAPS // 2), mode="replicate")
    return F.conv1d(h, _filter(x), stride=RATIO, groups=x.shape[-1]).transpose(1, 2)


def anti_alias_activation(x: torch.Tensor, alpha: torch.Tensor,
                          beta: Optional[torch.Tensor] = None,
                          logscale: bool = True) -> torch.Tensor:
    """2x upsample -> snake (beta None) or snake_beta -> 2x decimate."""
    y = upsample2(x)
    y = snake(y, alpha, logscale) if beta is None else snake_beta(y, alpha, beta, logscale)
    return downsample2(y)
