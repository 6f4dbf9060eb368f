"""The delay pattern of the multi-codebook LMs (MusicGen style).

Port of get_delay_pattern / revert_delay_pattern of
cosyvoice_tpu/ops/delay.py: codebook i is shifted right by i steps, with
bos_id filling its head and eos_id its tail.  Integer index work with exact
results; the losses of that module come with training.
"""
from __future__ import annotations

import torch


def get_delay_pattern(codec: torch.Tensor, bos_id: int, eos_id: int) -> torch.Tensor:
    """[B, T, N] -> [B, T + N - 1, N]: codebook i delayed by i steps."""
    B, T, N = codec.shape
    out = torch.full((B, T + N - 1, N), eos_id, dtype=codec.dtype, device=codec.device)
    for i in range(N):
        out[:, :i, i] = bos_id
        out[:, i:i + T, i] = codec[:, :, i]
    return out


def revert_delay_pattern(codec: torch.Tensor) -> torch.Tensor:
    """[B, T, N] delayed -> [B, T - (N - 1), N] aligned."""
    B, T, N = codec.shape
    real = T - (N - 1)
    return torch.stack([codec[:, i:i + real, i] for i in range(N)], dim=-1)
