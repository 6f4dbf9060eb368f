"""The delay pattern of the multi-codebook LMs (MusicGen style), and the
losses of the phoneme LMs' training.

Port of cosyvoice_tpu/ops/delay.py: get_delay_pattern /
revert_delay_pattern (codebook i is shifted right by i steps, with bos_id
filling its head and eos_id its tail; integer index work with exact
results), focal_loss (the multi-code LM's (1 - p)^gamma-weighted CE) and
vicreg_loss (the regulariser between a clean and an augmented speaker
vector of TransformerLMPhonemeWithSpk).  Both losses are computed in fp32.
"""
from __future__ import annotations

from typing import Optional

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


def focal_loss(logits: torch.Tensor, target: torch.Tensor, gamma: float = 1.0,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(1 - p)^gamma * CE over logits [..., V] and target [...]: the mean
    over the elements, or with `mask` (same shape as target, 0/1) the
    masked sum over max(mask sum, 1)."""
    logp_all = torch.log_softmax(logits.float(), dim=-1)
    logp = torch.gather(logp_all, -1, target.long()[..., None])[..., 0]
    loss = -((1.0 - logp.exp()) ** gamma) * logp
    if mask is None:
        return loss.mean()
    mask = mask.float()
    return (loss * mask).sum() / mask.sum().clamp_min(1.0)


def vicreg_loss(x: torch.Tensor, y: torch.Tensor, sim_coeff: float = 0.5,
                std_coeff: float = 0.4, cov_coeff: float = 0.1) -> torch.Tensor:
    """VICReg between x and y [B, D]: the invariance MSE, the variance hinge
    on ddof=1 standard deviations (eps 1e-4) and the off-diagonal
    covariance penalty, weighted sim / std / cov."""
    x, y = x.float(), y.float()
    B, D = x.shape
    repr_loss = ((x - y) ** 2).mean()
    xc, yc = x - x.mean(dim=0), y - y.mean(dim=0)
    std_x = torch.sqrt(xc.var(dim=0, correction=1) + 1e-4)
    std_y = torch.sqrt(yc.var(dim=0, correction=1) + 1e-4)
    std_loss = torch.relu(1 - std_x).mean() / 2 + torch.relu(1 - std_y).mean() / 2
    off = 1.0 - torch.eye(D, device=x.device)
    cov_x = (xc.T @ xc) / (B - 1)
    cov_y = (yc.T @ yc) / (B - 1)
    cov_loss = ((cov_x * off) ** 2).sum() / D + ((cov_y * off) ** 2).sum() / D
    return sim_coeff * repr_loss + std_coeff * std_loss + cov_coeff * cov_loss
