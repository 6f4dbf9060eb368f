"""Token sampling: nucleus / repetition-aware (RAS and its non-random
variant) / greedy with explicit torch.Generators.  Port of
cosyvoice_tpu/ops/sampling.py; the keep-set rule is the reference's (sort
descending, keep i iff the probability mass before i is < top_p and
i < top_k, so the arg-max is always kept)."""
from __future__ import annotations

import torch


def nucleus_mask(sorted_probs: torch.Tensor, top_p: float, top_k: int) -> torch.Tensor:
    """Keep-mask over DESC-sorted probs."""
    excl_cumsum = torch.cumsum(sorted_probs, dim=-1) - sorted_probs
    ranks = torch.arange(sorted_probs.shape[-1], device=sorted_probs.device)
    return (excl_cumsum < top_p) & (ranks < top_k)


def _categorical(gen: torch.Generator, probs: torch.Tensor) -> torch.Tensor:
    """One draw per row of probs [..., K] -> [...]; the draw happens on the
    generator's device so a CPU generator gives the same ids on every device."""
    flat = probs.reshape(-1, probs.shape[-1])
    draw = torch.multinomial(flat.to(gen.device), 1, generator=gen)
    return draw[:, 0].to(probs.device).reshape(probs.shape[:-1])


def nucleus_sample(gen: torch.Generator, logits: torch.Tensor, top_p: float = 0.8,
                   top_k: int = 25) -> torch.Tensor:
    """logits [..., V] -> [...] ids drawn from the top-p/top-k nucleus (the
    multi-codebook LMs draw [B, C, V] in one call)."""
    probs = torch.softmax(logits.float(), dim=-1)
    k = min(int(top_k), logits.shape[-1])
    top_probs, top_idx = torch.topk(probs, k, dim=-1)
    keep = nucleus_mask(top_probs, top_p, top_k)
    choice = _categorical(gen, torch.where(keep, top_probs, torch.zeros_like(top_probs)))
    return torch.gather(top_idx, -1, choice[..., None])[..., 0]


def random_sample(gen: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
    """Sample from the full softmax."""
    return _categorical(gen, torch.softmax(logits.float(), dim=-1))


def ras_sample(gen: torch.Generator, logits: torch.Tensor, recent: torch.Tensor,
               recent_valid: torch.Tensor, top_p: float = 0.8, top_k: int = 25,
               win_size: int = 10, tau_r: float = 0.1) -> torch.Tensor:
    """Repetition-aware sampling: a nucleus draw, replaced by a draw from the
    full softmax when the drawn id already appears >= win_size * tau_r times
    among the last `win_size` emitted ids."""
    cand = nucleus_sample(gen, logits, top_p, top_k)
    reps = ((recent == cand[:, None]) & recent_valid).sum(dim=-1)
    fallback = random_sample(gen, logits)
    return torch.where(reps >= win_size * tau_r, fallback, cand)


def non_random_ras_sample(gen: torch.Generator, logits: torch.Tensor, recent: torch.Tensor,
                          recent_valid: torch.Tensor, top_p: float = 0.8, top_k: int = 25,
                          win_size: int = 10, tau_r: float = 0.1,
                          expand_scale: int = 2) -> torch.Tensor:
    """RAS whose fallback is a draw from an expanded nucleus (top_p + 0.15,
    top_k * expand_scale) instead of the full softmax (CosyVoice v1)."""
    cand = nucleus_sample(gen, logits, top_p, top_k)
    reps = ((recent == cand[:, None]) & recent_valid).sum(dim=-1)
    fallback = nucleus_sample(gen, logits, top_p + 0.15, top_k * expand_scale)
    return torch.where(reps >= win_size * tau_r, fallback, cand)


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1)
