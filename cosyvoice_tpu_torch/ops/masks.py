"""Attention / padding masks.  Port of cosyvoice_tpu/ops/masks.py."""
from __future__ import annotations

import torch

NEG_INF = -1e9  # finite "minus infinity", as in the JAX package


def make_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, max_len] bool, True at PADDED positions."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return pos >= lengths[:, None]


def make_non_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, max_len] bool, True at VALID positions."""
    return ~make_pad_mask(lengths, max_len)


def subsequent_chunk_mask(size: int, chunk_size: int, num_left_chunks: int = -1,
                          device=None) -> torch.Tensor:
    """Chunk-causal mask [size, size] (True == attend): position i attends to
    [start, (i // chunk + 1) * chunk)."""
    q = torch.arange(size, device=device)[:, None]
    k = torch.arange(size, device=device)[None, :]
    q_chunk = torch.div(q, chunk_size, rounding_mode="floor")
    end = (q_chunk + 1) * chunk_size
    if num_left_chunks < 0:
        start = torch.zeros_like(end)
    else:
        start = ((q_chunk - num_left_chunks) * chunk_size).clamp_min(0)
    return (k >= start) & (k < end)


def add_chunk_mask(pad_mask: torch.Tensor, static_chunk_size: int = 0,
                   num_left_chunks: int = -1) -> torch.Tensor:
    """Combine a [B, T] (or [B, 1, T]) key pad mask with a static chunk-causal
    mask.  Returns [B, T, T] bool."""
    if pad_mask.ndim == 2:
        pad_mask = pad_mask[:, None, :]
    T = pad_mask.shape[-1]
    if static_chunk_size and static_chunk_size > 0:
        cm = subsequent_chunk_mask(T, static_chunk_size, num_left_chunks,
                                   device=pad_mask.device)
        return pad_mask & cm[None]
    return pad_mask.expand(pad_mask.shape[0], T, T)



def anchored_chunk_ids(pos: torch.Tensor, anchor: torch.Tensor,
                       chunk_size: int) -> torch.Tensor:
    """Chunk index of absolute position(s) `pos` on a grid anchored at
    `anchor` (the prompt/generation boundary): the whole prompt [0, anchor)
    is chunk 0, then one chunk a `chunk_size` positions.  Incremental
    streaming flow emits hops that are multiples of chunk_size, so every
    serving chunk ends on a grid boundary for any prompt length.  `anchor`
    broadcasts against `pos`."""
    rel = pos - anchor
    return torch.where(rel < 0, torch.zeros_like(rel),
                       torch.div(rel, chunk_size, rounding_mode="floor") + 1)


def anchored_chunk_mask(pad_mask: torch.Tensor, chunk_size: int, anchor,
                        num_left_chunks: int = -1) -> torch.Tensor:
    """Chunk-causal mask on the anchored grid combined with a [B, T] (or
    [B, 1, T]) key pad mask -> [B, T, T] bool.  `anchor` is [B] or a scalar;
    num_left_chunks >= 0 bounds the visible left context."""
    if pad_mask.ndim == 2:
        pad_mask = pad_mask[:, None, :]
    T = pad_mask.shape[-1]
    pos = torch.arange(T, device=pad_mask.device)
    anchor = torch.as_tensor(anchor, device=pad_mask.device).reshape(-1)
    cid = anchored_chunk_ids(pos[None, :], anchor[:, None], chunk_size)
    ok = cid[:, None, :] <= cid[:, :, None]
    if num_left_chunks >= 0:
        ok = ok & (cid[:, None, :] >= cid[:, :, None] - num_left_chunks)
    return pad_mask & ok
