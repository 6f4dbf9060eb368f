"""Slot-based incremental flow engine for continuous streaming serving.

Port of cosyvoice_tpu/runtime/flow_engine.py.  `FlowSlotEngine` keeps one
`FlowChunkState` (models/flow_chunk.py) for `num_slots` concurrent streams on
the device and advances any subset of slots by one token chunk a call, so
every mel row is computed once against cached encoder K/V and per-Euler-step
estimator K/V.  `flow_slots_chunk` takes the JAX package's full-slot arrays
(n_valid 0 marks a slot that sits the call out) but runs only the enabled
slots: eager PyTorch compiles nothing per group shape, so disabled slots need
not ride along.  Admission re-arms a slot's small state (conv histories,
frontier, anchor); stale K/V rows lie past the slot's frontier or before its
left window and are masked by construction.  A prompt that leaves no room
in the slot's `tok_cap` tokens raises (the JAX package clamps its writes).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cosyvoice_tpu_torch.device import resolve_device
from cosyvoice_tpu_torch.models import flow_chunk as FC


@torch.no_grad()
def flow_slots_chunk(model, state: FC.FlowChunkState, tokens, ctx, ctx_len, n_valid,
                     pfeat, pfl, emb, noise_buf, first: bool, ragged: bool = True):
    """Advance the slots with n_valid > 0 by one chunk.  tokens [S, M] (row b
    pad past n_valid[b]), ctx [S, la] + ctx_len [S], pfeat [S, P, 80] + pfl
    [S] (first=True only), emb [S, spk], noise_buf [1, F, 80] the pinned CFM
    noise.  -> mel [S, ratio * M, 80] (zeros on the other slots); `state` is
    updated in place."""
    ratio = model.cfg.token_mel_ratio
    S, M = tokens.shape
    dev = tokens.device
    mel = torch.zeros((S, ratio * M, noise_buf.shape[-1]), dtype=torch.float32, device=dev)
    idx = torch.nonzero(n_valid > 0).flatten()
    if len(idx) == 0:
        return mel
    sub = state.rows(idx)
    starts = (ratio * sub.tok_pos).tolist()
    if max(starts) + ratio * M > noise_buf.shape[1]:
        raise ValueError(f"flow_slots_chunk: the {noise_buf.shape[1]}-frame noise buffer ends "
                         f"before mel row {max(starts) + ratio * M}")
    z = torch.stack([noise_buf[0, p:p + ratio * M] for p in starts]).to(dev)
    out, sub = FC.flow_chunk(model, tokens[idx], ctx[idx], pfeat[idx] if first else None,
                             pfl[idx] if first else None, emb[idx], n_valid[idx],
                             ctx_len[idx], sub, z, first=first, ragged_tail=ragged)
    state.set_rows(idx, sub)
    mel[idx] = out
    return mel


@torch.no_grad()
def flow_slots_reset(state: FC.FlowChunkState, keep: torch.Tensor,
                     anchor: torch.Tensor) -> FC.FlowChunkState:
    """Re-arm the slots where keep[b] is False for a fresh stream of anchor[b]
    prompt tokens: zero their conv histories and frontiers, set their anchors
    (in place).  The K/V caches stay: rows past a slot's frontier or before
    its left window are masked, and the first chunk overwrites the live ones."""
    keep = keep.to(state.tok_pos.device)
    keep2 = torch.cat([keep, keep])
    state.pre_hist[~keep] = 0
    state.ups_hist[~keep] = 0
    for v in state.est_conv.values():
        v[:, ~keep2] = 0
    state.tok_pos[~keep] = 0
    state.anchor[~keep] = anchor.to(state.anchor)[~keep]
    return state


class FlowSlotEngine:
    """Host wrapper: owns the device state and the slot allocation."""

    def __init__(self, model, num_slots: int, tok_cap: int, noise_buf, spk_dim: int,
                 enc_dtype=torch.float32, est_dtype=None, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.num_slots, self.tok_cap = num_slots, tok_cap
        self.noise_buf = torch.as_tensor(noise_buf, dtype=torch.float32).to(self.device)
        self.state = FC.init_state(model.cfg, num_slots, tok_cap, dtype=enc_dtype,
                                   est_dtype=est_dtype, device=self.device)
        self.free = list(range(num_slots))[::-1]
        self.emb = torch.zeros((num_slots, spk_dim), dtype=torch.float32, device=self.device)

    def admit(self, prompt_len: int, embedding: np.ndarray) -> int:
        """Claim a slot for a new stream whose chunk grid is anchored at
        prompt_len tokens; raises when the prompt leaves the slot no room."""
        if prompt_len >= self.tok_cap:
            raise ValueError(f"FlowSlotEngine.admit: a {prompt_len}-token prompt leaves no "
                             f"room in the slot's {self.tok_cap}-token cache (tok_cap)")
        slot = self.free.pop()
        keep = torch.ones(self.num_slots, dtype=torch.bool)
        keep[slot] = False
        anchor = torch.zeros(self.num_slots, dtype=torch.long)
        anchor[slot] = prompt_len
        flow_slots_reset(self.state, keep, anchor)
        self.emb[slot] = torch.as_tensor(np.asarray(embedding, np.float32)).to(self.device)
        return slot

    def release(self, slot: int) -> None:
        self.free.append(slot)

    def chunk(self, slots, tokens, ctx, ctx_len, n_valid, first: bool,
              pfeat: Optional[np.ndarray] = None, pfl: Optional[np.ndarray] = None,
              ragged: bool = True) -> torch.Tensor:
        """Advance the given slots (host arrays, one entry a job) and return
        the mel [num_slots, ratio * M, 80]: callers index its rows by slot."""
        S, M = self.num_slots, tokens.shape[1]
        full = lambda shape, dt: np.zeros(shape, dt)
        tok_f, ctx_f = full((S, M), np.int64), full((S, ctx.shape[1]), np.int64)
        cl_f, nv_f = full(S, np.int64), full(S, np.int64)
        tok_f[slots], ctx_f[slots], cl_f[slots], nv_f[slots] = tokens, ctx, ctx_len, n_valid
        if first:
            pf_f = full((S,) + pfeat.shape[1:], np.float32)
            pfl_f = full(S, np.int64)
            pf_f[slots], pfl_f[slots] = pfeat, pfl
        else:
            pf_f, pfl_f = full((S, 1, self.model.cfg.output_size), np.float32), full(S, np.int64)
        t = lambda a: torch.from_numpy(a).to(self.device)
        return flow_slots_chunk(self.model, self.state, t(tok_f), t(ctx_f), t(cl_f), t(nv_f),
                                t(pf_f), t(pfl_f), self.emb, self.noise_buf, first, ragged)
