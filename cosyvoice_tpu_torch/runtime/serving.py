"""Batched serving: collect requests, right-pad them to shared buckets, run one
batched LM decode, one ragged-batched flow call and one batched vocoder call,
and return each request's waveform.

Port of `TTSRequest`, `_noise_for` and `BatchedSynthesizer` of
cosyvoice_tpu/runtime/serving.py.  All three stages share their weight reads
across the batch.  The flow call carries each row's own prompt length
(`prompt_feat_len`), so rows of different lengths go through one estimator
call per Euler step (its DiT blocks through the dit_block_fused kernel when
the estimator has `fused_block`).  The JAX package's multi-chip `mesh`, the
streaming `ContinuousSynthesizer` and phoneme-LM requests are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from cosyvoice_tpu_torch.models.llm import lm_generate
from cosyvoice_tpu_torch.runtime.model import CosyVoice2Model, round_up


def _noise_for(model: CosyVoice2Model, bucket_tokens: int) -> Optional[torch.Tensor]:
    """The model's pinned CFM noise sliced to the batch's mel bucket, as the
    sequential path slices it, so batched and sequential synthesis of one
    request see the same noise on its rows (None: the CFM's own buffer)."""
    return model.pinned_noise(model.ratio * bucket_tokens)


@dataclass
class TTSRequest:
    text_tokens: np.ndarray            # prompt_text ++ text ids
    prompt_text_len: int
    prompt_speech_tokens: np.ndarray
    prompt_feat: np.ndarray            # [P, 80]
    embedding: np.ndarray              # [spk_dim]
    # phoneme-LM requests: not ported yet (raise)
    pho_token: Optional[np.ndarray] = None


@dataclass
class BatchedSynthesizer:
    """Non-streaming batched synthesis over a CosyVoice2Model, on its device."""

    model: CosyVoice2Model
    text_bucket: int = 32              # pad text lengths to multiples
    speech_bucket: int = 64
    mesh: Optional[object] = None      # multi-chip serving: not ported yet

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "multi-chip batched serving (mesh) is not ported yet: ROADMAP Queue 1 "
                "item 11 (parallel/ -> torch.distributed)")

    def synthesize_batch(self, requests: Sequence[TTSRequest],
                         gen: Optional[torch.Generator] = None) -> list[np.ndarray]:
        """Synthesize B requests together: batched LM decode, then one ragged
        flow call (per-row prompt lengths) and one batched vocoder call.
        `gen` drives the LM's sampling (default: seed 0); the vocoder's
        source noise comes from a generator seeded from it."""
        if any(r.pho_token is not None for r in requests):
            raise NotImplementedError("phoneme-LM requests are not ported yet (ROADMAP "
                                      "Queue 1 item 9)")
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        tokens = self.generate(requests, gen)
        mel, tls, pfl = self.flow_batch(requests, tokens)
        return self.vocode_batch(mel, tls, pfl, torch.Generator().manual_seed(
            gen.initial_seed() + 1))

    def generate(self, requests: Sequence[TTSRequest],
                 gen: torch.Generator) -> list[np.ndarray]:
        """One batched lm_generate over the right-padded prompts; returns each
        row's emitted tokens."""
        m = self.model
        B = len(requests)
        Tt = round_up(max(len(r.text_tokens) for r in requests), self.text_bucket)
        Ts = round_up(max((len(r.prompt_speech_tokens) for r in requests), default=0) or 1,
                      self.speech_bucket)
        text = np.zeros((B, Tt), np.int64)
        psp = np.zeros((B, Ts), np.int64)
        tlen, plen, min_len, max_len, allowed = (np.zeros(B, np.int64) for _ in range(5))
        cap = 0
        for i, r in enumerate(requests):
            n, k = len(r.text_tokens), len(r.prompt_speech_tokens)
            text[i, :n], tlen[i] = r.text_tokens, n
            psp[i, :k], plen[i] = r.prompt_speech_tokens, k
            new_text = n - r.prompt_text_len
            min_len[i] = int(new_text * m.llm.cfg.min_token_text_ratio)
            allowed[i] = int(new_text * m.llm.cfg.max_token_text_ratio)
            cap = max(cap, m.decode_cap(new_text))
        max_len[:] = np.minimum(allowed, cap)
        t = lambda a: m._tensor(a, torch.long)
        out, count = lm_generate(m.llm, t(text), t(tlen), t(psp), t(plen), t(min_len),
                                 t(max_len), gen, max_steps=cap,
                                 cache_len=round_up(2 + Tt + Ts + cap, 128))
        out, count = out.cpu().numpy(), count.cpu().numpy()
        for i in range(B):
            m._warn_if_capped(int(count[i]), int(allowed[i]), int(max_len[i]))
        return [out[i, :count[i]] for i in range(B)]

    def flow_batch(self, requests: Sequence[TTSRequest], tokens: Sequence[np.ndarray]):
        """One ragged-batched flow call over prompt ++ generated tokens per row;
        returns (mel [B, ratio*Ttok, 80], token lengths, prompt mel lengths)."""
        m = self.model
        B = len(requests)
        tls = [len(r.prompt_speech_tokens) + len(tok) for r, tok in zip(requests, tokens)]
        Ttok = round_up(max(tls), self.speech_bucket)
        tok = np.zeros((B, Ttok), np.int64)
        pfl = np.asarray([r.prompt_feat.shape[0] for r in requests], np.int64)
        pf = np.zeros((B, max(pfl), m.flow.cfg.output_size), np.float32)
        for i, r in enumerate(requests):
            ps = r.prompt_speech_tokens
            tok[i, :len(ps)] = ps
            tok[i, len(ps):tls[i]] = tokens[i]
            pf[i, :pfl[i]] = r.prompt_feat
        emb = np.stack([np.asarray(r.embedding, np.float32) for r in requests])
        mel = m.flow.inference(m._tensor(tok, torch.long), m._tensor(tls, torch.long),
                               m._tensor(pf, torch.float32), m._tensor(emb, torch.float32),
                               noise=_noise_for(m, Ttok),
                               prompt_feat_len=m._tensor(pfl, torch.long))
        return mel, tls, pfl

    def vocode_batch(self, mel: torch.Tensor, tls, pfl,
                     gen: torch.Generator) -> list[np.ndarray]:
        """Repack each row's generated mel region, one batched HiFT call."""
        m = self.model
        Ls = [m.ratio * n - int(p) for n, p in zip(tls, pfl)]
        Lmax = round_up(max(Ls), 32)
        gen_mel = torch.stack([F.pad(mel[i, pfl[i]:pfl[i] + Ls[i]].float(),
                                     (0, 0, 0, Lmax - Ls[i])) for i in range(len(Ls))])
        wav, _ = m.hift.inference(gen_mel, gen=gen)
        wav = wav.cpu().numpy()
        return [wav[i, :Ls[i] * m.hop_samples] for i in range(len(Ls))]
