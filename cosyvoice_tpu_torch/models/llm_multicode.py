"""The multi-codebook (delay-pattern) phoneme LM: 6 codec codes a step.

Port of cosyvoice_tpu/models/llm_multicode.py (cosyvoice2_multicode.yaml):
  * text and phonemes fused by `src_attn_layers` cross-attention
    DecoderLayers (query: phonemes), as in Qwen2LMPhonemeSrc2;
  * the input is [sos, spk, fused(pho), task, code rows], each code row the
    SUM of its `codebooknum` code embeddings (one table a codebook, max_id
    = speech_token_size + 2 ids each: the codes, EOS, BOS);
  * the ARDecoder head maps the hidden state to [.., max_id, codebooknum]
    logits;
  * multicode_generate samples all codebooks each step (greedy, or the
    nucleus draw for any other method: like the JAX package it ignores the
    recipe's RAS) and returns the delayed matrix with its leading BOS row;
    ops/delay.revert_delay_pattern aligns it on the host.
Every one-token step runs the Qwen2 body, so with fused_cache_update it
goes through the lm_decode_attention kernel.  The training forward applies
the delay pattern to the aligned codes, grafts the delayed rows' summed
embeddings after the task slot and takes ops/delay.focal_loss (gamma 1)
of the delayed codes plus a trailing EOS row, from the task slot on.

Parameter names: those of the phoneme LMs (models/llm_phoneme.py) plus
`src_attention.{i}`, `code_embeddings.{i}` and `ar_decoder.model`; the JAX
tree's `llm_decoder` never receives parameters (its training forward
does not call it), so the port has none.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn

from cosyvoice_tpu_torch.models.llm_phoneme import (DecoderLayer, PhonemeLMConfig,
                                                    _PhonemeLMBase)
from cosyvoice_tpu_torch.models.qwen2 import KVCache, causal_prefill_bias
from cosyvoice_tpu_torch.nn.dense import Dense
from cosyvoice_tpu_torch.ops import sampling as samp
from cosyvoice_tpu_torch.ops.delay import focal_loss, get_delay_pattern
from cosyvoice_tpu_torch.ops.masks import NEG_INF


@dataclass(frozen=True)
class MultiCodeLMConfig(PhonemeLMConfig):
    codebooknum: int = 6
    src_attn_layers: int = 4

    @property
    def eos_id(self) -> int:
        return self.speech_token_size

    @property
    def bos_id(self) -> int:
        return self.speech_token_size + 1

    @property
    def max_id(self) -> int:
        return self.speech_token_size + 2      # ids a codebook: the codes, EOS, BOS


class ARDecoder(nn.Module):
    """hidden [B, T, D] -> logits [B, T, max_id, codebooknum]."""

    def __init__(self, dim: int, codebooknum: int, max_id: int):
        super().__init__()
        self.codebooknum, self.max_id = codebooknum, max_id
        self.model = Dense(dim, codebooknum * max_id)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        return self.model(x).reshape(B, T, self.max_id, self.codebooknum)


class Qwen2LMPhonemeMultiCode(_PhonemeLMBase):
    def __init__(self, cfg: MultiCodeLMConfig = MultiCodeLMConfig()):
        super().__init__(cfg)
        self.llm_decoder = None
        self.src_attention = nn.ModuleList(
            DecoderLayer(cfg.llm_input_size, cfg.fusion_heads, cfg.fusion_ffn)
            for _ in range(cfg.src_attn_layers))
        self.code_embeddings = nn.ModuleList(nn.Embedding(cfg.max_id, cfg.llm_input_size)
                                             for _ in range(cfg.codebooknum))
        self.ar_decoder = ARDecoder(cfg.llm_output_size, cfg.codebooknum, cfg.max_id)

    def fuse(self, text, text_len, pho_token, pho_len):
        """-> the phoneme rows [B, Tp, D] after the fusion layers."""
        pho = self.encode_pho(pho_token, pho_len)
        txt = self.body.embed_tokens(text).to(pho.dtype)
        txt_mask, pho_mask = self._masks(text_len, txt.shape[1], pho_len, pho.shape[1])
        for layer in self.src_attention:
            pho = layer(pho, pho_mask, txt, txt_mask)
        return pho

    def code_emb(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [..., N] -> the sum of the N codebooks' embeddings [..., D]."""
        e = self.code_embeddings[0](codes[..., 0])
        for i in range(1, len(self.code_embeddings)):
            e = e + self.code_embeddings[i](codes[..., i])
        return e

    def decode_logits(self, hidden):
        return self.ar_decoder(hidden)

    def forward(self, text, text_len, pho_token, pho_len, codes, codes_len, embedding,
                gen: Optional[torch.Generator] = None) -> dict:
        """Training loss: codes [B, T, N] aligned, codes_len [B] -> {"loss"},
        the focal loss over [sos, spk, fused(pho), task, delayed code rows];
        position p from the task slot on predicts delayed row p - task + 1,
        the row after the last an EOS row."""
        self._trainable()
        cfg = self.cfg
        fused = self.fuse(text, text_len, pho_token, pho_len)
        delayed = get_delay_pattern(codes, cfg.bos_id, cfg.eos_id)
        d_len = codes_len + cfg.codebooknum - 1
        B, Td, C = delayed.shape
        out, seq_len, pos = self._pack([(fused, pho_len)], embedding, Td)
        emb, total_len = self._finish_pack(out, pos, seq_len, self.code_emb(delayed), d_len)
        N = emb.shape[1]
        logits = self.ar_decoder(self._causal_hidden(emb, total_len))    # [B, N, V, C]
        first = (seq_len - 1)[:, None]
        idx = (pos - first).clamp(0, Td - 1)
        tgt = torch.gather(delayed, 1, idx[..., None].expand(B, N, C))
        tgt = torch.where((pos == first + d_len[:, None])[..., None],
                          torch.full_like(tgt, cfg.eos_id), tgt)
        valid = (pos >= first) & (pos <= first + d_len[:, None])
        return {"loss": focal_loss(logits.transpose(2, 3), tgt, gamma=1.0,
                                   mask=valid[..., None].expand(B, N, C))}

    def prefix_for_decode(self, text, text_len, pho_token, pho_len, prompt_codes,
                          prompt_codes_len, embedding):
        """prompt_codes [B, Tc, N] aligned (an inference prompt takes no delay)
        -> (emb [B, N_prefix, D], seq_len [B])."""
        fused = self.fuse(text, text_len, pho_token, pho_len)
        out, seq_len, pos = self._pack([(fused, pho_len)], embedding, prompt_codes.shape[1])
        return self._finish_pack(out, pos, seq_len, self.code_emb(prompt_codes),
                                 prompt_codes_len)


def _sample_codes(model: Qwen2LMPhonemeMultiCode, hidden_last, gen) -> torch.Tensor:
    """hidden [B, 1, D] -> codes [B, C]: greedy, or a nucleus draw a codebook."""
    cfg = model.cfg
    logits = model.decode_logits(hidden_last)[:, 0].float()          # [B, V, C]
    logp = torch.log_softmax(logits, dim=1).transpose(1, 2)          # [B, C, V]
    if cfg.sampling.method == "greedy":
        return logp.argmax(dim=-1)
    return samp.nucleus_sample(gen, logp, cfg.sampling.top_p, cfg.sampling.top_k)


@torch.no_grad()
def multicode_generate(model: Qwen2LMPhonemeMultiCode, text, text_len, pho_token, pho_len,
                       prompt_codes, prompt_codes_len, embedding, max_len,
                       gen: Optional[torch.Generator], max_steps: int, cache_len: int):
    """AR decode over all codebooks a step.  The prefill runs over the ragged
    prefix on the cache and the first codes come from each row's last prefix
    row; each decode step feeds the previous codes' summed embedding at rope
    position seq_len + step - 1, over the row's prefix and the decode slots
    written so far.  A row is done when all its codebooks emit EOS; a done
    row keeps its row of `out` and its previous embedding.  Stops when every
    row is done, at max_steps, or once step reaches min(max_len).
    -> (delayed codes [B, max_steps + 1, C] with a leading BOS row, steps
    taken (an int), done [B])."""
    cfg = model.cfg
    embeds, seq_len = model.prefix_for_decode(text, text_len, pho_token, pho_len, prompt_codes,
                                              prompt_codes_len, embedding)
    B, Tp, _ = embeds.shape
    dev = embeds.device
    cache = KVCache.create(cfg.qwen, B, cache_len, embeds.dtype, dev)
    bias = causal_prefill_bias(Tp, cache_len, seq_len, B, embeds.dtype, dev)
    positions = torch.arange(Tp, device=dev)[None].expand(B, Tp)
    hidden, cache = model.forward_hidden(embeds, positions, bias, cache)
    last = hidden[torch.arange(B, device=dev), seq_len - 1][:, None]
    out = torch.full((B, max_steps + 1, cfg.codebooknum), cfg.bos_id, dtype=torch.int32,
                     device=dev)
    toks = _sample_codes(model, last, gen)
    done = (toks == cfg.eos_id).all(dim=-1)
    out[:, 1] = torch.where(done[:, None], out[:, 1], toks.to(out.dtype))
    prev = model.code_emb(toks[:, None, :])
    limit = min(max_steps, int(torch.as_tensor(max_len).min()))
    slot = torch.arange(cache_len, device=dev)[None, :]
    prompt_ok = slot < seq_len[:, None]
    step = 1
    while step < limit and not bool(done.all()):
        valid = prompt_ok | ((slot >= Tp) & (slot <= cache.pos))
        step_bias = torch.where(valid, 0.0, NEG_INF).to(prev.dtype)[:, None, None, :]
        hidden, cache = model.forward_hidden(prev, (seq_len + step - 1)[:, None], step_bias,
                                             cache)
        toks = _sample_codes(model, hidden, gen)
        done = done | (toks == cfg.eos_id).all(dim=-1)
        out[:, step + 1] = torch.where(done[:, None], out[:, step + 1], toks.to(out.dtype))
        prev = torch.where(done[:, None, None], prev, model.code_emb(toks[:, None, :]))
        step += 1
    return out, step, done
