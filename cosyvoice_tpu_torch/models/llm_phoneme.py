"""Phoneme-conditioned Qwen2 speech LMs: the fork's production v2 LM
(Qwen2LMPhonemeSrc2, cosyvoice2_pho.yaml) and its two siblings.

Port of cosyvoice_tpu/models/llm_phoneme.py:
  * PhonemeEmbedding: 4-way factored phoneme ids (phoneme, tone, lang,
    prosody; 400 + 64 + 16 + 32 = 512 wide), the prosody column zeroed
    unless use_frontend_prsd;
  * the phoneme stream runs through a conformer text encoder and an affine
    to the LM width; the speaker vector is L2-normalised (1e-12 floor) and
    projected into its own slot;
  * Qwen2LMPhoneme feeds [sos, spk, text, pho, task, speech];
    Qwen2LMPhonemeSrc2 fuses text into the phoneme stream with one
    cross-attention DecoderLayer (query: phonemes) and feeds [sos, spk,
    fused(pho), task, speech]; Qwen2LMPhonemeSrc fuses the other way (query:
    text) and feeds [sos, spk, fused(text), task, speech];
  * decode is Qwen2LM's (models/llm.lm_generate_from_embeds): the phoneme
    LMs are Qwen2LMs with a phoneme prefix, so the engine serves them too,
    and a text-only request on one takes Qwen2LM's [sos, text, task,
    speech] prefix.
The fusion's LayerNorms use flax's numerics (nn/norm.py, fast variance)
and its attention zeroes the masked weights after the softmax, as the JAX
module does.

Training (`forward`): the same prefix over the utterance's speech tokens,
then Qwen2LM's causal + padding pass and the masked CE (lsm_weight,
length_normalized_loss) and accuracy of the speech targets, which follow
2 + the fed stream lengths ignored positions.  Qwen2LMPhoneme zeroes the
whole batch's text embeddings with probability text_emb_mask_prob, else
drops them at 0.2, in train() mode when `gen` is given (the JAX module
draws from its `rng`); the phoneme encoder's dropout acts inside
nn/dropout.dropout_generator, and the Qwen2 body's block_attention / remat
routes apply.  The phoneme LMs have no packed training forward.

Parameter names follow the reference checkpoint: `text_embedding.{0..3}`,
`text_encoder.*`, `text_encoder_affine_layer`, `llm.model.model.*`,
`llm_embedding`, `speech_embedding`, `llm_decoder`,
`spk_embed_affine_layer`, `src_attention.0.{norm1,norm2,norm3,self_attn.*,
src_attn.*,feed_forward.w_1,w_2}`; utils/checkpoint.load_by_name reads a
reference phoneme LM's state_dict by name.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.nn as nn

from cosyvoice_tpu_torch.models.conformer import (ConformerConfig, ConformerEncoder,
                                                  PositionwiseFeedForward)
from cosyvoice_tpu_torch.models.llm import (Qwen2LM, SamplingConfig,
                                            lm_generate_from_embeds)
from cosyvoice_tpu_torch.models.qwen2 import Qwen2Config
from cosyvoice_tpu_torch.nn.dense import Dense
from cosyvoice_tpu_torch.nn.norm import LayerNorm
from cosyvoice_tpu_torch.ops.masks import NEG_INF, make_non_pad_mask


@dataclass(frozen=True)
class PhonemeEmbedConfig:
    text_token_size: int = 140
    text_token_dim: int = 400
    text_tone_size: int = 16
    text_tone_dim: int = 64
    text_lang_size: int = 2
    text_lang_dim: int = 16
    text_prsd_size: int = 6
    text_prsd_dim: int = 32
    use_frontend_prsd: bool = True

    @property
    def tables(self) -> tuple:
        return ((self.text_token_size, self.text_token_dim),
                (self.text_tone_size, self.text_tone_dim),
                (self.text_lang_size, self.text_lang_dim),
                (self.text_prsd_size, self.text_prsd_dim))


class PhonemeEmbedding(nn.ModuleList):
    """pho_token [B, T, 4] (phoneme, tone, lang, prosody) -> [B, T, the four
    tables' widths summed]."""

    def __init__(self, cfg: PhonemeEmbedConfig):
        super().__init__(nn.Embedding(size, dim) for size, dim in cfg.tables)
        self.use_frontend_prsd = cfg.use_frontend_prsd

    def forward(self, pho_token: torch.Tensor) -> torch.Tensor:
        parts = [emb(pho_token[..., i]) for i, emb in enumerate(self)]
        if not self.use_frontend_prsd:
            parts[3] = parts[3] * 0.0
        return torch.cat(parts, dim=-1)


class MultiHeadedAttention(nn.Module):
    """wenet's plain multi-head attention, for the fusion layer: masked
    scores take NEG_INF, and the masked weights are zeroed after the softmax
    (a row with no valid key gives zeros)."""

    def __init__(self, heads: int, dim: int, key_bias: bool = True):
        super().__init__()
        self.heads, self.dim = heads, dim
        self.linear_q = Dense(dim, dim)
        self.linear_k = Dense(dim, dim, bias=key_bias)
        self.linear_v = Dense(dim, dim)
        self.linear_out = Dense(dim, dim)

    def forward(self, q_in, k_in, v_in, mask: Optional[torch.Tensor] = None):
        """q_in [B, Tq, dim], k_in / v_in [B, Tk, dim], mask [B, 1|Tq, Tk] bool."""
        H, D = self.heads, self.dim // self.heads
        B, Tq = q_in.shape[:2]
        Tk = k_in.shape[1]
        q = self.linear_q(q_in).reshape(B, Tq, H, D)
        k = self.linear_k(k_in).reshape(B, Tk, H, D)
        v = self.linear_v(v_in).reshape(B, Tk, H, D)
        scores = torch.einsum("bihd,bjhd->bhij", q, k) / math.sqrt(D)
        if mask is None:
            attn = torch.softmax(scores, dim=-1)
        else:
            m = mask[:, None]
            attn = torch.softmax(scores.masked_fill(~m, NEG_INF), dim=-1).masked_fill(~m, 0.0)
        out = torch.einsum("bhij,bjhd->bihd", attn, v).reshape(B, Tq, self.dim)
        return self.linear_out(out)


class DecoderLayer(nn.Module):
    """wenet's pre-norm DecoderLayer (the text/phoneme fusion, and the
    layer of models/decoder.py): self-attention, cross-attention onto
    `memory` (left out with src_attention=False), ReLU FFN, each residual."""

    def __init__(self, dim: int, heads: int, ffn_hidden: int, src_attention: bool = True,
                 key_bias: bool = True):
        super().__init__()
        self.norm1, self.norm3 = LayerNorm(dim, 1e-5), LayerNorm(dim, 1e-5)
        self.self_attn = MultiHeadedAttention(heads, dim, key_bias)
        if src_attention:
            self.norm2 = LayerNorm(dim, 1e-5)
            self.src_attn = MultiHeadedAttention(heads, dim, key_bias)
        self.src_attention = src_attention
        self.feed_forward = PositionwiseFeedForward(dim, ffn_hidden, activation="relu")

    def forward(self, tgt, tgt_mask, memory, memory_mask):
        """tgt [B, Tt, D] with its mask [B, 1|Tt, Tt]; memory [B, Tm, D]
        with its key mask [B, 1, Tm]."""
        h = self.norm1(tgt)
        tgt = tgt + self.self_attn(h, h, h, tgt_mask)
        if self.src_attention:
            h = self.norm2(tgt)
            tgt = tgt + self.src_attn(h, memory, memory, memory_mask)
        return tgt + self.feed_forward(self.norm3(tgt))


@dataclass(frozen=True)
class PhonemeLMConfig:
    """The production recipe (cosyvoice2_pho.yaml) by default: a Qwen2-0.5B
    body, a 6 x 1024 phoneme conformer, a 16-head fusion with a 4096 FFN."""

    llm_input_size: int = 896
    llm_output_size: int = 896
    speech_token_size: int = 6561
    spk_embed_dim: int = 512
    # training only (the loss and Qwen2LMPhoneme's text-embedding mask)
    length_normalized_loss: bool = True
    lsm_weight: float = 0.0
    text_emb_mask_prob: float = 0.5
    sampling: SamplingConfig = field(default_factory=lambda: SamplingConfig(
        method="non_random_ras", top_p=0.8, top_k=10, win_size=10, tau_r=0.1))
    phoneme: PhonemeEmbedConfig = field(default_factory=PhonemeEmbedConfig)
    encoder: ConformerConfig = field(default_factory=lambda: ConformerConfig(
        dim=1024, heads=16, linear_units=4096, num_blocks=6, input_size=512,
        attention_dropout_rate=0.0))
    qwen: Qwen2Config = field(default_factory=Qwen2Config)
    fusion_heads: int = 16
    fusion_ffn: int = 4096
    min_token_text_ratio: float = 2.0
    max_token_text_ratio: float = 20.0

    @property
    def sos_eos(self) -> int:
        return 0

    @property
    def task_id(self) -> int:
        return 1

    @property
    def eos_token(self) -> int:
        return self.speech_token_size


class _PhonemeLMBase(Qwen2LM):
    """Qwen2LM (body, speech embedding, head, decode contract) plus the
    phoneme encoder and the speaker slot."""

    def __init__(self, cfg: PhonemeLMConfig = PhonemeLMConfig()):
        super().__init__(cfg)
        self.text_embedding = PhonemeEmbedding(cfg.phoneme)
        self.text_encoder = ConformerEncoder(cfg.encoder)
        self.text_encoder_affine_layer = Dense(cfg.encoder.dim, cfg.llm_input_size)
        self.spk_embed_affine_layer = Dense(cfg.spk_embed_dim, cfg.llm_input_size)

    def encode_pho(self, pho_token, pho_len):
        """pho_token [B, Tp, 4], pho_len [B] -> [B, Tp, llm_input_size]."""
        h, _ = self.text_encoder(self.text_embedding(pho_token), pho_len)
        return self.text_encoder_affine_layer(h)

    def _spk(self, embedding):
        spk = embedding / embedding.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        return self.spk_embed_affine_layer(spk)[:, None, :]

    def _pack(self, streams, embedding, tail: int):
        """[sos, spk, streams..., task] packed per row (each stream (tensor
        [B, T_i, D], len [B]) right after the previous one's valid rows; pad
        rows are dropped), with `tail` more slots for the segment that
        _finish_pack grafts after the task slot -> (emb [B, N, D], seq_len
        [B] (through the task slot), pos [1, N])."""
        dtype = self.speech_embedding.weight.dtype
        B = streams[0][0].shape[0]
        dev = streams[0][0].device
        D = self.cfg.llm_input_size
        N = 2 + sum(s.shape[1] for s, _ in streams) + 1 + tail
        pos = torch.arange(N, device=dev)[None, :]
        out = torch.where(pos[..., None] == 0, self.llm_embedding.weight[self.cfg.sos_eos],
                          torch.zeros((), dtype=dtype, device=dev))
        out = torch.where((pos == 1)[..., None], self._spk(embedding).to(dtype), out)
        offset = torch.full((B,), 2, dtype=torch.long, device=dev)
        for s, sl in streams:
            idx = (pos - offset[:, None]).clamp(0, s.shape[1] - 1)
            g = torch.gather(s.to(dtype), 1, idx[..., None].expand(B, N, D))
            in_seg = (pos >= offset[:, None]) & (pos < (offset + sl)[:, None])
            out = torch.where(in_seg[..., None], g, out)
            offset = offset + sl
        out = torch.where((pos == offset[:, None])[..., None],
                          self.llm_embedding.weight[self.cfg.task_id], out)
        return out, offset + 1, pos

    @staticmethod
    def _finish_pack(out, pos, seq_len, seg, seg_len):
        """Graft seg [B, Ts, D] (seg_len [B] valid rows) into `out` right
        after each row's task slot -> (emb, seq_len + seg_len)."""
        B, N, D = out.shape
        Ts = seg.shape[1]
        if Ts > 0:
            idx = (pos - seq_len[:, None]).clamp(0, Ts - 1)
            g = torch.gather(seg.to(out.dtype), 1, idx[..., None].expand(B, N, D))
            in_seg = (pos >= seq_len[:, None]) & (pos < (seq_len + seg_len)[:, None])
            out = torch.where(in_seg[..., None], g, out)
        return out, seq_len + seg_len

    def build_prefix(self, streams, embedding, speech, speech_len):
        """[sos, spk, streams..., task, speech_emb] packed per row (_pack)
        -> (emb [B, N, D], seq_len [B])."""
        out, seq_len, pos = self._pack(streams, embedding, speech.shape[1])
        return self._finish_pack(out, pos, seq_len, self.speech_embedding(speech), speech_len)

    def _masks(self, text_len, Tt, pho_len, Tp):
        return (make_non_pad_mask(text_len, Tt)[:, None, :],
                make_non_pad_mask(pho_len, Tp)[:, None, :])

    def _train_streams(self, text, text_len, pho_token, pho_len, gen):
        """-> (the streams that build_prefix packs, the fed rows before the
        speech: 2 + their lengths)."""
        raise NotImplementedError

    def forward(self, text, text_len, pho_token, pho_len, speech, speech_len, embedding,
                gen: Optional[torch.Generator] = None) -> dict:
        """Training loss over [IGNORE x (2 + stream lengths), speech, EOS]:
        text [B, Tt], pho_token [B, Tp, 4], speech [B, Ts] (right-padded),
        embedding [B, spk_embed_dim] -> {"loss", "acc"}."""
        self._trainable()
        streams, n_ignore = self._train_streams(text, text_len, pho_token, pho_len, gen)
        emb, seq_len = self.build_prefix(streams, embedding, speech, speech_len)
        return self._ce_over_prefix(emb, seq_len, speech, n_ignore, speech_len, 0)

    def packed_call(self, *args, **kwargs):
        raise NotImplementedError("the phoneme LMs train unpacked (forward); the JAX package "
                                  "has no packed phoneme forward either")


class Qwen2LMPhoneme(_PhonemeLMBase):
    """Text and phoneme streams both fed, [sos, spk, text, pho, task, speech]."""

    def _train_streams(self, text, text_len, pho_token, pho_len, gen):
        pho = self.encode_pho(pho_token, pho_len)
        txt = self.body.embed_tokens(text)
        if self.training and gen is not None:
            zero = torch.rand((), generator=gen, device=gen.device) < self.cfg.text_emb_mask_prob
            keep = torch.rand(txt.shape, generator=gen, device=gen.device) < 0.8
            txt = torch.where(keep.to(txt.device), txt / 0.8, torch.zeros_like(txt))
            txt = torch.where(zero.to(txt.device), torch.zeros_like(txt), txt)
        return [(txt, text_len), (pho, pho_len)], 2 + text_len + pho_len

    def prefix_for_decode(self, text, text_len, pho_token, pho_len, prompt_speech,
                          prompt_speech_len, embedding):
        pho = self.encode_pho(pho_token, pho_len)
        txt = self.body.embed_tokens(text)
        return self.build_prefix([(txt, text_len), (pho, pho_len)], embedding,
                                 prompt_speech, prompt_speech_len)


class Qwen2LMPhonemeSrc2(_PhonemeLMBase):
    """Cross-attention fusion with the phoneme stream as the query (the
    production config): [sos, spk, fused(pho), task, speech]."""

    def __init__(self, cfg: PhonemeLMConfig = PhonemeLMConfig()):
        super().__init__(cfg)
        self.src_attention = nn.ModuleList([DecoderLayer(cfg.llm_input_size, cfg.fusion_heads,
                                                         cfg.fusion_ffn)])

    def _train_streams(self, text, text_len, pho_token, pho_len, gen):
        return [(self.fuse(text, text_len, pho_token, pho_len), pho_len)], 2 + pho_len

    def fuse(self, text, text_len, pho_token, pho_len):
        """-> the phoneme rows [B, Tp, D] after attending to the text."""
        pho = self.encode_pho(pho_token, pho_len)
        txt = self.body.embed_tokens(text)
        txt_mask, pho_mask = self._masks(text_len, txt.shape[1], pho_len, pho.shape[1])
        return self.src_attention[0](pho, pho_mask, txt.to(pho.dtype), txt_mask)

    def prefix_for_decode(self, text, text_len, pho_token, pho_len, prompt_speech,
                          prompt_speech_len, embedding):
        fused = self.fuse(text, text_len, pho_token, pho_len)
        return self.build_prefix([(fused, pho_len)], embedding, prompt_speech,
                                 prompt_speech_len)


class Qwen2LMPhonemeSrc(Qwen2LMPhonemeSrc2):
    """The fusion with the text stream as the query: [sos, spk, fused(text),
    task, speech]."""

    def _train_streams(self, text, text_len, pho_token, pho_len, gen):
        return [(self.fuse(text, text_len, pho_token, pho_len), text_len)], 2 + text_len

    def fuse(self, text, text_len, pho_token, pho_len):
        """-> the text rows [B, Tt, D] after attending to the phonemes."""
        pho = self.encode_pho(pho_token, pho_len)
        txt = self.body.embed_tokens(text).to(pho.dtype)
        txt_mask, pho_mask = self._masks(text_len, txt.shape[1], pho_len, pho.shape[1])
        return self.src_attention[0](txt, txt_mask, pho, pho_mask)

    def prefix_for_decode(self, text, text_len, pho_token, pho_len, prompt_speech,
                          prompt_speech_len, embedding):
        fused = self.fuse(text, text_len, pho_token, pho_len)
        return self.build_prefix([(fused, text_len)], embedding, prompt_speech,
                                 prompt_speech_len)


@torch.no_grad()
def phoneme_lm_generate(model: _PhonemeLMBase, text, text_len, pho_token, pho_len,
                        prompt_speech, prompt_speech_len, embedding, min_len, max_len,
                        gen: Optional[torch.Generator], max_steps: int, cache_len: int):
    """AR generation for any phoneme-LM variant: its prefix, then Qwen2LM's
    decode loop.  Returns (tokens [B, max_steps], count [B])."""
    embeds, seq_len = model.prefix_for_decode(text, text_len, pho_token, pho_len,
                                              prompt_speech, prompt_speech_len, embedding)
    return lm_generate_from_embeds(model, embeds, seq_len, min_len, max_len, gen, max_steps,
                                   cache_len)
