"""The v1 phoneme-conditioned TransformerLM (the cosyvoice_phoneme.yaml
family of recipes).

Port of cosyvoice_tpu/models/llm_v1_phoneme.py's TransformerLMPhoneme and
v1_phoneme_generate: the v1 TransformerLM (models/llm.py) with the 4-way
factored phoneme embedding of models/llm_phoneme.py in place of the text
table, its conformer text encoder optionally speaker-adaptive (`spk_adapt`:
the raw, un-normalised speaker vector enters every layer through its
`spk_linear`), and the prefix [sos, spk, pho_enc, task, speech] with
seq_len = 3 + pho_len + speech_len.  Decode is the v1 decode
(lm_prefill_stream_v1 / lm_decode_chunk_v1): EOS masked at the first step
only, no min_len, the fed-back id clamped to eos - 1 before the embedding
lookup.

TransformerLMPhonemeWithSpk is the LM beside the SpeakerEmbedding it was
co-trained with (`lm`, `speaker_embed`), for inference: `encode_speaker`
gives the speaker vector from fbank and linear-spectrum features, which
v1_phoneme_generate(model.lm, ...) decodes with.  Its training forward (the
VICReg regularizer between a clean and a SpecAugment'ed speaker pass), the
SpecAugment helper and the training losses are not ported: they come with
training.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch

from cosyvoice_tpu_torch.models.llm import TransformerLM, TransformerLMConfig, lm_generate_v1
from cosyvoice_tpu_torch.models.llm_phoneme import PhonemeEmbedConfig, PhonemeEmbedding
from cosyvoice_tpu_torch.models.speaker import SpeakerEmbedding, SpeakerEmbeddingConfig


@dataclass(frozen=True)
class V1PhonemeLMConfig(TransformerLMConfig):
    phoneme: PhonemeEmbedConfig = field(default_factory=PhonemeEmbedConfig)
    spk_adapt: bool = False     # the speaker-adaptive text encoder


class TransformerLMPhoneme(TransformerLM):
    def __init__(self, cfg: V1PhonemeLMConfig = V1PhonemeLMConfig()):
        super().__init__(cfg)

    def _text_front(self, cfg: V1PhonemeLMConfig):
        te = cfg.text_encoder
        if cfg.spk_adapt:
            te = dataclasses.replace(te, spk_adapt=True, spk_emb_size=cfg.spk_embed_dim)
        return PhonemeEmbedding(cfg.phoneme), te

    def encode_pho(self, pho_token, pho_len, embedding: Optional[torch.Tensor] = None):
        """pho_token [B, Tp, 4] -> [B, Tp, llm_input_size]; `embedding` (the
        raw speaker vector) reaches the spk_adapt layers."""
        h, _ = self.text_encoder(self.text_embedding(pho_token), pho_len,
                                 spk_emb=embedding if self.cfg.spk_adapt else None)
        return self.text_encoder_affine_layer(h)

    def prefill_embeds(self, pho_token, pho_len, prompt_speech, prompt_speech_len,
                       embedding: torch.Tensor):
        """[sos, spk, pho_enc, task, speech_emb] per row (right-padded)
        -> (embeds [B, N, D], seq_len [B])."""
        return self._pack_prefix(self.encode_pho(pho_token, pho_len, embedding), pho_len,
                                 prompt_speech, prompt_speech_len, embedding)


def v1_phoneme_generate(model: TransformerLMPhoneme, pho_token, pho_len, prompt_speech,
                        prompt_speech_len, embedding, max_len,
                        gen: Optional[torch.Generator], max_steps: int, cache_len: int):
    """v1 generation (B=1) over the phoneme prefix: lm_generate_v1's prefill
    and decode.  The JAX function's min_len argument is unused there and is
    not taken here.  Returns (tokens [1, max_steps], count [1])."""
    return lm_generate_v1(model, pho_token, pho_len, prompt_speech, prompt_speech_len,
                          embedding, max_len, gen, max_steps, cache_len)


@dataclass(frozen=True)
class WithSpkConfig:
    lm: V1PhonemeLMConfig = field(default_factory=V1PhonemeLMConfig)
    spk: SpeakerEmbeddingConfig = field(default_factory=SpeakerEmbeddingConfig)
    # training only (the VICReg loss); read by no port code
    sim_coeff: float = 0.5
    std_coeff: float = 0.4
    cov_coeff: float = 0.1
    use_vicreg: bool = True


class TransformerLMPhonemeWithSpk(torch.nn.Module):
    def __init__(self, cfg: WithSpkConfig = WithSpkConfig()):
        super().__init__()
        self.cfg = cfg
        self.lm = TransformerLMPhoneme(cfg.lm)
        self.speaker_embed = SpeakerEmbedding(cfg.spk)

    def encode_speaker(self, fbank, spec, spec_len, noise: Optional[torch.Tensor] = None,
                       gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """(fbank [B, Tf, 80], spec [B, Ts, 513], spec_len [B]) -> the speaker
        vector [B, spk.speaker_emb_dim] (SpeakerEmbedding.forward)."""
        return self.speaker_embed(fbank, spec, spec_len, noise=noise, gen=gen)
