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

TransformerLMPhoneme's training loss is TransformerLM's `forward` over the
phoneme prefix, called (pho_token, pho_len, speech, speech_len,
embedding): the targets follow 2 + pho_len ignored positions.

TransformerLMPhonemeWithSpk is the LM beside the SpeakerEmbedding it is
co-trained with (`lm`, `speaker_embed`).  For inference `encode_speaker`
gives the speaker vector from fbank and linear-spectrum features, which
v1_phoneme_generate(model.lm, ...) decodes with.  Its training forward
embeds the speaker with gradients, takes the LM's loss on that vector and,
in train() mode inside a dropout_generator block, adds
ops/delay.vicreg_loss between it and a second pass over SpecAugment'ed
features (`spec_augment`) run under torch.no_grad() (the JAX module's
stop_gradient).  Every draw (the posterior samples, the masks) comes from
an explicit generator, or is pinned by the caller.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch

from cosyvoice_tpu_torch.models.llm import TransformerLM, TransformerLMConfig, lm_generate_v1
from cosyvoice_tpu_torch.models.llm_phoneme import PhonemeEmbedConfig, PhonemeEmbedding
from cosyvoice_tpu_torch.models.speaker import SpeakerEmbedding, SpeakerEmbeddingConfig
from cosyvoice_tpu_torch.nn.dropout import training_step
from cosyvoice_tpu_torch.ops.delay import vicreg_loss


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
    # training only (the VICReg loss)
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

    def forward(self, pho_token, pho_len, speech, speech_len, fbank, spec, spec_len,
                gen: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None,
                aug: Optional[dict] = None) -> dict:
        """Training loss: the LM's loss on the speaker vector of (fbank,
        spec, spec_len), plus (in a training step, use_vicreg) the VICReg
        term, also returned as "vicreg".  `noise` pins the clean pass's
        posterior sample; `aug` pins the augmented pass ({"fbank_masks",
        "spec_masks"}: spec_augment's masks, "noise": its sample); what is
        not pinned is drawn from `gen`."""
        cfg = self.cfg
        emb = self.speaker_embed.embed(fbank, spec, spec_len, noise=noise, gen=gen)
        out = self.lm(pho_token, pho_len, speech, speech_len, emb)
        if cfg.use_vicreg and self.training and training_step():
            aug = aug or {}
            fb_aug = spec_augment(fbank, gen, masks=aug.get("fbank_masks"))
            sp_aug = spec_augment(spec, gen, masks=aug.get("spec_masks"))
            with torch.no_grad():
                emb_aug = self.speaker_embed.embed(fb_aug, sp_aug, spec_len,
                                                   noise=aug.get("noise"), gen=gen)
            vr = vicreg_loss(emb, emb_aug, cfg.sim_coeff, cfg.std_coeff, cfg.cov_coeff)
            out = dict(out, loss=out["loss"] + vr, vicreg=vr)
        return out


def spec_augment_masks(B: int, T: int, F: int, gen: torch.Generator, freq_mask: int = 10,
                       time_mask_frac: float = 0.1, n_masks: int = 2) -> list:
    """spec_augment's draws: n_masks of (f0, fw, t0, tw), each [B] int64 on
    gen's device: a band of fw <= freq_mask bins from f0 < max(F - freq_mask,
    1) and a span of tw <= max(int(T * time_mask_frac), 1) frames from t0."""
    tmax = max(int(T * time_mask_frac), 1)

    def draw(high):
        return torch.randint(0, high, (B,), generator=gen, device=gen.device)

    return [(draw(max(F - freq_mask, 1)), draw(freq_mask + 1), draw(max(T - tmax, 1)),
             draw(tmax + 1)) for _ in range(n_masks)]


def spec_augment(x: torch.Tensor, gen: Optional[torch.Generator] = None,
                 freq_mask: int = 10, time_mask_frac: float = 0.1, n_masks: int = 2,
                 masks: Optional[list] = None) -> torch.Tensor:
    """Light SpecAugment for the speaker branch's augmented pass: zero
    n_masks frequency bands and time spans of x [B, T, F] each row, drawn
    from `gen` (spec_augment_masks) unless `masks` pins them."""
    B, T, F = x.shape
    if masks is None:
        masks = spec_augment_masks(B, T, F, gen, freq_mask, time_mask_frac, n_masks)
    fpos = torch.arange(F, device=x.device)[None, None, :]
    tpos = torch.arange(T, device=x.device)[None, :, None]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    for f0, fw, t0, tw in masks:
        f0, fw, t0, tw = (v.to(x.device).reshape(B, 1, 1) for v in (f0, fw, t0, tw))
        x = torch.where((fpos >= f0) & (fpos < f0 + fw), zero, x)
        x = torch.where((tpos >= t0) & (tpos < t0 + tw), zero, x)
    return x
