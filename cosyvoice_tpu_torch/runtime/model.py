"""Inference pipelines: LM -> flow -> vocoder, one-shot or streaming, for
CosyVoice2 (CosyVoice2Model) and CosyVoice v1 (CosyVoiceV1Model).

Port of cosyvoice_tpu/runtime/model.py::CosyVoice2Model and ::CosyVoiceV1Model.
- `tts(stream=False)`: one LM decode over the whole text, one flow call over
  prompt ++ generated tokens (padded to a multiple of the 50-token hop), one
  HiFT call over the generated mel (padded to a multiple of 32 frames).
- `tts(stream=True)`: the decode runs in hop-sized chunks
  (`lm_prefill_stream` / `lm_decode_chunk`).  Whenever hop + lookahead (3)
  tokens past the emitted offset exist, the flow re-runs over prompt ++ the
  tokens so far with `streaming` (chunk-masked in the stream family), and the
  chunk's mel from `token_offset * ratio` on is vocoded with the session's
  caches: the last 8 mel frames of the previous chunk are prepended, the
  HiFT source of those frames is spliced in, the head of the new wav is
  cross-faded over a Hamming window with the previous chunk's held-back
  tail, and the last 8 * 480 samples are held back for the next chunk.  The
  final chunk vocodes the rest.  `mel2wav_group`, `mel2wav_stream_group` and
  `mel2wav_final_group` vocode a flush group of the continuous server
  (runtime/serving.py) in batched HiFT calls, one a padded length, each row
  with its own session's caches and noise generator, so every output equals
  the session's own `mel2wav`.  With `flow_context_tokens` a chunk's flow
  context is the prompt plus a window of the latest generated tokens
  (`flow_window_drop`), the pinned noise re-indexed to match
  (`windowed_noise`).
The decode length comes from the smallest static bucket covering the
reference's 20x-text bound, clamped at `max_decode_tokens`, and a decode
that hits that ceiling logs a truncation warning.  `runtime/serving.py`
batches the non-streaming stages.  Where the JAX package folds a counter
into a PRNG key for each vocoder call, a session here draws its HiFT source
noise from one torch.Generator seeded 0, so a request's waveform does not
depend on what was synthesized before it.

CosyVoiceV1Model (22.05 kHz, 256-sample hop): the one-shot `tts` decodes,
then runs the flow over prompt ++ tokens and HiFT over the mel.  The
streamed `tts` decodes in hop-sized chunks (hop 2 * fr tokens) interleaved
with synthesis: whenever hop + 20 overlap tokens past the consumed offset
exist, the flow runs over the prompt and just that window, with the
session's flow cache pinning the prompt's and the last 34 frames' noise and
mu; the window's last 20 tokens' mel (mel_overlap_len frames) is held back
and Hamming-faded into the next chunk's head; HiFT keeps 20 mel frames, their
source and the held-back tail of the wav, as CosyVoice2Model does.  Each
session draws its CFM noise and its HiFT source noise from one
torch.Generator seeded 0 (the JAX package folds a session counter into a
fixed key).
"""
from __future__ import annotations

import logging
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F

from cosyvoice_tpu_torch.device import resolve_device
from cosyvoice_tpu_torch.models.flow import (CausalMaskedDiffWithXvec, MaskedDiffWithXvec,
                                             reference_rand_noise)
from cosyvoice_tpu_torch.models.hift import HiFTGenerator
from cosyvoice_tpu_torch.models.llm import (Qwen2LM, TransformerLM, lm_decode_chunk,
                                            lm_decode_chunk_v1, lm_prefill_stream,
                                            lm_prefill_stream_v1)


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _derive_decode_buckets(cap: int) -> tuple:
    """Static decode-length buckets (200, 400, ..., cap)."""
    b, bs = 200, []
    while b < cap:
        bs.append(b)
        b *= 2
    return tuple(bs) + (cap,)


def _pick_bucket(buckets: tuple, cap: int, allowed: int) -> int:
    for b in buckets:
        if allowed <= b:
            return b
    return cap


def _warn_if_capped(count: int, allowed: int, cap: int, fr: int) -> None:
    if count >= cap and allowed > cap:
        logging.warning("LM decode TRUNCATED at the static cap: emitted %d tokens "
                        "(~%.1f s audio) but the 20x-text bound allows %d; raise "
                        "max_decode_tokens", count, count / fr, allowed)


def _interp_linear(mel: np.ndarray, new_len: int) -> np.ndarray:
    """torch F.interpolate(mode='linear', align_corners=False) on [T, C]."""
    T = mel.shape[0]
    pos = (np.arange(new_len) + 0.5) * T / new_len - 0.5
    lo = np.clip(np.floor(pos).astype(int), 0, T - 1)
    hi = np.clip(lo + 1, 0, T - 1)
    w = np.clip(pos - lo, 0.0, 1.0)[:, None]
    return mel[lo] * (1 - w) + mel[hi] * w


@dataclass
class CosyVoice2Model:
    """Drives the three stages on `device` (default: the GPU)."""

    llm: Qwen2LM
    flow: CausalMaskedDiffWithXvec
    hift: HiFTGenerator
    # hard cap on generated speech tokens per segment (KV-cache ceiling)
    max_decode_tokens: int = 800
    decode_buckets: Optional[tuple] = None
    # pinned CFM noise [1, N, 80]; None uses the CFM's own seed-0 buffer
    flow_noise: Optional[torch.Tensor] = None
    device: Optional[str] = None
    # streaming flow context, in generated tokens: None re-runs every chunk's
    # flow over the whole prefix (the reference's semantics, quadratic in the
    # stream's length); W keeps the prompt plus the last <= W + hop generated
    # tokens (W >= hop + lookahead)
    flow_context_tokens: Optional[int] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        for m in (self.llm, self.flow, self.hift):
            m.to(self.device).eval()
        if self.decode_buckets is None:
            self.decode_buckets = _derive_decode_buckets(self.max_decode_tokens)
        self.token_hop_len = 2 * self.flow.cfg.input_frame_rate      # 50
        self.pre_lookahead_len = self.flow.cfg.pre_lookahead_len     # 3
        self.ratio = self.flow.cfg.token_mel_ratio                   # 2
        self.hop_samples = self.hift.cfg.upsample_scale              # 480 at 24 kHz
        if self.flow_context_tokens is not None:
            need = self.token_hop_len + self.pre_lookahead_len
            if self.flow_context_tokens < need:
                raise ValueError(f"flow_context_tokens must cover one chunk and its "
                                 f"lookahead (>= {need}), got {self.flow_context_tokens}")
            if self.flow_noise is None:
                # a window re-indexes the noise, which needs the buffer itself:
                # the one the CFM slices when it is given none
                self.flow_noise = reference_rand_noise(self.flow.cfg.cfm.noise_frames,
                                                       self.flow.cfg.output_size)
        self.mel_cache_len = 8
        self.source_cache_len = self.mel_cache_len * self.hop_samples
        self.speech_window = np.hamming(2 * self.source_cache_len)

    def decode_cap(self, new_text_len: int) -> int:
        allowed = int(new_text_len * self.llm.cfg.max_token_text_ratio)
        return _pick_bucket(self.decode_buckets, self.max_decode_tokens, allowed)

    def _tensor(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _prefill(self, text_tokens, prompt_text_len: int, prompt_speech_tokens,
                 gen: Optional[torch.Generator]):
        """The decode's prefill and first sample -> (StreamState, allowed, cap)."""
        text = self._tensor(text_tokens, torch.long)[None]
        psp = self._tensor(prompt_speech_tokens, torch.long)[None]
        new_text = text.shape[1] - prompt_text_len
        allowed = int(new_text * self.llm.cfg.max_token_text_ratio)
        cap = self.decode_cap(new_text)
        state = lm_prefill_stream(
            self.llm, text, self._tensor([text.shape[1]], torch.long), psp,
            self._tensor([psp.shape[1]], torch.long),
            self._tensor([int(new_text * self.llm.cfg.min_token_text_ratio)], torch.long),
            self._tensor([min(allowed, cap)], torch.long), gen, max_steps=cap,
            cache_len=round_up(2 + text.shape[1] + psp.shape[1] + cap, 128))
        return state, allowed, cap

    def llm_generate(self, text_tokens: np.ndarray, prompt_text_len: int,
                     prompt_speech_tokens: np.ndarray,
                     gen: Optional[torch.Generator]) -> np.ndarray:
        """The full AR decode; returns the emitted token ids."""
        state, allowed, cap = self._prefill(text_tokens, prompt_text_len,
                                            prompt_speech_tokens, gen)
        decoded = lm_decode_chunk(self.llm, state, cap).gen
        n = int(decoded.count[0])
        self._warn_if_capped(n, allowed, cap)
        return decoded.out[0, :n].cpu().numpy()

    def _warn_if_capped(self, count: int, allowed: int, cap: int) -> None:
        _warn_if_capped(count, allowed, cap, self.flow.cfg.input_frame_rate)

    def pinned_noise(self, frames: int) -> Optional[torch.Tensor]:
        """The first `frames` frames of the pinned CFM noise [1, N, 80] (None
        without one: the CFM then slices its own seed-0 buffer)."""
        return None if self.flow_noise is None else self.windowed_noise(0, 0, frames)

    def flow_window_drop(self, n_gen: int, token_offset: int) -> int:
        """Generated tokens to drop from the front of a streaming chunk's flow
        context: 0 without flow_context_tokens or at offset 0; else rounded
        up to a hop multiple (the kept window lies in (W - hop, W], so the
        call's bucket does not move with the exact token count) and at most
        the offset rounded down to one (the emitted region stays inside)."""
        W = self.flow_context_tokens
        if W is None or token_offset == 0 or n_gen <= W:
            return 0
        hop = self.token_hop_len
        drop = -((-(n_gen - W)) // hop) * hop
        return min(drop, (token_offset // hop) * hop)

    def windowed_noise(self, pfl: int, drop: int, need: int) -> torch.Tensor:
        """Noise rows [1, need, 80] for a windowed flow call: the prompt's
        rows [0, pfl), then for generated row i of the window buffer row
        pfl + drop * ratio + i, the row the whole-prefix call gives that
        token.  With drop 0 this is the plain [:need] slice."""
        buf = torch.as_tensor(self.flow_noise)
        d = drop * self.ratio
        if buf.shape[1] < d + need:
            raise ValueError(f"flow_noise buffer ({buf.shape[1]} frames) too short for "
                             f"window offset {d} + {need} mel frames")
        if d == 0:
            return buf[:, :need]
        return torch.cat([buf[:, :pfl], buf[:, pfl + d: d + need]], dim=1)

    def _flow_chunk(self, all_tokens, prompt_tokens, prompt_feat, embedding,
                    token_offset: int, streaming: bool,
                    n_tokens: Optional[int] = None) -> torch.Tensor:
        """Flow over prompt ++ the first n_tokens generated tokens (less the
        window's drop; padded to a hop multiple) -> the generated mel
        [frames, 80] from token_offset on.  all_tokens may be a host array
        or the LM's device buffer."""
        n_gen = len(all_tokens) if n_tokens is None else n_tokens
        drop = self.flow_window_drop(n_gen, token_offset)
        prompt = self._tensor(prompt_tokens, torch.long)
        gen_tok = torch.as_tensor(all_tokens, device=self.device)[drop:n_gen].long()
        n = len(prompt) + n_gen - drop
        bucket = max(round_up(n, self.token_hop_len), self.token_hop_len)
        tok = F.pad(torch.cat([prompt, gen_tok]), (0, bucket - n))
        noise = None
        if self.flow_noise is not None:
            noise = self.windowed_noise(np.asarray(prompt_feat).shape[0], drop,
                                        self.ratio * bucket)
        mel = self.flow.inference(tok[None], self._tensor([n], torch.long),
                                  self._tensor(prompt_feat, torch.float32)[None],
                                  self._tensor(embedding, torch.float32)[None],
                                  noise=noise, streaming=streaming)
        return mel[0, (token_offset - drop) * self.ratio: self.ratio * (n - len(prompt))]

    def _vocode(self, mel: torch.Tensor, cache_source: Optional[torch.Tensor],
                gen: torch.Generator, pad_to: int):
        """HiFT over mel [frames, 80] zero-padded to pad_to frames, with the
        cached source [Lc] spliced over the head of the new one -> (wav,
        source) of the unpadded frames; no frames (a decode that emitted no
        token) give no samples."""
        n = mel.shape[0]
        if n == 0:
            empty = mel.new_zeros(0, dtype=torch.float32)
            return empty, empty
        mel_pad = F.pad(mel.float(), (0, 0, 0, pad_to - n))
        cs = None if cache_source is None else cache_source[None, :, None]
        wav, source = self.hift.inference(mel_pad[None], cache_source=cs, gen=gen)
        return wav[0, :n * self.hop_samples], source[0, :n * self.hop_samples, 0]

    @staticmethod
    def new_session() -> dict:
        """A request's vocoder state: the fade caches and its noise generator."""
        return {"hift": None, "gen": torch.Generator().manual_seed(0)}

    def token2wav(self, tokens, prompt_tokens, prompt_feat, embedding, token_offset: int = 0,
                  session: Optional[dict] = None, finalize: bool = True, speed: float = 1.0,
                  n_tokens: Optional[int] = None) -> np.ndarray:
        """Flow (streaming unless finalize) then vocoder, for one chunk of a
        session (by default a fresh one: the whole request at once)."""
        mel = self._flow_chunk(tokens, prompt_tokens, prompt_feat, embedding, token_offset,
                               streaming=not finalize, n_tokens=n_tokens)
        return self.mel2wav(mel, self.new_session() if session is None else session,
                            finalize, speed)

    def mel2wav(self, mel: torch.Tensor, session: dict, finalize: bool,
                speed: float = 1.0) -> np.ndarray:
        """Vocode one chunk's generated mel with the session's caches."""
        cache = session["hift"]
        cache_source = None
        if cache is not None:
            mel = torch.cat([cache["mel"], mel.float()])
            cache_source = cache["source"]
        if not finalize:
            wav, source = self._vocode(mel, cache_source, session["gen"],
                                       self._stream_pad(mel.shape[0]))
            wav = wav.cpu().numpy()
            if cache is not None:
                wav = self._fade(wav, cache["speech"])
            n = self.source_cache_len
            session["hift"] = {"mel": mel[-self.mel_cache_len:], "source": source[-n:],
                               "speech": wav[-n:]}
            return wav[:-n]
        if speed != 1.0:
            if cache is not None:
                raise ValueError("a speed change needs non-streaming synthesis")
            mel = self._tensor(_interp_linear(mel.cpu().numpy(), int(mel.shape[0] / speed)),
                               torch.float32)
        wav, _ = self._vocode(mel, cache_source, session["gen"], round_up(mel.shape[0], 32))
        wav = wav.cpu().numpy()
        return wav if cache is None else self._fade(wav, cache["speech"])

    def _stream_pad(self, frames: int) -> int:
        """The padded length of a non-final chunk: every steady-state chunk
        vocodes one static shape, and a longer (progressive-hop) one its own."""
        return max(self.mel_cache_len + (self.token_hop_len + self.pre_lookahead_len)
                   * self.ratio, frames)

    def mel2wav_group(self, gens: list, sessions: list, finals: list) -> list:
        """`mel2wav` for a flush group: rows of one padded length and cache
        state share one batched HiFT call; each row draws its source noise
        from its own session's generator (a list of generators, one a row)
        and keeps its own fade caches, so every output equals the session's
        own `mel2wav` on the same mel.  gens[i] [frames, 80] is job i's
        generated mel; a session's later jobs in the list run after its
        earlier ones (they need the caches those leave)."""
        order = defaultdict(int)
        waves: dict = defaultdict(list)
        for i, session in enumerate(sessions):
            waves[order[id(session)]].append(i)
            order[id(session)] += 1
        if len(waves) > 1:
            out: list = [None] * len(gens)
            for idxs in waves.values():
                for i, w in zip(idxs, self.mel2wav_group([gens[i] for i in idxs],
                                                         [sessions[i] for i in idxs],
                                                         [finals[i] for i in idxs])):
                    out[i] = w
            return out
        prep = []
        for mel, session, fin in zip(gens, sessions, finals):
            cache = session["hift"]
            mel = mel.float() if cache is None else torch.cat([cache["mel"], mel.float()])
            prep.append((mel, cache, round_up(mel.shape[0], 32) if fin
                         else self._stream_pad(mel.shape[0])))
        groups: dict = defaultdict(list)
        for i, (_, cache, pad_to) in enumerate(prep):
            groups[(pad_to, cache is not None)].append(i)
        results: list = [None] * len(gens)
        n_cache = self.source_cache_len
        for (pad_to, cached), idxs in groups.items():
            if pad_to == 0:     # fresh sessions' final chunks of no frames
                for i in idxs:
                    results[i] = np.zeros(0, np.float32)
                continue
            mels = torch.stack([F.pad(prep[i][0], (0, 0, 0, pad_to - prep[i][0].shape[0]))
                                for i in idxs])
            cs = (torch.stack([prep[i][1]["source"] for i in idxs])[:, :, None] if cached
                  else None)
            wav, source = self.hift.inference(mels, cache_source=cs,
                                              gen=[sessions[i]["gen"] for i in idxs])
            wav_h = wav.cpu().numpy()
            for row, i in enumerate(idxs):
                mel, cache, _ = prep[i]
                n = mel.shape[0] * self.hop_samples
                w = wav_h[row, :n]
                if cached:
                    w = self._fade(w, cache["speech"])
                if not finals[i]:
                    sessions[i]["hift"] = {"mel": mel[-self.mel_cache_len:],
                                           "source": source[row, :n, 0][-n_cache:],
                                           "speech": w[-n_cache:]}
                    w = w[:-n_cache]
                results[i] = w
        return results

    @staticmethod
    def _windows(mel: torch.Tensor, rows, starts, lengths) -> list:
        """mel[rows[i], starts[i]:starts[i] + lengths[i]] for each job, cut at
        the mel's end as the sequential path's slice is (a prompt mel longer
        than 2 rows a prompt token, which only the 24 kHz frontend trims,
        moves the generated region past the flow's rows)."""
        return [mel[r, s:s + n] for r, s, n in zip(rows, starts, lengths)]

    def mel2wav_stream_group(self, mel: torch.Tensor, rows, starts, sessions: list,
                             win_rows: Optional[int] = None) -> list:
        """Steady-state streaming vocode: every job is a non-final chunk, the
        `win_rows` mel rows (default one hop plus its lookahead) of the flow
        output mel [B, T, 80] at row rows[i] from starts[i]."""
        if win_rows is None:
            win_rows = (self.token_hop_len + self.pre_lookahead_len) * self.ratio
        return self.mel2wav_group(self._windows(mel, rows, starts, [win_rows] * len(rows)),
                                  sessions, [False] * len(sessions))

    def mel2wav_final_group(self, mel: torch.Tensor, rows, starts, valids,
                            sessions: list) -> list:
        """Final-chunk vocode of a flush group: job i's generated mel is
        valids[i] rows of mel [B, T, 80] at row rows[i] from starts[i]."""
        return self.mel2wav_group(self._windows(mel, rows, starts, valids), sessions,
                                  [True] * len(sessions))

    def _fade(self, wav: np.ndarray, prev_tail: np.ndarray) -> np.ndarray:
        """Hamming cross-fade of the chunk's head with the held-back tail."""
        n, w = self.source_cache_len, self.speech_window
        wav = wav.copy()
        wav[:n] = wav[:n] * w[:n] + prev_tail[-n:] * w[n:]
        return wav

    def tts(self, text_tokens: np.ndarray, prompt_text_len: int,
            llm_prompt_speech_token: np.ndarray, flow_prompt_speech_token: np.ndarray,
            prompt_speech_feat: np.ndarray, flow_embedding: np.ndarray,
            stream: bool = False, speed: float = 1.0,
            gen: Optional[torch.Generator] = None) -> Iterator[dict]:
        """Yield {'tts_speech': np.ndarray [S]}: one chunk, or the stream's
        chunks (hop 50 tokens, lookahead 3, fade caches of 8 mel frames)."""
        if gen is None:
            gen = torch.Generator().manual_seed(time.time_ns() % (1 << 31))
        session = self.new_session()
        fpt = np.asarray(flow_prompt_speech_token, np.int64)
        prompt_feat = np.asarray(prompt_speech_feat, np.float32)
        emb = np.asarray(flow_embedding, np.float32)
        if not stream:
            tokens = self.llm_generate(text_tokens, prompt_text_len,
                                       llm_prompt_speech_token, gen)
            yield {"tts_speech": self.token2wav(tokens, fpt, prompt_feat, emb, 0, session,
                                                finalize=True, speed=speed)}
            return
        state, allowed, cap = self._prefill(text_tokens, prompt_text_len,
                                            llm_prompt_speech_token, gen)
        hop, la = self.token_hop_len, self.pre_lookahead_len
        token_offset = 0
        while True:
            lm_decode_chunk(self.llm, state, hop)
            count, done = int(state.gen.count[0]), bool(state.gen.done[0])
            while count - token_offset >= hop + la:
                wav = self.token2wav(state.gen.out[0], fpt, prompt_feat, emb, token_offset,
                                     session, finalize=False, n_tokens=token_offset + hop + la)
                token_offset += hop
                yield {"tts_speech": wav}
            if done or state.gen.step >= cap:
                break
        self._warn_if_capped(count, allowed, cap)
        yield {"tts_speech": self.token2wav(state.gen.out[0], fpt, prompt_feat, emb,
                                            token_offset, session, finalize=True,
                                            n_tokens=count)}


@dataclass
class CosyVoiceV1Model:
    """The CosyVoice v1 stages on `device` (default: the GPU)."""

    llm: TransformerLM
    flow: MaskedDiffWithXvec
    hift: HiFTGenerator
    sample_rate: int = 22050
    # hard cap on generated speech tokens per segment (KV-cache ceiling)
    max_decode_tokens: int = 800
    decode_buckets: Optional[tuple] = None
    device: Optional[str] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        for m in (self.llm, self.flow, self.hift):
            m.to(self.device).eval()
        if self.decode_buckets is None:
            self.decode_buckets = _derive_decode_buckets(self.max_decode_tokens)
        self.fr = fr = self.flow.cfg.input_frame_rate                # 25
        self.token_min_hop_len = 2 * fr
        self.token_max_hop_len = 4 * fr
        self.token_overlap_len = 20
        self.mel_overlap_len = int(self.token_overlap_len / fr * self.sample_rate / 256)
        self.mel_window = np.hamming(2 * self.mel_overlap_len)
        self.mel_cache_len = 20
        self.hop_samples = self.hift.cfg.upsample_scale              # 256 at 22.05 kHz
        self.source_cache_len = self.mel_cache_len * self.hop_samples
        self.speech_window = np.hamming(2 * self.source_cache_len)
        self.stream_scale_factor = 1

    def decode_cap(self, new_text_len: int) -> int:
        allowed = int(new_text_len * self.llm.cfg.max_token_text_ratio)
        return _pick_bucket(self.decode_buckets, self.max_decode_tokens, allowed)

    def _tensor(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _prefill(self, text_tokens, prompt_text_len: int, prompt_speech_tokens, embedding,
                 gen: Optional[torch.Generator]):
        """The decode's prefill and first sample -> (StreamStateV1, allowed, cap);
        an absent or empty speaker vector leaves the LM's speaker slot out."""
        text = self._tensor(text_tokens, torch.long)[None]
        psp = self._tensor(prompt_speech_tokens, torch.long)[None]
        new_text = text.shape[1] - prompt_text_len
        allowed = int(new_text * self.llm.cfg.max_token_text_ratio)
        cap = self.decode_cap(new_text)
        has_spk = embedding is not None and np.asarray(embedding).size > 0
        state = lm_prefill_stream_v1(
            self.llm, text, self._tensor([text.shape[1]], torch.long), psp,
            self._tensor([psp.shape[1]], torch.long),
            self._tensor(embedding, torch.float32)[None] if has_spk else None,
            self._tensor([min(allowed, cap)], torch.long), gen, max_steps=cap,
            cache_len=round_up(3 + text.shape[1] + psp.shape[1] + cap, 128))
        return state, allowed, cap

    def llm_generate(self, text_tokens, prompt_text_len: int, prompt_speech_tokens,
                     embedding, gen: Optional[torch.Generator]) -> np.ndarray:
        """The full AR decode; returns the emitted token ids."""
        state, allowed, cap = self._prefill(text_tokens, prompt_text_len,
                                            prompt_speech_tokens, embedding, gen)
        decoded = lm_decode_chunk_v1(self.llm, state, cap).gen
        n = int(decoded.count[0])
        _warn_if_capped(n, allowed, cap, self.fr)
        return decoded.out[0, :n].cpu().numpy()

    @staticmethod
    def new_session() -> dict:
        """A request's synthesis state: the flow cache, the held-back mel
        overlap, the HiFT caches and the noise generator."""
        return {"hift": None, "mel_overlap": None, "flow_cache": None,
                "gen": torch.Generator().manual_seed(0)}

    def flow_noise(self, session: dict, frames: int) -> torch.Tensor:
        """The CFM's fresh noise [1, frames, 80] for one flow call, drawn
        from the session's generator (on the CPU: the same numbers on any
        device)."""
        return torch.randn((1, frames, self.flow.cfg.output_size), generator=session["gen"])

    def token2wav(self, tokens, prompt_tokens, prompt_feat, embedding,
                  session: Optional[dict] = None, finalize: bool = True,
                  speed: float = 1.0) -> np.ndarray:
        """Flow over prompt ++ tokens (with the session's flow cache), then
        the vocoder, for one chunk of a session (by default a fresh one: the
        whole request at once)."""
        session = self.new_session() if session is None else session
        tokens = np.asarray(tokens)
        tok = self._tensor(np.concatenate([np.asarray(prompt_tokens), tokens]), torch.long)
        prompt_feat = self._tensor(prompt_feat, torch.float32)
        mel_len2 = int(len(tokens) / self.fr * self.sample_rate / 256)
        mel, session["flow_cache"] = self.flow.inference(
            tok[None], self._tensor([len(tok)], torch.long), prompt_feat[None],
            self._tensor(embedding, torch.float32)[None],
            self.flow_noise(session, prompt_feat.shape[0] + mel_len2),
            prompt_token_len=len(prompt_tokens), mel_len2=mel_len2,
            flow_cache=session["flow_cache"], sample_rate=self.sample_rate)
        mel = mel[0]
        if session["mel_overlap"] is not None:
            mel = self._fade_mel(mel, session["mel_overlap"])
        cache = session["hift"]
        cache_source = None
        if cache is not None:
            mel = torch.cat([cache["mel"], mel])
            cache_source = cache["source"]
        if not finalize:
            session["mel_overlap"] = mel[-self.mel_overlap_len:]
            mel = mel[:-self.mel_overlap_len]
            wav, source = self._vocode(mel, cache_source, session["gen"])
            if cache is not None:
                wav = self._fade_speech(wav, cache["speech"])
            n = self.source_cache_len
            session["hift"] = {"mel": mel[-self.mel_cache_len:], "source": source[-n:],
                               "speech": wav[-n:]}
            return wav[:-n]
        if speed != 1.0:
            if cache is not None:
                raise ValueError("a speed change needs non-streaming synthesis")
            mel = self._tensor(_interp_linear(mel.cpu().numpy(), int(mel.shape[0] / speed)),
                               torch.float32)
        wav, _ = self._vocode(mel, cache_source, session["gen"])
        return wav if cache is None else self._fade_speech(wav, cache["speech"])

    def _vocode(self, mel: torch.Tensor, cache_source: Optional[torch.Tensor],
                gen: torch.Generator):
        """HiFT over mel [frames, 80], the cached source [Lc] spliced over the
        head of the new one -> (wav on the host, source on the device) of
        frames * hop_samples samples; no frames give no samples."""
        n = mel.shape[0] * self.hop_samples
        if n == 0:
            return np.zeros(0, np.float32), mel.new_zeros(0, dtype=torch.float32)
        cs = None if cache_source is None else cache_source[None, :, None]
        wav, source = self.hift.inference(mel.float()[None], cache_source=cs, gen=gen)
        return wav[0, :n].cpu().numpy(), source[0, :n, 0]

    def _fade_mel(self, mel: torch.Tensor, prev_tail: torch.Tensor) -> torch.Tensor:
        """Hamming cross-fade of the chunk's first mel frames with the
        previous chunk's held-back overlap."""
        n = prev_tail.shape[0]
        w = torch.as_tensor(self.mel_window, dtype=mel.dtype, device=mel.device)
        return torch.cat([mel[:n] * w[:n, None] + prev_tail * w[n:, None], mel[n:]])

    def _fade_speech(self, wav: np.ndarray, prev_tail: np.ndarray) -> np.ndarray:
        """Hamming cross-fade of the chunk's head with the held-back tail."""
        n, w = self.source_cache_len, self.speech_window
        wav = wav.copy()
        wav[:n] = wav[:n] * w[:n] + prev_tail[-n:] * w[n:]
        return wav

    def tts(self, text_tokens: np.ndarray, prompt_text_len: int,
            llm_prompt_speech_token: np.ndarray, flow_prompt_speech_token: np.ndarray,
            prompt_speech_feat: np.ndarray, flow_embedding: np.ndarray,
            llm_embedding: Optional[np.ndarray] = None, stream: bool = False,
            speed: float = 1.0, gen: Optional[torch.Generator] = None) -> Iterator[dict]:
        """Yield {'tts_speech': np.ndarray [S]}: one chunk, or the stream's
        chunks (decode chunks of hop tokens interleaved with synthesis)."""
        if gen is None:
            gen = torch.Generator().manual_seed(time.time_ns() % (1 << 31))
        session = self.new_session()
        fpt = np.asarray(flow_prompt_speech_token, np.int64)
        feat = np.asarray(prompt_speech_feat, np.float32)
        emb = np.asarray(flow_embedding, np.float32)
        if not stream:
            tokens = self.llm_generate(text_tokens, prompt_text_len, llm_prompt_speech_token,
                                       llm_embedding, gen)
            yield {"tts_speech": self.token2wav(tokens, fpt, feat, emb, session,
                                                finalize=True, speed=speed)}
            return
        state, allowed, cap = self._prefill(text_tokens, prompt_text_len,
                                            llm_prompt_speech_token, llm_embedding, gen)
        consumed, hop, lap = 0, self.token_min_hop_len, self.token_overlap_len
        while True:
            lm_decode_chunk_v1(self.llm, state, hop)
            count, done = int(state.gen.count[0]), bool(state.gen.done[0])
            tokens = state.gen.out[0, :count].cpu().numpy()
            while count - consumed >= hop + lap:
                yield {"tts_speech": self.token2wav(tokens[consumed:consumed + hop + lap], fpt,
                                                    feat, emb, session, finalize=False)}
                consumed += hop
                hop = min(self.token_max_hop_len, int(hop * self.stream_scale_factor))
            if done or state.gen.step >= cap:
                break
        _warn_if_capped(count, allowed, cap, self.fr)
        yield {"tts_speech": self.token2wav(tokens[consumed:], fpt, feat, emb, session,
                                            finalize=True)}
