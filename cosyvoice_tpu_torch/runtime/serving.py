"""Batched and continuous serving over a CosyVoice2Model.

Port of cosyvoice_tpu/runtime/serving.py:
- `BatchedSynthesizer` collects requests, right-pads them to shared buckets
  and runs one batched LM decode, one ragged-batched flow call (each row
  with its own prompt length, `prompt_feat_len`; its DiT blocks through the
  dit_block_fused kernel when the estimator has `fused_block`) and one
  batched vocoder call.
- `ContinuousSynthesizer` is streaming TTS under continuous batching: the
  LM runs in the slot engine (runtime/engine.py), and after every decode
  segment each stream whose tokens passed its next hop gets its flow and
  vocoder chunk.  Windowed mode (the default) runs the chunks ready at a
  segment boundary as one ragged flow call a streaming group (or, without
  `batch_chunks`, as the sequential token2wav calls) and vocodes them with
  the grouped vocoders of runtime/model.py; incremental mode computes each
  mel row once against per-slot cached state (runtime/flow_engine.py).
  A request with `pho_token` goes to a phoneme LM (models/llm_phoneme.py):
  its phoneme count sets the token bounds, and `embedding` is both the
  LM's speaker vector and the flow's.
The JAX package pads a flush group to a power of two to bound its compiles;
eager PyTorch compiles nothing per shape, so the port runs the group as it
comes (the outputs a row are the same either way).
BatchedSynthesizer refuses phoneme requests, as the JAX one has no
phoneme route.

More than one card: `BatchedSynthesizer(mesh=...)` runs one process a rank
(parallel/mesh.py): the LM shards by the tensor-parallel rules, the flow
and the vocoder are replicated, the rows are padded up to a multiple of
"data" and each data rank runs its rows at the shapes of the whole batch;
every rank returns every wav.  Greedy decoding equals one card's; sampled
decoding and the vocoder's source noise draw from generators of (seed, data
rank).  `ContinuousSynthesizer(flow_device=...)` puts the flow and the
vocoder on a second device and runs each segment's chunks on a worker
thread while the engine decodes the next segment.
"""
from __future__ import annotations

import copy
import queue
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from cosyvoice_tpu_torch.models.flow import _DTYPES, reference_rand_noise
from cosyvoice_tpu_torch.models.llm import lm_generate
from cosyvoice_tpu_torch.parallel.collectives import gather_dim
from cosyvoice_tpu_torch.parallel.mesh import (LM_RULES, batch_sharding, rank_generator,
                                               shard_params)
from cosyvoice_tpu_torch.runtime.engine import GenRequest, ServingEngine
from cosyvoice_tpu_torch.runtime.flow_engine import FlowSlotEngine
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
    embedding: np.ndarray              # [spk_dim]: the flow's, and a phoneme LM's
    # phoneme-LM requests (ContinuousSynthesizer): 4-way factored ids
    pho_token: Optional[np.ndarray] = None     # [Tp, 4]


@dataclass
class BatchedSynthesizer:
    """Non-streaming batched synthesis over a CosyVoice2Model, on its device;
    with `mesh` (parallel/mesh.Mesh) over the ranks of a data x model
    layout, one process a rank."""

    model: CosyVoice2Model
    text_bucket: int = 32              # pad text lengths to multiples
    speech_bucket: int = 64
    mesh: Optional[object] = None

    def __post_init__(self):
        llm = self.model.llm
        if self.mesh is not None and getattr(llm, "tp", None) is None:
            shard_params(llm, self.mesh, LM_RULES)

    def _rows(self, B: int) -> slice:
        """This rank's rows of a batch of B (all of them without a mesh)."""
        return slice(0, B) if self.mesh is None else batch_sharding(self.mesh, B)

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows -> the whole [B, ...] batch, through fp32
        (exact for token ids and counts)."""
        if self.mesh is None or self.mesh.data == 1:
            return x
        mesh = self.mesh
        return gather_dim(x.float(), 0, mesh.data_rank, mesh.data, mesh.data_group).to(x.dtype)

    def synthesize_batch(self, requests: Sequence[TTSRequest],
                         gen: Optional[torch.Generator] = None) -> list[np.ndarray]:
        """Synthesize B requests together: batched LM decode, then one ragged
        flow call (per-row prompt lengths) and one batched vocoder call.
        `gen` drives the LM's sampling (default: seed 0); the vocoder's
        source noise comes from a generator seeded from it."""
        if any(r.pho_token is not None for r in requests):
            raise NotImplementedError(
                "BatchedSynthesizer has no phoneme route (neither has the JAX package's, "
                "cosyvoice_tpu/runtime/serving.py); serve phoneme requests through "
                "ContinuousSynthesizer")
        n = len(requests)
        if self.mesh is not None:
            # pad to the data axis (copies of the last row, cut at return)
            requests = list(requests) + [requests[-1]] * ((-n) % self.mesh.data)
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        vgen = torch.Generator().manual_seed(gen.initial_seed() + 1)
        if self.mesh is not None:
            gen = rank_generator(gen, self.mesh.data_rank)
            vgen = rank_generator(vgen, self.mesh.data_rank)
        tokens = self.generate(requests, gen)
        mel, tls, pfl = self.flow_batch(requests, tokens)
        return self.vocode_batch(mel, tls, pfl, vgen)[:n]

    def generate(self, requests: Sequence[TTSRequest],
                 gen: torch.Generator) -> list[np.ndarray]:
        """One batched lm_generate over the right-padded prompts (this rank's
        rows, at the whole batch's shapes); returns every row's emitted
        tokens."""
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
        rows = self._rows(B)
        t = lambda a: m._tensor(a[rows], torch.long)  # noqa: E731
        out, count = lm_generate(m.llm, t(text), t(tlen), t(psp), t(plen), t(min_len),
                                 t(max_len), gen, max_steps=cap,
                                 cache_len=round_up(2 + Tt + Ts + cap, 128))
        out = self._gather(out).cpu().numpy()
        count = self._gather(count).cpu().numpy()
        for i in range(B):
            m._warn_if_capped(int(count[i]), int(allowed[i]), int(max_len[i]))
        return [out[i, :count[i]] for i in range(B)]

    def flow_batch(self, requests: Sequence[TTSRequest], tokens: Sequence[np.ndarray]):
        """One ragged-batched flow call over prompt ++ generated tokens of this
        rank's rows, at the whole batch's shapes; returns (mel [rows,
        ratio*Ttok, 80], every row's token lengths, every row's prompt mel
        lengths)."""
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
        rows = self._rows(B)
        mel = m.flow.inference(m._tensor(tok[rows], torch.long),
                               m._tensor(np.asarray(tls)[rows], torch.long),
                               m._tensor(pf[rows], torch.float32),
                               m._tensor(emb[rows], torch.float32),
                               noise=_noise_for(m, Ttok),
                               prompt_feat_len=m._tensor(pfl[rows], torch.long))
        return mel, tls, pfl

    def vocode_batch(self, mel: torch.Tensor, tls, pfl,
                     gen: torch.Generator) -> list[np.ndarray]:
        """Repack each of this rank's rows' generated mel region, one batched
        HiFT call; returns every row's wav."""
        m = self.model
        B = len(tls)
        Ls = [m.ratio * n - int(p) for n, p in zip(tls, pfl)]
        Lmax = round_up(max(Ls), 32)
        rows = self._rows(B)
        idx = range(B)[rows]
        gen_mel = torch.stack([F.pad(mel[j, pfl[i]:pfl[i] + Ls[i]].float(),
                                     (0, 0, 0, Lmax - Ls[i])) for j, i in enumerate(idx)])
        wav, _ = m.hift.inference(gen_mel, gen=gen)
        wav = self._gather(wav).cpu().numpy()
        return [wav[i, :Ls[i] * m.hop_samples] for i in range(B)]


class _Stream:
    """One request's streaming state: its tokens so far, the emitted token
    offset, the next hop, the vocoder session and the flow slot (claimed at
    its first incremental flow chunk)."""

    __slots__ = ("req", "on_chunk", "tokens", "offset", "session", "hop", "fslot")

    def __init__(self, req: TTSRequest, on_chunk: Optional[Callable], session: dict,
                 hop: int):
        self.req, self.on_chunk, self.session, self.hop = req, on_chunk, session, hop
        self.tokens: list[int] = []
        self.offset = 0
        self.fslot: Optional[int] = None


@dataclass
class ContinuousSynthesizer:
    """Streaming TTS under continuous batching, on the model's device.

    The LM runs in the slot engine, so sequences join and leave the decode
    batch independently; after every decode segment each stream whose tokens
    passed its next hop boundary gets its flow and vocoder chunk (hop 50
    tokens, lookahead 3, the fade caches of runtime/model.py), and
    `on_chunk(wav, final)` of its request receives it.  The engine's
    `first_segment_extra` (lookahead - 1) gives a fresh stream its first
    hop + lookahead tokens in one segment.

    - batch_chunks: the chunks ready at a segment boundary run as one ragged
      flow call a streaming group (exact_pad_mask keeps each row's mel that
      of its own call) and are vocoded by the grouped vocoders; without it,
      each chunk is the sequential token2wav call.
    - hop_scale > 1 grows a stream's hop by that factor a chunk (a multiple
      of the base hop, at most max_hop, default 4 hops); the first chunk
      still comes after hop + lookahead tokens.
    - incremental: the flow runs in FlowSlotEngine, each mel row computed
      once against the slot's cached state.  Needs a stream-config flow
      (estimator.stream, finite left_chunks); the audio follows the
      stream-masked model, and flow_context_tokens is unused.
    - flow_device: copies of the flow and the vocoder (their parameters and
      every chunk's operands) live there, and each segment's chunks run on a
      worker thread while the engine decodes the next segment on the LM's
      device, so the two stages overlap; the audio is the one-device audio.
    """

    model: CosyVoice2Model
    num_slots: int = 8
    cache_len: int = 1024
    # per-request token cap; None: the model's max_decode_tokens
    max_out: Optional[int] = None
    text_bucket: int = 32
    speech_bucket: int = 64
    batch_chunks: bool = True
    hop_scale: float = 1.0
    max_hop: Optional[int] = None
    flow_device: Optional[object] = None
    incremental: bool = False
    flow_tok_cap: Optional[int] = None     # default: 256 + max_out

    def __post_init__(self):
        m = self.model
        # the model the chunks run on: the model itself, or a view of it whose
        # flow, vocoder and operands sit on flow_device
        self._fm = m
        if self.flow_device is not None:
            # copies, so that the caller's model keeps serving on its device
            self._fm = copy.copy(m)
            self._fm.device = torch.device(self.flow_device)
            self._fm.flow = copy.deepcopy(m.flow).to(self._fm.device)
            self._fm.hift = copy.deepcopy(m.hift).to(self._fm.device)
            m = self._fm
        self._fse: Optional[FlowSlotEngine] = None
        if self.incremental:
            cap = self.flow_tok_cap or 256 + (self.max_out or m.max_decode_tokens)
            noise = (m.flow_noise if m.flow_noise is not None else
                     reference_rand_noise(m.flow.cfg.cfm.noise_frames, m.flow.cfg.output_size))
            self._fse = FlowSlotEngine(
                m.flow, self.num_slots, cap, noise, m.flow.cfg.spk_embed_dim,
                enc_dtype=_DTYPES[m.flow.cfg.encoder_dtype],
                est_dtype=_DTYPES[m.flow.cfg.estimator.dtype], device=m.device)

    def _flush_group(self, jobs: list, emit: Callable, streaming: bool) -> None:
        """One ragged flow call over `jobs` (each (stream, tokens, offset,
        final, hop)), then the grouped vocoders.  Each job's mel is sliced as
        the sequential token2wav slices it: the generated region starts at
        the prompt's mel rows, holds ratio * (tokens - prompt tokens) rows,
        and the chunk begins at offset * ratio (less the window's drop)."""
        m = self._fm
        ratio = m.ratio
        B = len(jobs)
        tls, toks, drops = [], [], []
        for st, tok, off, _, _ in jobs:
            d = m.flow_window_drop(len(tok), off)     # the sequential path's window
            drops.append(d)
            toks.append(np.concatenate([st.req.prompt_speech_tokens, tok[d:]]))
            tls.append(len(toks[-1]))
        bucket = max(round_up(max(tls), m.token_hop_len), m.token_hop_len)
        tokm = np.zeros((B, bucket), np.int64)
        pfl = np.asarray([j[0].req.prompt_feat.shape[0] for j in jobs], np.int64)
        pf = np.zeros((B, int(pfl.max()), m.flow.cfg.output_size), np.float32)
        for i, (st, *_) in enumerate(jobs):
            tokm[i, :tls[i]] = toks[i]
            pf[i, :pfl[i]] = st.req.prompt_feat
        emb = np.stack([np.asarray(j[0].req.embedding, np.float32) for j in jobs])
        if m.flow_noise is None:
            noise = None
        elif not any(drops):
            noise = _noise_for(m, bucket)
        else:
            noise = torch.cat([m.windowed_noise(int(pfl[i]), drops[i], ratio * bucket)
                               for i in range(B)])
        mel = m.flow.inference(m._tensor(tokm, torch.long), m._tensor(tls, torch.long),
                               m._tensor(pf, torch.float32), m._tensor(emb, torch.float32),
                               noise=noise, prompt_feat_len=m._tensor(pfl, torch.long),
                               streaming=streaming)
        # the JAX package vocodes a steady-state group by hop size, a final
        # group and a mixed one in three programs; mel2wav_group already
        # batches rows of one padded length (one hop size, or one final
        # length) and keeps each session's order, so one call covers all three
        valid = [ratio * (tls[i] - len(jobs[i][0].req.prompt_speech_tokens)) for i in range(B)]
        wavs = m.mel2wav_group(
            [mel[i, pfl[i] + (jobs[i][2] - drops[i]) * ratio:pfl[i] + valid[i]]
             for i in range(B)], [j[0].session for j in jobs], [j[3] for j in jobs])
        for (st, _, _, fin, _), wav in zip(jobs, wavs):
            emit(st, wav, fin)

    def _flush_group_inc(self, jobs: list, emit: Callable) -> list:
        """Incremental flush: one FlowSlotEngine.chunk call a (first, final,
        bucket, hop) group over each stream's new tokens only.  Jobs of one
        stream go in waves (a later chunk needs the earlier one's state).
        A stream claims its flow slot at its first chunk and releases it at
        its final one; finals run first in each wave so their releases serve
        the wave's claims.  The LM engine frees its slot when the tokens end,
        before the last flow chunk, so live flow streams can outnumber the
        slots for a while: jobs that find no slot are returned, to run at the
        next flush (the pending finals guarantee progress)."""
        m, fse = self._fm, self._fse
        ratio, la, hop_base = m.ratio, m.pre_lookahead_len, m.token_hop_len
        waves: list = []
        seen: dict = defaultdict(int)
        for j in jobs:
            k = seen[id(j[0])]
            seen[id(j[0])] += 1
            if len(waves) <= k:
                waves.append([])
            waves[k].append(j)
        deferred: list = []
        deferred_streams: set = set()
        for wave in waves:
            groups: dict = defaultdict(list)
            for j in wave:
                st, tok, off, fin, hop = j
                if id(st) in deferred_streams:
                    deferred.append(j)          # keeps the stream's job order
                    continue
                first = off == 0
                n = len(st.req.prompt_speech_tokens) if first else 0
                n += (len(tok) - off) if fin else hop
                groups[(first, fin, max(round_up(n, hop_base), hop_base),
                        0 if fin else hop)].append(j)
            for key in sorted(groups, key=lambda k: (not k[1], k[2], k[3])):
                first, fin, M, hop = key
                grp = groups[key]
                if first:
                    admitted = []
                    for j in grp:
                        st = j[0]
                        if fse.free:
                            st.fslot = fse.admit(len(st.req.prompt_speech_tokens),
                                                 st.req.embedding)
                            admitted.append(j)
                        else:
                            deferred.append(j)
                            deferred_streams.add(id(st))
                    grp = admitted
                    if not grp:
                        continue
                K = len(grp)
                toks, ctx = np.zeros((K, M), np.int64), np.zeros((K, la), np.int64)
                cl, nv = np.zeros(K, np.int64), np.zeros(K, np.int64)
                pf = np.zeros((K, max(j[0].req.prompt_feat.shape[0] for j in grp) if first
                               else 1, m.flow.cfg.output_size), np.float32)
                pfl = np.zeros(K, np.int64)
                slots, starts, valids = [], [], []
                for i, (st, tok, off, _, hop_) in enumerate(grp):
                    ps = (np.asarray(st.req.prompt_speech_tokens, np.int64) if first
                          else np.zeros(0, np.int64))
                    if fin:
                        g = np.asarray(tok[off:], np.int64)
                    else:
                        g = np.asarray(tok[off:off + hop_], np.int64)
                        c = tok[off + hop_:off + hop_ + la]
                        ctx[i, :len(c)], cl[i] = c, len(c)
                    row = np.concatenate([ps, g])
                    toks[i, :len(row)], nv[i] = row, len(row)
                    slots.append(st.fslot)
                    starts.append(ratio * len(ps))
                    valids.append(ratio * len(g))
                    if first:
                        n_pf = st.req.prompt_feat.shape[0]
                        pf[i, :n_pf], pfl[i] = st.req.prompt_feat, n_pf
                # non-final later chunks are shape-exact (n_valid M): the
                # cache rolls take the static slice
                mel = fse.chunk(slots, toks, ctx, cl, nv, first, pf if first else None,
                                pfl if first else None, ragged=first or fin)
                sessions = [j[0].session for j in grp]
                if fin:
                    wavs = m.mel2wav_final_group(mel, slots, starts, valids, sessions)
                else:
                    wavs = m.mel2wav_stream_group(mel, slots, starts, sessions,
                                                  win_rows=ratio * hop)
                for (st, _, _, fin_, _), w in zip(grp, wavs):
                    emit(st, w, fin_)
                    if fin_:
                        fse.release(st.fslot)
        return deferred

    def serve(self, submissions, gen: Optional[torch.Generator] = None) -> None:
        """Online streaming TTS: pull (TTSRequest, on_chunk(wav, final)) pairs
        from a thread-safe queue.Queue while synthesis runs; a None item
        drains live work and returns.  `gen` drives the LM's sampling."""
        m = self.model
        hop, la = m.token_hop_len, m.pre_lookahead_len
        max_hop = self.max_hop if self.max_hop is not None else 4 * hop
        if (self.hop_scale > 1.0 and m.flow_context_tokens is not None
                and m.flow_context_tokens < max_hop + la):
            raise ValueError(f"flow_context_tokens ({m.flow_context_tokens}) must cover the "
                             f"largest chunk and its lookahead ({max_hop} + {la}), so that "
                             "the final chunk's region stays inside the window")

        def next_hop(h: int) -> int:
            if self.hop_scale <= 1.0:
                return h
            return min(max_hop, round_up(int(h * self.hop_scale), hop))

        engine = ServingEngine(m.llm, num_slots=self.num_slots, cache_len=self.cache_len,
                               max_out=self.max_out or m.max_decode_tokens, segment_steps=hop,
                               first_segment_extra=max(0, la - 1),
                               text_bucket=self.text_bucket, speech_bucket=self.speech_bucket,
                               device=m.device)
        jobs: list = []

        def make_on_tokens(st: _Stream):
            def on_tokens(new, fin):
                st.tokens.extend(new.tolist())
                tok = np.asarray(st.tokens, np.int64)
                while len(tok) - st.offset >= st.hop + la:
                    jobs.append((st, tok[:st.offset + st.hop + la], st.offset, False, st.hop))
                    st.offset += st.hop
                    st.hop = next_hop(st.hop)
                if fin:
                    jobs.append((st, tok, st.offset, True, 0))
            return on_tokens

        def emit(st: _Stream, wav, fin: bool) -> None:
            if st.on_chunk is not None:
                st.on_chunk(wav, fin)

        def run(batch: list) -> list:
            """The chunks of `batch` -> the jobs deferred to a later flush."""
            if self._fse is not None:
                return self._flush_group_inc(batch, emit)
            if not self.batch_chunks:
                for st, tok, off, fin, _ in batch:
                    r = st.req
                    emit(st, self._fm.token2wav(tok, r.prompt_speech_tokens, r.prompt_feat,
                                                r.embedding, off, st.session, finalize=fin),
                         fin)
            else:
                # a stream's chunks precede its final chunk in one segment
                for streaming in (True, False):
                    grp = [j for j in batch if j[3] != streaming]
                    if grp:
                        self._flush_group(grp, emit, streaming=streaming)
            return []

        # flow_device: a segment's chunks run on the worker while the engine
        # decodes the next segment; flushes stay in order, one at a time
        worker = ThreadPoolExecutor(1) if self.flow_device is not None else None
        pending: list = []

        def settle() -> None:
            """Wait for the worker's flush; its deferred jobs go first."""
            if pending:
                jobs[:0] = pending.pop().result()

        def flush() -> None:
            settle()
            batch = jobs[:]
            jobs.clear()
            if worker is None:
                jobs[:0] = run(batch)
            else:
                pending.append(worker.submit(run, batch))

        def on_segment() -> None:
            if jobs or pending:
                flush()

        class _Adapter:
            """TTS submissions as engine (GenRequest, on_tokens) pairs, with
            queue.Queue's get(block) semantics."""

            @staticmethod
            def get(block=True):
                item = submissions.get(block=block)
                if item is None:
                    return None
                req, on_chunk = item
                st = _Stream(req, on_chunk, m.new_session(), hop)
                pho = req.pho_token is not None
                # a phoneme request's token bounds count its phonemes
                return (GenRequest(text=np.asarray(req.text_tokens, np.int64),
                                   prompt_speech=np.asarray(req.prompt_speech_tokens, np.int64),
                                   new_text_len=(len(req.pho_token) if pho else
                                                 len(req.text_tokens) - req.prompt_text_len),
                                   pho_token=np.asarray(req.pho_token, np.int64) if pho else None,
                                   embedding=(np.asarray(req.embedding, np.float32) if pho
                                              else None)),
                        make_on_tokens(st))

        try:
            engine.serve(_Adapter(), gen=gen, on_segment=on_segment)
            settle()
            # the incremental mode may defer jobs past slot contention: each
            # pass flushes finals (freeing slots) and admits the rest
            while jobs:
                n_before = len(jobs)
                flush()
                settle()
                if len(jobs) >= n_before:
                    raise RuntimeError("incremental flush stalled")
        finally:
            if worker is not None:
                worker.shutdown(wait=True)

    def synthesize_batch(self, requests: Sequence[TTSRequest],
                         gen: Optional[torch.Generator] = None,
                         on_chunk: Optional[Callable] = None) -> list[np.ndarray]:
        """Batch driver over serve(): each request's chunks, concatenated;
        on_chunk(request_index, wav, final) as they come."""
        subs: queue.Queue = queue.Queue()
        chunks: list[list[np.ndarray]] = [[] for _ in requests]

        def cb_for(i):
            def cb(wav, fin):
                chunks[i].append(wav)
                if on_chunk is not None:
                    on_chunk(i, wav, fin)
            return cb

        for i, r in enumerate(requests):
            subs.put((r, cb_for(i)))
        subs.put(None)
        self.serve(subs, gen=gen)
        return [np.concatenate(c) for c in chunks]
