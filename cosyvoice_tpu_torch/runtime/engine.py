"""Continuous-batching LM serving engine (slot-based).

Port of cosyvoice_tpu/runtime/engine.py.  A fixed number of SLOTS forms the
decode batch; requests join and leave it, so the batch stays full although
sequences finish at different times:
  * `engine_admit` / `engine_admit_many` prefill one request (or a burst of
    same-bucket requests) into a small cache, copy the prefix K/V into the
    slots' rows of the engine-wide cache and sample each first token;
    `engine_admit_pho` / `engine_admit_many_pho` do the same for the
    phoneme LMs (models/llm_phoneme.py), whose prefix `prefix_for_decode`
    builds from text, phonemes and a speaker vector;
  * `engine_decode_segment` advances every live slot by up to n steps; each
    slot sits at its own sequence length, so the cache carries a per-row
    frontier `pos [S]` (the lm_decode_attention kernel takes the vector under
    `fused_cache_update`; the head-major cache appends per row);
  * `ServingEngine` is the host scheduler: it admits pending requests into
    free slots between segments, streams each slot's new tokens to its
    consumer and recycles slots as soon as a sequence finishes.  The segment
    right after an admission runs `first_segment_extra` more steps, so a
    streaming consumer that needs hop + lookahead tokens a chunk gets a
    fresh request's first chunk after one segment.

Decode math is lm_generate's (models/llm.py, `_sample_advance`), so greedy
tokens equal lm_generate's per request under staggered admission and slot
reuse.  With stochastic sampling one torch.Generator serves every slot, so
draws differ from lm_generate's but not their distribution.  The JAX
package's `lax.while_loop` segment is a Python loop over decode steps here;
eager PyTorch compiles nothing per shape, so a burst is admitted as it comes
(the JAX package pads it to a power of two to bound its compiles).  The JAX
scheduler dispatches the next segment before its consumer's `on_segment`
work, which then overlaps the device's decode; a Python segment loop runs
the segment on the host before returning, so here `on_segment` fires right
after the segment's harvest and admissions, ahead of the next segment, and
a streamed chunk waits for no extra segment.  Cache writes are in place.
The helpers take any LM with the decode contract (forward_hidden,
decode_logits, speech_emb, cfg.{qwen, eos_token, sampling}): Qwen2LM and
the phoneme LMs, which subclass it.
"""
from __future__ import annotations

import queue
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from cosyvoice_tpu_torch.device import resolve_device
from cosyvoice_tpu_torch.models.llm import GenState, Qwen2LM, _sample_advance
from cosyvoice_tpu_torch.models.qwen2 import KVCache, causal_prefill_bias
from cosyvoice_tpu_torch.ops.masks import NEG_INF
from cosyvoice_tpu_torch.runtime.model import round_up

@dataclass
class EngineState:
    """All decode state, one row per slot.  done=True marks both finished and
    empty slots, so a segment exits early when nothing is live."""

    cache: KVCache                  # k/v per layer; pos [S] int32 per-row frontier
    prev_emb: torch.Tensor          # [S, 1, D] next input embedding
    step: torch.Tensor              # [S] decode steps taken (incl. non-emitted)
    count: torch.Tensor             # [S] emitted tokens
    done: torch.Tensor              # [S] bool
    out: torch.Tensor               # [S, max_out] emitted tokens
    recent: torch.Tensor            # [S, win] last emitted (RAS window)
    recent_n: torch.Tensor          # [S]
    min_len: torch.Tensor           # [S]
    max_len: torch.Tensor           # [S]
    gen: Optional[torch.Generator]  # sampling draws (unused by greedy)


def engine_init(model: Qwen2LM, num_slots: int, cache_len: int, max_out: int,
                gen: Optional[torch.Generator], dtype, device) -> EngineState:
    cfg = model.cfg
    S, win = num_slots, cfg.sampling.win_size
    cache = KVCache.create(cfg.qwen, S, cache_len, dtype, device)
    cache.pos = torch.zeros(S, dtype=torch.int32, device=device)
    i32 = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=device)
    return EngineState(
        cache=cache, prev_emb=torch.zeros((S, 1, cfg.llm_input_size), dtype=dtype,
                                          device=device),
        step=i32(S), count=i32(S), done=torch.ones(S, dtype=torch.bool, device=device),
        out=i32(S, max_out), recent=i32(S, win), recent_n=i32(S), min_len=i32(S),
        max_len=torch.ones(S, dtype=torch.int32, device=device), gen=gen)


@torch.no_grad()
def engine_admit(model: Qwen2LM, state: EngineState, slot: int, text, text_len,
                 prompt_speech, prompt_speech_len, min_len, max_len) -> EngineState:
    """Prefill one request (text [Tt], prompt_speech [Ts], bucketed lengths)
    and install it in `slot`.  The prefix K/V is computed against a small
    [1, Tp] cache and copied into the slot's rows; rows past the true prefix
    hold garbage beyond the slot's frontier (pos = seq_len), which decode
    overwrites one by one."""
    embeds, seq_len = model.prefill_embeds(text[None], text_len.reshape(1),
                                           prompt_speech[None], prompt_speech_len.reshape(1))
    return _engine_install(model, state, slot, embeds, seq_len, min_len, max_len)


@torch.no_grad()
def engine_admit_many(model: Qwen2LM, state: EngineState, slots, text, text_len,
                      prompt_speech, prompt_speech_len, min_len, max_len) -> EngineState:
    """Admit K same-bucket requests with one batched prefill.  slots [K];
    text [K, Tt]; prompt_speech [K, Ts]; the rest [K] vectors.  Math per row
    is engine_admit's."""
    embeds, seq_len = model.prefill_embeds(text, text_len, prompt_speech, prompt_speech_len)
    return _engine_install_many(model, state, slots, embeds, seq_len, min_len, max_len)


@torch.no_grad()
def engine_admit_pho(model, state: EngineState, slot: int, text, text_len, pho_token,
                     pho_len, prompt_speech, prompt_speech_len, embedding, min_len,
                     max_len) -> EngineState:
    """engine_admit for a phoneme LM: text [Tt], pho_token [Tp, 4] (bucketed
    lengths), embedding [spk_dim]; the prefix is `prefix_for_decode`'s."""
    embeds, seq_len = model.prefix_for_decode(
        text[None], text_len.reshape(1), pho_token[None], pho_len.reshape(1),
        prompt_speech[None], prompt_speech_len.reshape(1), embedding[None])
    return _engine_install(model, state, slot, embeds, seq_len, min_len, max_len)


@torch.no_grad()
def engine_admit_many_pho(model, state: EngineState, slots, text, text_len, pho_token,
                          pho_len, prompt_speech, prompt_speech_len, embedding, min_len,
                          max_len) -> EngineState:
    """engine_admit_many for a phoneme LM: pho_token [K, Tp, 4], embedding
    [K, spk_dim], the rest as engine_admit_many's."""
    embeds, seq_len = model.prefix_for_decode(text, text_len, pho_token, pho_len,
                                              prompt_speech, prompt_speech_len, embedding)
    return _engine_install_many(model, state, slots, embeds, seq_len, min_len, max_len)


def _engine_install(model, state: EngineState, slot: int, embeds, seq_len, min_len,
                    max_len) -> EngineState:
    """Admit tail for one request: `_engine_install_many` with one row."""
    dev = embeds.device
    vec = lambda v: torch.as_tensor(v, dtype=torch.int32, device=dev).reshape(1)
    return _engine_install_many(model, state, vec(slot), embeds, seq_len, vec(min_len),
                                vec(max_len))


def _engine_install_many(model, state: EngineState, slots, embeds, seq_len, min_len,
                         max_len) -> EngineState:
    """Admit tail: run the K prefixes through the body into a small cache,
    copy it into the slots' rows, then sample each first token exactly as
    lm_generate samples after its prefill."""
    cfg = model.cfg
    K, Tp = embeds.shape[:2]
    dev = embeds.device
    slots = torch.as_tensor(slots, dtype=torch.long, device=dev)
    pcache = KVCache.create(cfg.qwen, K, Tp, embeds.dtype, dev)
    bias = causal_prefill_bias(Tp, Tp, seq_len, K, embeds.dtype, dev)
    hidden, pcache = model.forward_hidden(embeds, torch.arange(Tp, device=dev)[None]
                                          .expand(K, Tp), bias, pcache)
    last = hidden[torch.arange(K, device=dev), seq_len - 1][:, None]
    for c, u in zip(state.cache.k + state.cache.v, pcache.k + pcache.v):
        if cfg.qwen.fused_cache_update:     # packed [S, Tmax, KH*D]
            c[slots, :Tp] = u
        else:                               # head-major [S, KH, Tmax, D]
            c[slots, :, :Tp] = u
    # the first sample of each row, on a fresh row state (lm_generate's step 0)
    win = cfg.sampling.win_size
    i32 = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=dev)
    rows = GenState(cache=pcache, prev_emb=torch.zeros_like(last), step=0, count=i32(K),
                    done=torch.zeros(K, dtype=torch.bool, device=dev),
                    out=i32(K, state.out.shape[1]), recent=i32(K, win), recent_n=i32(K))
    min_len = torch.as_tensor(min_len, device=dev)
    max_len = torch.as_tensor(max_len, device=dev)
    _sample_advance(model, rows, last, min_len, max_len, state.gen)
    state.cache.pos[slots] = seq_len.to(torch.int32)
    state.prev_emb[slots] = rows.prev_emb.to(state.prev_emb.dtype)
    state.step[slots] = rows.step
    for name in ("count", "done", "out", "recent", "recent_n"):
        getattr(state, name)[slots] = getattr(rows, name)
    state.min_len[slots] = min_len.to(torch.int32)
    state.max_len[slots] = max_len.to(torch.int32)
    return state


@torch.no_grad()
def engine_decode_segment(model: Qwen2LM, state: EngineState, n_steps: int) -> EngineState:
    """Advance every live slot by up to n_steps tokens (stop early when all
    slots are done); slots at different sequence lengths."""
    cfg = model.cfg
    k0 = state.cache.k[0]
    cache_len = k0.shape[1] if cfg.qwen.fused_cache_update else k0.shape[2]
    key = torch.arange(cache_len, device=k0.device)
    start = state.step.clone()
    while not bool(state.done.all()) and bool((state.step - start < n_steps).any()):
        # done rows keep their frontier: their writes land in one scratch row
        pos0 = state.cache.pos.clamp_max(cache_len - 1)
        bias = torch.where(key[None, :] <= pos0[:, None], 0.0, NEG_INF)
        state.cache.pos = pos0
        hidden, cache = model.forward_hidden(state.prev_emb, pos0[:, None],
                                             bias.to(state.prev_emb.dtype)[:, None, None],
                                             state.cache)
        cache.pos = torch.where(state.done, pos0, pos0 + 1)
        _sample_advance(model, state, hidden, state.min_len, state.max_len, state.gen)
    return state


def _pack_harvest(count, done, out) -> torch.Tensor:
    """[S], [S] bool, [S, max_out] -> one [S, max_out + 2] int32 tensor, so the
    host reads a segment's results in one copy."""
    return torch.cat([out, count[:, None], done.to(torch.int32)[:, None]], dim=1)


# --------------------------------------------------------------------------
# host scheduler
# --------------------------------------------------------------------------

@dataclass
class GenRequest:
    """One LM generation request (ids already tokenized/assembled)."""

    text: np.ndarray                 # [Tt] prompt_text ++ text ids
    prompt_speech: np.ndarray        # [Ts] prompt speech tokens
    min_len: Optional[int] = None    # default 2x / 20x new-text len
    max_len: Optional[int] = None
    new_text_len: Optional[int] = None  # len basis for min/max (default: all)
    # phoneme-LM requests: 4-way factored ids and the speaker vector
    pho_token: Optional[np.ndarray] = None   # [Tp, 4]
    embedding: Optional[np.ndarray] = None   # [spk_embed_dim]


@dataclass
class ServingEngine:
    """Continuous-batching scheduler over the admit/segment functions, on
    `device` (the GPU unless the caller asks for "cpu"; the model is moved
    there).

    generate() keeps `num_slots` sequences decoding concurrently, admitting
    pending requests the moment a slot frees up, and streams each request's
    new tokens through `on_tokens(request_index, tokens, done)` after every
    segment.  Decode runs in segments of `segment_steps` tokens between
    scheduler interventions (50 tokens = one 2 s flow chunk)."""

    model: Qwen2LM
    num_slots: int = 8
    cache_len: int = 1024
    max_out: int = 768
    segment_steps: int = 50
    # extra steps for the segment right after an admission: a fresh slot holds
    # one token (the admit sample), so a consumer that needs hop + lookahead
    # tokens a chunk (50 + 3) would otherwise wait two segments for its first
    # chunk; ContinuousSynthesizer passes lookahead - 1, and 1 + 50 + 2 = 53
    first_segment_extra: int = 0
    text_bucket: int = 32
    speech_bucket: int = 64
    device: Optional[str] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.model.to(self.device).eval()

    def serve(self, submissions, gen: Optional[torch.Generator] = None,
              on_segment: Optional[Callable] = None) -> None:
        """Online scheduler: pull (GenRequest, on_tokens) pairs from the
        thread-safe `submissions` queue.Queue while decoding.  Blocks on the
        queue only when no slot is live; a None item drains live work and
        returns.  on_tokens(new_tokens, done) is per request (bind the
        request identity into the callback).  on_segment() fires once per
        segment after its on_tokens and the admissions they make room for,
        before the next segment.  `gen`
        drives the sampling (default: a generator seeded 0, as the JAX
        engine defaults to PRNGKey(0))."""
        cfg, dev = self.model.cfg, self.device
        if gen is None:
            gen = torch.Generator().manual_seed(0)
        dtype = self.model.speech_embedding.weight.dtype
        state = engine_init(self.model, self.num_slots, self.cache_len, self.max_out, gen,
                            dtype, dev)
        slot_cb: dict[int, Callable] = {}   # slot -> per-request on_tokens
        seen: dict[int, int] = {}           # slot -> tokens already streamed
        free = list(range(self.num_slots))[::-1]
        stopping = False

        def prep(r: GenRequest) -> dict:
            """Bucket/pad one request's host arrays and derive min/max lens.
            A phoneme request's stream is bucketed like text, and its bucket
            key never equals a text request's, so the two never share a
            batched prefill."""
            if r.pho_token is not None and not hasattr(self.model, "prefix_for_decode"):
                raise ValueError(f"a phoneme request needs a phoneme LM "
                                 f"(models/llm_phoneme.py), not {type(self.model).__name__}")
            tt = np.asarray(r.text, np.int64)
            ps = np.asarray(r.prompt_speech, np.int64)
            ntl = r.new_text_len if r.new_text_len is not None else len(tt)
            mn = r.min_len if r.min_len is not None else int(cfg.min_token_text_ratio * ntl)
            mx = r.max_len if r.max_len is not None else int(cfg.max_token_text_ratio * ntl)
            mx = min(mx, self.max_out)
            Tt = round_up(max(len(tt), 1), self.text_bucket)
            Ts = round_up(max(len(ps), 1), self.speech_bucket)
            # a bound on the prefix: the phoneme stream and the speaker slot
            Tp = (round_up(max(len(r.pho_token), 1), self.text_bucket)
                  if r.pho_token is not None else 0)
            need = 3 + Tt + Tp + Ts + mx
            if need > self.cache_len:
                raise ValueError(f"request needs {need} cache rows > {self.cache_len}")
            text = np.zeros(Tt, np.int64)
            text[:len(tt)] = tt
            psp = np.zeros(Ts, np.int64)
            psp[:len(ps)] = ps
            p = dict(text=text, tlen=len(tt), psp=psp, plen=len(ps), mn=mn, mx=mx,
                     pho=None, key=(Tt, Ts, Tp if r.pho_token is not None else -1))
            if r.pho_token is not None:
                pho = np.asarray(r.pho_token, np.int64)
                p["pho"] = np.zeros((Tp, pho.shape[1]), np.int64)
                p["pho"][:len(pho)] = pho
                p.update(pho_len=len(pho), emb=np.asarray(r.embedding, np.float32))
            return p

        def t(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.long, device=dev)

        def emb(x):
            return torch.as_tensor(x, dtype=torch.float32, device=dev)

        def admit_all(items: list) -> None:
            """Admit a burst: same-bucket requests share one batched prefill;
            a request alone in its bucket takes the B=1 admit."""
            nonlocal state
            groups: dict = defaultdict(list)
            for r, cb in items:
                p = prep(r)
                groups[p["key"]].append((p, cb))
            for members in groups.values():
                slots = [free.pop() for _ in members]
                ps = [p for p, _ in members]
                if len(members) == 1:
                    p = ps[0]
                    if p["pho"] is None:
                        state = engine_admit(self.model, state, slots[0], t(p["text"]),
                                             t(p["tlen"]), t(p["psp"]), t(p["plen"]),
                                             p["mn"], p["mx"])
                    else:
                        state = engine_admit_pho(
                            self.model, state, slots[0], t(p["text"]), t(p["tlen"]),
                            t(p["pho"]), t(p["pho_len"]), t(p["psp"]), t(p["plen"]),
                            emb(p["emb"]), p["mn"], p["mx"])
                else:
                    col = lambda k: t([p[k] for p in ps])
                    stack = lambda k: t(np.stack([p[k] for p in ps]))
                    if ps[0]["pho"] is None:
                        state = engine_admit_many(
                            self.model, state, slots, stack("text"), col("tlen"),
                            stack("psp"), col("plen"), col("mn"), col("mx"))
                    else:
                        state = engine_admit_many_pho(
                            self.model, state, slots, stack("text"), col("tlen"),
                            stack("pho"), col("pho_len"), stack("psp"), col("plen"),
                            emb(np.stack([p["emb"] for p in ps])), col("mn"), col("mx"))
                for slot, (_, cb) in zip(slots, members):
                    slot_cb[slot] = cb
                    seen[slot] = 0

        def pull(block_idle: bool) -> bool:
            """Admit into free slots; True if anything was admitted.  Blocks
            for work only when idle (block_idle and nothing live); all
            available submissions are drained first, then admitted together."""
            nonlocal stopping
            pending: list = []
            while len(pending) < len(free) and not stopping:
                try:
                    item = submissions.get(block=block_idle and not slot_cb and not pending)
                except queue.Empty:
                    break
                if item is None:
                    stopping = True
                    break
                pending.append(item)
            if pending:
                admit_all(pending)
            return bool(pending)

        def harvest(packed: np.ndarray) -> None:
            """Stream new tokens from a fetched harvest array; free finished
            slots."""
            count, done, out = packed[:, -2], packed[:, -1].astype(bool), packed[:, :-2]
            for slot in list(slot_cb):
                cb, c = slot_cb[slot], int(count[slot])
                new, fin = out[slot, seen[slot]:c], bool(done[slot])
                if len(new) or fin:
                    cb(new.copy(), fin)
                seen[slot] = c
                if fin:
                    del slot_cb[slot], seen[slot]
                    free.append(slot)

        def segment(admitted: bool):
            nonlocal state
            steps = self.segment_steps + (self.first_segment_extra if admitted else 0)
            state = engine_decode_segment(self.model, state, steps)
            return _pack_harvest(state.count, state.done, state.out)

        while True:
            admitted = pull(block_idle=True)
            if not slot_cb:
                if stopping:
                    return
                continue
            while slot_cb:
                harvest(segment(admitted).cpu().numpy())
                admitted = pull(block_idle=False)
                if on_segment is not None:
                    on_segment()
            if stopping:
                return

    def generate(self, requests: Sequence[GenRequest], gen: Optional[torch.Generator] = None,
                 on_tokens: Optional[Callable] = None,
                 on_segment: Optional[Callable] = None) -> list[np.ndarray]:
        """Batch entry point over serve(): on_tokens(request_index, new_tokens,
        done) fires per slot after each segment; on_segment() once per
        segment after them."""
        subs: queue.Queue = queue.Queue()
        acc: list[list[int]] = [[] for _ in requests]
        results: list[Optional[np.ndarray]] = [None] * len(requests)

        def cb_for(i):
            def cb(new, fin):
                acc[i].extend(new.tolist())
                if on_tokens is not None:
                    on_tokens(i, new, fin)
                if fin:
                    results[i] = np.asarray(acc[i], np.int32)
            return cb

        for i, r in enumerate(requests):
            subs.put((r, cb_for(i)))
        subs.put(None)
        self.serve(subs, gen=gen, on_segment=on_segment)
        return results  # type: ignore[return-value]
