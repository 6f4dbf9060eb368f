"""Streaming TTS under continuous batching: the port's ContinuousSynthesizer
against the JAX package's on the same tiny weights (greedy; tokens exact,
every chunk within 1e-2, the bar of tests/test_torch_stream.py), and against
the port's own sequential `tts(stream=True)` (2e-3 / rtol 1e-3, the bar of
tests/test_torch_serving.py) with a HiFT that draws its source noise, so
each stream's generator must reach its own rows.  Also: the grouped
vocoders against a per-session `mel2wav` loop (1e-5), the incremental mode
against the one-shot stream-masked flow vocoded with the same windows
(2e-4 / 1e-3, the JAX package's bar), the engine's first_segment_extra and
the refusals.  At 5 flow frames a second the hop is 10 tokens."""
import copy
import dataclasses
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax

import torch_port_util as U
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)
from cosyvoice_tpu.runtime import engine as JE
from cosyvoice_tpu.runtime import serving as JS
from cosyvoice_tpu.runtime.model import CosyVoice2Model as JModel
from cosyvoice_tpu_torch import convert
from cosyvoice_tpu_torch.models import flow as tflow
from cosyvoice_tpu_torch.models import hift as thift
from cosyvoice_tpu_torch.runtime import engine as TE
from cosyvoice_tpu_torch.runtime import serving as TS
from cosyvoice_tpu_torch.runtime.model import CosyVoice2Model as TModel
from test_torch_stream import NOISE, _flow_configs, _models, _shared

HOP, LA = 10, 3
# the windowed flow: each chunk's flow sees the prompt and the latest <= W +
# HOP generated tokens, which also keeps the JAX side's flow shapes few
W = 2 * HOP + LA
SYNTH = dict(num_slots=2, cache_len=128, text_bucket=16, speech_bucket=8)


def _requests(cls, seed=13):
    """Three zero-shot requests (new text of 12, 14 and 10 bytes; 35, 32 and
    42 greedy tokens on the shared LM), more than the 2 slots, so one waits
    for a free slot."""
    rng = np.random.default_rng(seed)
    return [cls(text_tokens=rng.integers(0, 250, n).astype(np.int32), prompt_text_len=0,
                prompt_speech_tokens=rng.integers(0, U.SPEECH_VOCAB, p).astype(np.int32),
                prompt_feat=(rng.standard_normal((2 * p, U.N_MEL)) * 0.3).astype(np.float32),
                embedding=rng.standard_normal(24).astype(np.float32))
            for n, p in ((12, 5), (14, 3), (10, 6))]


def _recording_engine(monkeypatch, module, tokens: list):
    """Record, request by request (in admission order), the tokens the LM
    engine streams."""
    base = module.ServingEngine

    class Recording(base):
        def serve(self, submissions, *args, **kw):
            class Sub:
                @staticmethod
                def get(block=True):
                    item = submissions.get(block=block)
                    if item is None:
                        return None
                    req, cb = item
                    toks: list = []
                    tokens.append(toks)
                    return req, lambda new, fin: (toks.extend(new.tolist()), cb(new, fin))

            return base.serve(self, Sub(), *args, **kw)

    monkeypatch.setattr(module, "ServingEngine", Recording)


@lru_cache(maxsize=None)
def _windowed():
    """(JAX model, port model): the main family of tests/test_torch_stream.py
    with flow_context_tokens W."""
    (jlm, lm_params, tlm), flow_params, (jh, hift_params, th) = _shared()
    jm, tm = _models("main")
    return (JModel(llm=jlm, flow=jm.flow, hift=jh, llm_params=lm_params, flow_params=flow_params,
                   hift_params=hift_params, max_decode_tokens=48, flow_noise=NOISE,
                   flow_context_tokens=W),
            TModel(llm=tlm, flow=tm.flow, hift=th, max_decode_tokens=48,
                   flow_noise=torch.from_numpy(NOISE), device="cpu", flow_context_tokens=W))


_JAX_RUNS: dict = {}


def _jax_run(batch_chunks: bool, monkeypatch):
    """The JAX ContinuousSynthesizer's tokens and chunks a request (each mode
    run once a module)."""
    if batch_chunks not in _JAX_RUNS:
        jm, _ = _windowed()
        tokens, chunks = [], [[] for _ in range(3)]
        with monkeypatch.context() as mp:
            _recording_engine(mp, JE, tokens)
            JS.ContinuousSynthesizer(jm, **SYNTH, batch_chunks=batch_chunks).synthesize_batch(
                _requests(JS.TTSRequest), rng=jax.random.PRNGKey(0),
                on_chunk=lambda i, wav, fin: chunks[i].append(np.asarray(wav)))
        _JAX_RUNS[batch_chunks] = tokens, chunks
    return _JAX_RUNS[batch_chunks]


@pytest.mark.parametrize("batch_chunks", [True, False])
def test_continuous_matches_jax(batch_chunks, monkeypatch):
    """Windowed ContinuousSynthesizer (ragged flush groups, or the sequential
    token2wav calls; flow_context_tokens W) against the JAX one in the same
    mode: the same greedy tokens a request, every chunk of the same length
    and within 1e-2.  The
    JAX final-chunk group pads every window of a group to a multiple of 128
    rows, so where a final window is a multiple of the 32-row pad its last
    samples depart from the JAX package's own sequential flush (by up to 2.0
    here); the port's grouped vocoders equal the sequential path, so the
    final chunks are held to the JAX sequential flush (ROADMAP Queue 3)."""
    U.interpret_pallas(monkeypatch)
    _, tm = _windowed()
    tok_j, want = _jax_run(batch_chunks, monkeypatch)
    if batch_chunks:
        seq = _jax_run(False, monkeypatch)[1]
        want = [w[:-1] + s[-1:] for w, s in zip(want, seq)]
    tok_t, got = [], [[] for _ in range(3)]
    _recording_engine(monkeypatch, TS, tok_t)
    TS.ContinuousSynthesizer(tm, **SYNTH, batch_chunks=batch_chunks).synthesize_batch(
        _requests(TS.TTSRequest), gen=torch.Generator().manual_seed(0),
        on_chunk=lambda i, wav, fin: got[i].append(np.asarray(wav)))
    assert len(tok_t) == len(tok_j) == 3
    for i in range(3):
        np.testing.assert_array_equal(tok_t[i], tok_j[i], err_msg=f"request {i}")
        assert len(tok_t[i]) >= HOP + LA and len(got[i]) >= 2
        assert [len(w) for w in got[i]] == [len(w) for w in want[i]], f"request {i}"
        for k, (g, w) in enumerate(zip(got[i], want[i])):
            assert np.isfinite(g).all()
            np.testing.assert_allclose(g, w, atol=1e-2, err_msg=f"request {i} chunk {k}")


def _noisy(family: str = "main", **model_kw) -> TModel:
    """The port's tiny stack with a HiFT that draws its NSF noise (the JAX
    comparisons use a deterministic one) and an LM head biased away from the
    ids it does not emit (so that every step emits a token, up to the
    48-token cap, as tests/test_engine.py biases the JAX package's), the flow
    windowed at W tokens; family "incremental" swaps in a stream-family flow
    on the same weights."""
    _, tm = _models("main")
    llm = copy.deepcopy(tm.llm)
    with torch.no_grad():
        llm.llm_decoder.bias[U.SPEECH_VOCAB:] = -30.0
    (_, _, _), flow_params, (_, hift_params, _) = _shared()
    hift = thift.HiFTGenerator(thift.HiFTConfig(**U.HIFT))
    hift.load_state_dict(convert.hift_state_from_jax(hift_params), strict=True)
    flow = tm.flow
    if family == "main":
        model_kw.setdefault("flow_context_tokens", W)
    if family == "incremental":
        # the stream family on 10-frame chunks: 2 chunks of left context fit
        # in the first hop's 20 mel rows, the incremental flow's exactness
        cfg = _flow_configs("stream")[1]
        flow = tflow.CausalMaskedDiffWithXvec(dataclasses.replace(
            cfg, estimator=dataclasses.replace(cfg.estimator, static_chunk_size=HOP)))
        flow.load_state_dict(convert.flow_state_from_jax(flow_params), strict=True)
    return TModel(llm=llm, flow=flow, hift=hift.eval(), max_decode_tokens=48,
                  flow_noise=torch.from_numpy(NOISE), device="cpu", **model_kw)


def _sequential(model, r) -> np.ndarray:
    return np.concatenate([o["tts_speech"] for o in model.tts(
        r.text_tokens, 0, r.prompt_speech_tokens, r.prompt_speech_tokens, r.prompt_feat,
        r.embedding, stream=True)])


@pytest.mark.parametrize("mode", ["batch_chunks", "hop_scale_2", "long_prompt_mel"])
def test_continuous_matches_sequential(mode, monkeypatch):
    """Against the port's own paths, with HiFT noise drawn from each
    stream's generator: ragged flush groups equal each request's sequential
    tts(stream=True), also when a prompt mel has more than 2 rows a prompt
    token (as the frontend leaves it at other rates than 24 kHz, where the
    last chunks' regions run past the flow's rows and are cut as the
    sequential slice cuts them); with hop_scale 2.0 the flush groups equal
    the sequential token2wav calls on the same growing hops (mixed hop sizes
    in one group), and a later chunk is longer than the first.  The first
    chunk of each request admitted at the start comes after one decode
    segment (first_segment_extra = lookahead - 1, and the flush runs before
    the next segment)."""
    model = _noisy()
    reqs = _requests(TS.TTSRequest)
    if mode == "long_prompt_mel":
        reqs = [dataclasses.replace(r, prompt_feat=np.concatenate(
            [r.prompt_feat, r.prompt_feat[:4 + i]])) for i, r in enumerate(reqs)]
    segs = [0]
    decode_segment = TE.engine_decode_segment
    monkeypatch.setattr(TE, "engine_decode_segment", lambda *a: (
        segs.__setitem__(0, segs[0] + 1), decode_segment(*a))[1])
    first_at = {}

    def on_chunk(i, wav, fin):
        first_at.setdefault(i, segs[0])
        sizes[i].append(len(wav))

    kw = dict(SYNTH, hop_scale=2.0, max_hop=2 * HOP) if mode == "hop_scale_2" else SYNTH
    sizes = [[] for _ in reqs]
    got = TS.ContinuousSynthesizer(model, **kw).synthesize_batch(reqs, on_chunk=on_chunk)
    assert first_at[0] == first_at[1] == 1
    if mode != "hop_scale_2":
        want = [_sequential(model, r) for r in reqs]
    else:
        assert max(sizes[0][1:-1]) > sizes[0][0], sizes[0]
        want_sizes = [[] for _ in reqs]
        want = TS.ContinuousSynthesizer(model, **kw, batch_chunks=False).synthesize_batch(
            reqs, on_chunk=lambda i, w, f: want_sizes[i].append(len(w)))
        assert sizes == want_sizes
    for i in range(len(reqs)):
        assert got[i].shape == want[i].shape, f"request {i}"
        np.testing.assert_allclose(got[i], want[i], atol=2e-3, rtol=1e-3,
                                   err_msg=f"request {i}")


def test_grouped_vocoders_equal_per_session_loop():
    """mel2wav_stream_group, mel2wav_final_group and mel2wav_group (a mixed
    group with a session twice) against mel2wav called session by session
    with its own generator, within 1e-5: fresh and cached sessions, ragged
    final lengths, each row's noise from its own session."""
    model = _noisy()
    rng = np.random.default_rng(2)
    mel = torch.from_numpy(rng.standard_normal((3, 90, U.N_MEL)).astype(np.float32) * 0.5)
    win = 2 * (HOP + LA)
    grouped = [model.new_session() for _ in range(3)]
    single = [model.new_session() for _ in range(3)]

    def loop(gens, idx, finals):
        return [model.mel2wav(g, single[i], f) for g, i, f in zip(gens, idx, finals)]

    def same(a, b):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.shape == y.shape
            np.testing.assert_allclose(x, y, atol=1e-5, rtol=0)

    starts = [0, 7, 31]
    for step in range(2):       # fresh sessions, then cached ones
        got = model.mel2wav_stream_group(mel, [0, 1, 2], starts, grouped, win_rows=win)
        same(got, loop([mel[i, s:s + win] for i, s in enumerate(starts)], [0, 1, 2],
                       [False] * 3))
        starts = [s + 2 * HOP for s in starts]
    # a mixed group: session 0 twice (a chunk, then its final), session 2 final
    gens = [mel[0, 40:40 + win], mel[0, 60:77], mel[2, 5:25]]
    got = model.mel2wav_group(gens, [grouped[0], grouped[0], grouped[2]], [False, True, True])
    same(got, loop(gens, [0, 0, 2], [False, True, True]))
    got = model.mel2wav_final_group(mel, [1], [3], [45], [grouped[1]])
    same(got, loop([mel[1, 3:48]], [1], [True]))
    fresh = [model.new_session(), model.new_session()]
    single[:2] = [model.new_session(), model.new_session()]
    got = model.mel2wav_final_group(mel, [2, 0], [0, 11], [33, 70], fresh)
    same(got, loop([mel[2, 0:33], mel[0, 11:81]], [0, 1], [True, True]))


def test_incremental_matches_stream_model():
    """incremental=True on the stream family (10-frame estimator chunks, 2
    of left context): each request's audio equals the one-shot stream-masked
    flow on the anchored grid, vocoded with the same chunk windows."""
    model = _noisy("incremental")
    reqs = _requests(TS.TTSRequest)
    got = TS.ContinuousSynthesizer(model, **SYNTH, incremental=True).synthesize_batch(reqs)
    for i, r in enumerate(reqs):
        toks = model.llm_generate(r.text_tokens, 0, r.prompt_speech_tokens, None)
        P = len(r.prompt_speech_tokens)
        seq = np.concatenate([r.prompt_speech_tokens, toks])
        with torch.no_grad():
            gen_mel = model.flow.inference(
                torch.from_numpy(seq[None]).long(), torch.tensor([len(seq)]),
                torch.from_numpy(r.prompt_feat[None]), torch.from_numpy(r.embedding[None]),
                noise=model.flow_noise[:, :2 * len(seq)], streaming=True,
                chunk_anchor=torch.tensor([P]))[0]
        assert gen_mel.shape[0] == 2 * len(toks)
        session, parts, off = model.new_session(), [], 0
        while len(toks) - off >= HOP + LA:
            parts += model.mel2wav_stream_group(gen_mel[None], [0], [2 * off], [session],
                                                win_rows=2 * HOP)
            off += HOP
        parts += model.mel2wav_final_group(gen_mel[None], [0], [2 * off],
                                           [gen_mel.shape[0] - 2 * off], [session])
        want = np.concatenate(parts)
        assert got[i].shape == want.shape
        np.testing.assert_allclose(got[i], want, atol=2e-4, rtol=1e-3, err_msg=f"request {i}")


def test_continuous_refusals():
    """A second device for the flow runs (here the CPU: the flow's view and
    its slot engine sit there, and the incremental audio equals the
    one-device run; tests/test_torch_parallel.py holds the windowed mode);
    the view holds copies, so the caller's model keeps its own flow and
    vocoder; a phoneme request to a model whose LM is not a phoneme LM and a
    prompt longer than a flow slot's cache raise."""
    model = _noisy("incremental")
    flow, hift = model.flow, model.hift
    r = _requests(TS.TTSRequest)[0]
    split = TS.ContinuousSynthesizer(model, **SYNTH, incremental=True, flow_device="cpu")
    assert split._fm.device == torch.device("cpu") and split._fse.device == torch.device("cpu")
    assert model.flow is flow and model.hift is hift
    assert split._fm.flow is not flow and split._fm.hift is not hift
    mine = {p.data_ptr() for p in list(flow.parameters()) + list(hift.parameters())}
    assert mine.isdisjoint(p.data_ptr() for p in list(split._fm.flow.parameters())
                           + list(split._fm.hift.parameters()))
    want = TS.ContinuousSynthesizer(model, **SYNTH, incremental=True).synthesize_batch(
        [r], gen=torch.Generator().manual_seed(1))
    got = split.synthesize_batch([r], gen=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="phoneme"):
        TS.ContinuousSynthesizer(model, **SYNTH).synthesize_batch(
            [dataclasses.replace(r, pho_token=np.zeros((4, 4), np.int32))])
    with pytest.raises(ValueError, match="tok_cap"):
        TS.ContinuousSynthesizer(model, **SYNTH, incremental=True,
                                 flow_tok_cap=4).synthesize_batch([r])


def test_engine_samples_without_a_generator():
    """ServingEngine (and so the continuous server's worker, which passes no
    generator) samples with RAS when no generator is given: it seeds one at
    0, as the JAX engine takes PRNGKey(0), where it used to fail on the first
    sampled token; two runs give the same tokens."""
    from cosyvoice_tpu_torch.models.llm import SamplingConfig
    from cosyvoice_tpu_torch.runtime.engine import GenRequest, ServingEngine

    llm = copy.deepcopy(_models("main")[1].llm)
    llm.cfg = dataclasses.replace(llm.cfg, sampling=SamplingConfig())
    reqs = [GenRequest(text=r.text_tokens, prompt_speech=r.prompt_speech_tokens)
            for r in _requests(TS.TTSRequest)]
    kw = dict(num_slots=2, cache_len=128, max_out=48, segment_steps=HOP, text_bucket=16,
              speech_bucket=8, device="cpu")
    runs = [ServingEngine(llm, **kw).generate(reqs) for _ in range(2)]
    assert sum(len(t) for t in runs[0]) > 0
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


def test_requests_that_emit_no_token():
    """A request whose decode emits no token (every step picks an id that is
    not emitted) gives an empty waveform on the sequential path, one-shot and
    streamed, and through the continuous server in both modes, where the
    vocoder used to fail on a mel of no frames."""
    model = _noisy()
    with torch.no_grad():
        model.llm.llm_decoder.bias[U.SPEECH_VOCAB + 1] = 60.0
    r = _requests(TS.TTSRequest)[0]
    assert len(model.llm_generate(r.text_tokens, 0, r.prompt_speech_tokens, None)) == 0
    for stream in (False, True):
        assert len(np.concatenate([o["tts_speech"] for o in model.tts(
            r.text_tokens, 0, r.prompt_speech_tokens, r.prompt_speech_tokens, r.prompt_feat,
            r.embedding, stream=stream)])) == 0
    for kw in ({}, {"batch_chunks": False}):
        got = TS.ContinuousSynthesizer(model, **SYNTH, **kw).synthesize_batch([r, r])
        assert [len(w) for w in got] == [0, 0]
