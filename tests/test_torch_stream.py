"""Streaming zero-shot synthesis: the port's CosyVoice2.inference_zero_shot
(stream=True) against the JAX package's on a tiny stack, for both estimator
families: the main path's (`stream=False`, fused attention and norm, which
must stay on its fused route while streaming) and the stream family
(`stream=True`, chunk-masked attention with two chunks of left context).
Greedy sampling, pinned CFM noise and a deterministic HiFT: every chunk
within 1e-2 of the JAX chunk (the end-to-end bar of PARITY.md), the same
tokens, the chunk lengths of the JAX package's formula, and as many tokens
as a non-streaming decode.  At 5 tokens/s of flow input the hop is 10
tokens, so an 18-byte text (36 to 48 decode steps; 27 tokens emitted here)
streams a first chunk, at least one middle chunk and a final chunk.  The
other API modes (sft, cross-lingual, instruct2, voice conversion) are held
to the JAX package's the same way, streamed and not."""
import dataclasses
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_util as U
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)
from cosyvoice_tpu.models import conformer as jconf
from cosyvoice_tpu.models import flow as jflow
from cosyvoice_tpu.models import hift as jhift
from cosyvoice_tpu.runtime.api import CosyVoice2 as JCosyVoice2
from cosyvoice_tpu.runtime.frontend import CosyVoiceFrontEnd as JFrontEnd
from cosyvoice_tpu.runtime.model import CosyVoice2Model as JModel
from cosyvoice_tpu.tokenizer.text import ByteTokenizer as JByteTokenizer
from cosyvoice_tpu_torch import convert
from cosyvoice_tpu_torch.models import conformer as tconf
from cosyvoice_tpu_torch.models import flow as tflow
from cosyvoice_tpu_torch.models import hift as thift
from cosyvoice_tpu_torch.runtime.api import CosyVoice2 as TCosyVoice2
from cosyvoice_tpu_torch.runtime.frontend import CosyVoiceFrontEnd as TFrontEnd
from cosyvoice_tpu_torch.runtime.model import CosyVoice2Model as TModel
from cosyvoice_tpu_torch.tokenizer.text import ByteTokenizer as TByteTokenizer

FR = 5                   # flow input frames a second: hop 2 * FR = 10 tokens
HOP, LA, CACHE, HOP_SAMPLES = 2 * FR, 3, 8, 48
MAX_TOKENS = 48
NOISE = np.random.default_rng(9).standard_normal((1, 4000, U.N_MEL)).astype(np.float32)
# the estimator families: (stream, static_chunk_size in mel frames, left_chunks)
FAMILIES = {"main": (False, 50, -1), "stream": (True, 4 * FR, 2)}
ARGS = ("hello world again.", "hi there.",
        (np.sin(np.arange(8000) * 0.05) * 0.3).astype(np.float32))    # 0.5 s at 16 kHz


def _speech_tokens(wav):
    seed = int(np.abs(wav).sum() * 1e3) % (1 << 32)
    return np.random.default_rng(seed).integers(0, U.SPEECH_VOCAB, len(wav) * 25 // 16000)


def _spk_embedding(wav):
    seed = int(np.abs(wav).sum() * 1e3) % (1 << 32)
    return np.random.default_rng(seed + 1).standard_normal(24).astype(np.float32)


FRONTEND = dict(speech_tokenizer=_speech_tokens, spk_embedder=_spk_embedding,
                sample_rate=2304, n_mels=U.N_MEL, mel_n_fft=96, mel_hop=48)


def _flow_configs(family: str):
    stream, chunk, left = FAMILIES[family]
    enc = dict(U.ENC, static_chunk_size=2 * FR)
    est = dict(stream=stream, static_chunk_size=chunk, left_chunks=left)
    common = dict(input_size=64, output_size=U.N_MEL, spk_embed_dim=24,
                  vocab_size=U.SPEECH_VOCAB + 3, input_frame_rate=FR)
    jcfg = jflow.FlowConfig(
        **common, encoder=jconf.ConformerConfig(**enc, dropout_rate=0.0,
                                                attention_dropout_rate=0.0),
        estimator=dataclasses.replace(U.jax_est_config(True), **est),
        cfm=jflow.CFMConfig(noise_frames=4000))
    tcfg = tflow.FlowConfig(
        **common, encoder=tconf.ConformerConfig(**enc),
        estimator=dataclasses.replace(U.torch_est_config(True), **est),
        cfm=tflow.CFMConfig(noise_frames=4000))
    return jcfg, tcfg


@lru_cache(maxsize=None)
def _shared():
    """The LM (greedy), the flow params and the deterministic HiFT, shared by
    both families; flow and HiFT params drawn from their shapes alone."""
    jlm, lm_params, tlm = U.build_lm("none")
    flow_params = U.random_params(
        jflow.CausalMaskedDiffWithXvec(_flow_configs("main")[0]).init, U.KEY,
        jnp.zeros((1, 8), jnp.int32), jnp.asarray([8]), jnp.zeros((1, 4, U.N_MEL)),
        jnp.zeros((1, 24)), method=jflow.CausalMaskedDiffWithXvec.inference, seed=1)
    jh = jhift.HiFTGenerator(jhift.HiFTConfig(**U.HIFT), deterministic=True)
    hift_params = U.random_params(jh.init, {"params": U.KEY, "noise": U.KEY},
                                  jnp.zeros((1, 2, U.N_MEL)), seed=2)
    th = thift.HiFTGenerator(thift.HiFTConfig(**U.HIFT), deterministic=True)
    th.load_state_dict(convert.hift_state_from_jax(hift_params), strict=True)
    return (jlm, lm_params, tlm), flow_params, (jh, hift_params, th.eval())


@lru_cache(maxsize=None)
def _models(family: str):
    """(JAX CosyVoice2Model, port CosyVoice2Model) on one set of weights; the
    families share the LM, the HiFT and the JAX HiFT programs."""
    (jlm, lm_params, tlm), flow_params, (jh, hift_params, th) = _shared()
    jcfg, tcfg = _flow_configs(family)
    tf = tflow.CausalMaskedDiffWithXvec(tcfg)
    tf.load_state_dict(convert.flow_state_from_jax(flow_params), strict=True)
    jm = JModel(llm=jlm, flow=jflow.CausalMaskedDiffWithXvec(jcfg), hift=jh,
                llm_params=lm_params, flow_params=flow_params, hift_params=hift_params,
                max_decode_tokens=MAX_TOKENS, flow_noise=NOISE)
    if family != "main":        # reuse the vocoder programs the main family compiled
        first = _models("main")[0]
        jm._hift_infer, jm._hift_infer_nocache = first._hift_infer, first._hift_infer_nocache
    tm = TModel(llm=tlm, flow=tf, hift=th, max_decode_tokens=MAX_TOKENS,
                flow_noise=torch.from_numpy(NOISE), device="cpu")
    return jm, tm


def _recording(monkeypatch, model, log):
    """Record the generated tokens each token2wav call hands the flow."""
    token2wav = model.token2wav

    def wrapped(tokens, *args, **kw):
        log.append(np.asarray(tokens)[:kw.get("n_tokens")].copy())
        return token2wav(tokens, *args, **kw)
    monkeypatch.setattr(model, "token2wav", wrapped)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_stream_matches_jax(family, monkeypatch):
    U.interpret_pallas(monkeypatch)
    jm, tm = _models(family)
    fused_calls, chunk_calls = [], []
    attention = tflow.dit_attention_packed
    monkeypatch.setattr(tflow, "dit_attention_packed",
                        lambda *a, **k: fused_calls.append(1) or attention(*a, **k))
    flow_chunk = tm._flow_chunk

    def counting_chunk(*a, streaming, **k):
        before = len(fused_calls)
        mel = flow_chunk(*a, streaming=streaming, **k)
        chunk_calls.append((streaming, len(fused_calls) - before))
        return mel
    monkeypatch.setattr(tm, "_flow_chunk", counting_chunk)
    tokens_j, tokens_t = [], []
    _recording(monkeypatch, jm, tokens_j)
    _recording(monkeypatch, tm, tokens_t)
    cv_j = JCosyVoice2(frontend=JFrontEnd(tokenizer=JByteTokenizer(), **FRONTEND), model=jm,
                       sample_rate=2304)
    cv_t = TCosyVoice2(frontend=TFrontEnd(tokenizer=TByteTokenizer(), device="cpu",
                                          **FRONTEND), model=tm, sample_rate=2304)
    wavs_j = [o["tts_speech"] for o in cv_j.inference_zero_shot(
        *ARGS, stream=True, rng=jax.random.PRNGKey(0))]
    wavs_t = [o["tts_speech"] for o in cv_t.inference_zero_shot(
        *ARGS, stream=True, gen=torch.Generator().manual_seed(0))]

    # the same tokens, as many as a non-streaming greedy decode
    assert len(tokens_t) == len(tokens_j) == len(wavs_t) == len(wavs_j) >= 3
    np.testing.assert_array_equal(tokens_t[-1], tokens_j[-1])
    nonstream = []
    generate = tm.llm_generate
    monkeypatch.setattr(tm, "llm_generate",
                        lambda *a: nonstream.append(generate(*a)) or nonstream[-1])
    for _ in cv_t.inference_zero_shot(*ARGS, gen=torch.Generator().manual_seed(0)):
        pass
    np.testing.assert_array_equal(nonstream[0], tokens_t[-1])
    # chunk lengths: the first (less the held-back mel cache), the middle
    # ones, the final (with the mel cache)
    n_tok, k = len(tokens_t[-1]), len(wavs_t) - 1
    want = ([(2 * (HOP + LA) - CACHE) * HOP_SAMPLES] + [2 * (HOP + LA) * HOP_SAMPLES] * (k - 1)
            + [(CACHE + 2 * (n_tok - HOP * k)) * HOP_SAMPLES])
    assert [len(w) for w in wavs_t] == [len(w) for w in wavs_j] == want
    for wt, wj in zip(wavs_t, wavs_j):
        assert np.isfinite(wt).all()
        np.testing.assert_allclose(wt, wj, atol=1e-2)
    # the main family keeps the fused attention while streaming; the stream
    # family leaves it for the chunk mask, and takes it on the final chunk
    stream_fused = [n for streaming, n in chunk_calls[:len(wavs_t)] if streaming]
    final_fused = chunk_calls[len(wavs_t) - 1][1]
    assert len(stream_fused) == len(wavs_t) - 1 and final_fused > 0
    assert all(n > 0 for n in stream_fused) if family == "main" else not any(stream_fused)


def test_flow_window_matches_jax():
    """With flow_context_tokens set, the chunk's dropped tokens and the
    re-indexed noise rows equal the JAX package's for the same counts."""
    (jlm, lm_params, tlm), _, (jh, hift_params, th) = _shared()
    jcfg, tcfg = _flow_configs("main")
    W = 2 * HOP + LA
    jm = JModel(llm=jlm, flow=jflow.CausalMaskedDiffWithXvec(jcfg), hift=jh,
                llm_params=lm_params, flow_params={}, hift_params=hift_params,
                flow_noise=NOISE, flow_context_tokens=W)
    tm = TModel(llm=tlm, flow=tflow.CausalMaskedDiffWithXvec(tcfg), hift=th,
                flow_noise=torch.from_numpy(NOISE), device="cpu", flow_context_tokens=W)
    for n_gen in range(0, 80, 3):
        for offset in range(0, n_gen, HOP):
            drop = tm.flow_window_drop(n_gen, offset)
            assert drop == jm.flow_window_drop(n_gen, offset), (n_gen, offset)
            for pfl in (0, 24):
                need = 2 * (-(-(n_gen + pfl // 2 - drop) // HOP) * HOP)
                np.testing.assert_array_equal(tm.windowed_noise(pfl, drop, need).numpy(),
                                              jm.windowed_noise(pfl, drop, need))
    with pytest.raises(ValueError, match="flow_context_tokens"):
        TModel(llm=tlm, flow=tm.flow, hift=th, device="cpu", flow_context_tokens=HOP)


SPK2INFO = {"speaker": {"embedding": np.random.default_rng(4).standard_normal(24)
                        .astype(np.float32)}}
SOURCE = (np.sin(np.arange(16000) * 0.03) * 0.3).astype(np.float32)  # 1 s: 25 speech tokens
MODES = {"sft": ("hello world again.", "speaker"),
         "cross_lingual": ("hello world again.", ARGS[2]),
         "instruct2": ("hello world again.", "speak slowly.", ARGS[2]),
         "vc": (SOURCE, ARGS[2])}


@pytest.mark.parametrize("stream", [False, True], ids=["oneshot", "stream"])
@pytest.mark.parametrize("mode", list(MODES))
def test_api_modes_match_jax(mode, stream, monkeypatch):
    """inference_sft / _cross_lingual / _instruct2 / _vc of the port against
    the JAX package's on the main family's weights: the tokens each chunk's
    flow gets are equal, every chunk within 1e-2 of the JAX chunk."""
    U.interpret_pallas(monkeypatch)
    jm, tm = _models("main")
    tokens_j, tokens_t = [], []
    _recording(monkeypatch, jm, tokens_j)
    _recording(monkeypatch, tm, tokens_t)
    cv_j = JCosyVoice2(frontend=JFrontEnd(tokenizer=JByteTokenizer(), spk2info=SPK2INFO,
                                          **FRONTEND), model=jm, sample_rate=2304)
    cv_t = TCosyVoice2(frontend=TFrontEnd(tokenizer=TByteTokenizer(), device="cpu",
                                          spk2info=SPK2INFO, **FRONTEND),
                       model=tm, sample_rate=2304)
    kw_j = {} if mode == "vc" else {"rng": jax.random.PRNGKey(0)}
    kw_t = {} if mode == "vc" else {"gen": torch.Generator().manual_seed(0)}
    wavs_j = [o["tts_speech"] for o in getattr(cv_j, f"inference_{mode}")(
        *MODES[mode], stream=stream, **kw_j)]
    wavs_t = [o["tts_speech"] for o in getattr(cv_t, f"inference_{mode}")(
        *MODES[mode], stream=stream, **kw_t)]
    assert cv_t.list_available_spks() == ["speaker"]
    assert len(tokens_t) == len(tokens_j) == len(wavs_t) == len(wavs_j)
    assert len(wavs_t) >= (2 if stream else 1) and len(tokens_t[-1]) > 0
    for tt, tj in zip(tokens_t, tokens_j):
        np.testing.assert_array_equal(tt, tj)
    for wt, wj in zip(wavs_t, wavs_j):
        assert wt.shape == wj.shape and np.isfinite(wt).all()
        np.testing.assert_allclose(wt, wj, atol=1e-2)
