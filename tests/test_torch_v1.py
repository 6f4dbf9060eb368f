"""CosyVoice v1 family: the port against the JAX package on tiny stacks, one
JAX stack a module, weights carried across by convert.py, inputs drawn with
numpy from fixed seeds.  Bars (PARITY.md): the generic conformer's full
forward 2e-4; its prefill + one-token decode equal to the full causal
forward 1e-5; the two-level non-causal estimator 3e-4, both in fp32 and on
the kernel route (K2 + K3, unpadded; their plain versions on the CPU); the
v1 flow token->mel with injected noise 2e-3, its flow cache's noise rows
exact; greedy v1 decode token for token; the non_random_ras keep-sets
exact; CosyVoiceV1Model's streamed chunks and every mode of the v1
CosyVoice API, one-shot and streamed, within 1e-2 of the JAX package's on
the same tokens and pinned noise; the tokenizer's ids equal to tiktoken's."""
import base64
import collections
from functools import lru_cache, partial

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
from cosyvoice_tpu.models import llm as jllm
from cosyvoice_tpu.ops import sampling as jsamp
from cosyvoice_tpu.runtime.api import CosyVoice as JCosyVoice
from cosyvoice_tpu.runtime.frontend import CosyVoiceFrontEnd as JFrontEnd
from cosyvoice_tpu.runtime.model import CosyVoiceV1Model as JModel
from cosyvoice_tpu.tokenizer.text import ByteTokenizer as JByteTokenizer
from cosyvoice_tpu_torch import convert
from cosyvoice_tpu_torch.models import conformer as tconf
from cosyvoice_tpu_torch.models import flow as tflow
from cosyvoice_tpu_torch.models import hift as thift
from cosyvoice_tpu_torch.models import llm as tllm
from cosyvoice_tpu_torch.ops import sampling as tsamp
from cosyvoice_tpu_torch.runtime.api import CosyVoice as TCosyVoice
from cosyvoice_tpu_torch.runtime.frontend import CosyVoiceFrontEnd as TFrontEnd
from cosyvoice_tpu_torch.runtime.model import CosyVoiceV1Model as TModel
from cosyvoice_tpu_torch.tokenizer.text import ByteTokenizer as TByteTokenizer
from cosyvoice_tpu_torch.tokenizer.text import WhisperTiktokenTokenizer

N_MEL, VOCAB, SPK = U.N_MEL, U.SPEECH_VOCAB, 24
# 25 tokens/s at 6400 Hz / 256 hop: one mel frame a token, so the stream's
# hop is 50 tokens, its overlap 20 and the regulator's edges 20 frames
FR, SR = 25, 6400
# the API's decode cap: one-shot calls share the flow program of a stream's
# first 70-token window (its hop 50 + overlap 20); a stream is that window and
# a 20-token final chunk (the model test below streams two windows)
CAP = 70
NOISE = np.random.default_rng(9).standard_normal((1, 400, N_MEL)).astype(np.float32)


def _conf(**kw):
    return (jconf.ConformerConfig(**kw, dropout_rate=0.0, attention_dropout_rate=0.0),
            tconf.ConformerConfig(**kw))


# ---- the generic conformer -------------------------------------------------

ENCODERS = {"linear_swish_full": dict(input_layer="linear", activation="swish",
                                      static_chunk_size=0),
            "legacy_relu_causal": dict(input_layer="linear_legacy", activation="relu",
                                       static_chunk_size=1)}


@lru_cache(maxsize=None)
def _encoder(kind: str):
    """(jax model, jax params, port model); the causal one is the v1 LM body
    (TransformerEncoder names)."""
    jcfg, tcfg = _conf(dim=32, heads=4, linear_units=48, num_blocks=2, input_size=24,
                       **ENCODERS[kind])
    jm = jconf.ConformerEncoder(jcfg)
    params = U.random_params(jm.init, U.KEY, jnp.zeros((1, 4, 24)), jnp.asarray([4]))
    body = kind == "legacy_relu_causal"
    tm = tconf.ConformerEncoder(tcfg, transformer_layer=body)
    tm.load_state_dict(convert.conformer_encoder_state_from_jax(params, body), strict=True)
    return jm, params, tm.eval()


@pytest.mark.parametrize("kind", list(ENCODERS))
def test_conformer_forward_matches_jax(kind):
    jm, params, tm = _encoder(kind)
    xs = np.random.default_rng(0).standard_normal((2, 11, 24)).astype(np.float32)
    lens = np.array([11, 7])
    want, jpad = jm.apply(params, jnp.asarray(xs), jnp.asarray(lens))
    with torch.no_grad():
        got, tpad = tm(torch.from_numpy(xs), torch.from_numpy(lens))
    valid = np.asarray(jpad)
    np.testing.assert_array_equal(tpad.numpy(), valid)
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], atol=2e-4)


@pytest.mark.parametrize("split", [1, 6])
def test_prefill_and_decode_equal_causal_forward(split):
    """The v1 LM body's cache path: a causal prefill of `split` rows, then one
    row a step, each output within 1e-5 of the full chunk-1 forward."""
    _, _, tm = _encoder("legacy_relu_causal")
    xs = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 10, 24))
                          .astype(np.float32))
    cache = tconf.ConformerKVCache.create(tm.cfg, 1, 16)
    with torch.no_grad():
        full, _ = tm(xs, torch.tensor([10]))
        out, cache = tm.prefill(xs[:, :split], cache)
        outs = [out]
        for t in range(split, 10):
            out, cache = tm.decode_step(xs[:, t:t + 1], cache)
            outs.append(out)
    assert cache.pos == 10 and len(cache.tables) == tm.cfg.num_blocks
    torch.testing.assert_close(torch.cat(outs, dim=1), full, atol=1e-5, rtol=0)


# ---- the two-level non-causal estimator -------------------------------------

EST = dict(in_channels=4 * N_MEL, out_channels=N_MEL, causal=False, channels=(16, 16),
           n_blocks=1, num_mid_blocks=1, num_heads=2, attention_head_dim=8)


@lru_cache(maxsize=None)
def _estimator():
    jm = jflow.ConditionalDecoder(jflow.EstimatorConfig(**EST))
    z = jnp.zeros((2, 8, N_MEL))
    params = U.random_params(jm.init, U.KEY, z, jnp.ones((2, 8)), z, jnp.zeros(2),
                             jnp.zeros((2, N_MEL)), z)
    return jm, params


@pytest.mark.parametrize("route", ["fp32", "kernels"])
def test_estimator_matches_jax(route, monkeypatch):
    """JAX's default v1 estimator (every fused flag off, the reference's 0/1
    mask over an all-ones mel mask) against the port's, plain or on its
    kernel route (K2 over each level's own lengths, K3 in the DiT blocks, no
    pad; plain versions here) at an odd T, so the mid level has 7 rows."""
    jm, params = _estimator()
    fused = route == "kernels"
    tm = tflow.ConditionalDecoder(tflow.EstimatorConfig(**EST, fused_attention=fused,
                                                        fused_norm=fused)).eval()
    tm.load_state_dict(convert.estimator_state_from_jax(params, causal=False), strict=True)
    calls = []
    attention = tflow.dit_attention_packed
    monkeypatch.setattr(tflow, "dit_attention_packed",
                        lambda qkv, lens, *a: calls.append((qkv.shape[1], lens.tolist()))
                        or attention(qkv, lens, *a))
    rng = np.random.default_rng(2)
    B, T = 2, 13
    x, mu, cond = (rng.standard_normal((B, T, N_MEL)).astype(np.float32) for _ in range(3))
    args = (x, np.ones((B, T), np.float32), mu, np.array([0.3, 0.8], np.float32),
            rng.standard_normal((B, N_MEL)).astype(np.float32), cond)
    want = np.asarray(jax.jit(jm.apply)(params, *map(jnp.asarray, args)))
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, atol=3e-4)
    # one K2 call a DiT block, each at its level's rows and lengths
    want_calls = [(13, [13, 13]), (7, [7, 7]), (7, [7, 7]), (7, [7, 7]), (13, [13, 13])]
    assert calls == (want_calls if fused else [])


# ---- the v1 flow ----------------------------------------------------------

def _flow_cfgs():
    enc = dict(dim=48, heads=4, linear_units=48, num_blocks=1, input_size=48)
    jenc, tenc = _conf(**enc)
    common = dict(input_size=48, output_size=N_MEL, spk_embed_dim=SPK, vocab_size=VOCAB,
                  input_frame_rate=FR, regulator_stages=1)
    return (jflow.FlowV1Config(**common, encoder=jenc, estimator=jflow.EstimatorConfig(**EST)),
            tflow.FlowV1Config(**common, encoder=tenc, estimator=tflow.EstimatorConfig(**EST)))


@lru_cache(maxsize=None)
def _flow():
    jcfg, tcfg = _flow_cfgs()
    jm = jflow.MaskedDiffWithXvec(jcfg)
    params = U.random_params(jm.init, U.KEY, jnp.zeros((1, 8), jnp.int32), jnp.asarray([8]),
                             jnp.zeros((1, 4, N_MEL)), jnp.zeros((1, SPK)), U.KEY,
                             prompt_token_len=4, mel_len2=4, n_timesteps=1,
                             method=jflow.MaskedDiffWithXvec.inference, seed=3)
    tm = tflow.MaskedDiffWithXvec(tcfg)
    tm.load_state_dict(convert.flow_v1_state_from_jax(params), strict=True)
    return jm, params, tm.eval()


def test_flow_matches_jax():
    """Two chained calls of 12 prompt and 70 generated tokens (the second
    pinned by the first's flow cache; the generated part takes the
    regulator's 20-token edges) through the JAX model's flow program, which
    the streaming tests below reuse: mel within 2e-3, the caches' noise rows
    exact and their mu rows within 2e-3."""
    jm, tm = _models()
    rng = np.random.default_rng(4)
    P, n_prompt, n_gen = 12, 12, 70
    feat = rng.standard_normal((1, P, N_MEL)).astype(np.float32)
    emb = rng.standard_normal((1, SPK)).astype(np.float32)
    caches_j = caches_t = None
    for call in range(2):
        tok = rng.integers(0, VOCAB, (1, n_prompt + n_gen)).astype(np.int32)
        kw = dict(prompt_token_len=n_prompt, mel_len2=n_gen)
        mel_j, caches_j = jm._flow_infer(
            jm.flow_params, jnp.asarray(tok), jnp.asarray([tok.shape[1]]), jnp.asarray(feat),
            jnp.asarray(emb), U.KEY, flow_cache=caches_j or (jnp.zeros((1, 0, N_MEL)),) * 2,
            has_cache=caches_j is not None, **kw)
        mel_t, caches_t = tm.flow.inference(
            torch.from_numpy(tok).long(), torch.tensor([tok.shape[1]]), torch.from_numpy(feat),
            torch.from_numpy(emb), tm.flow_noise(None, P + n_gen), flow_cache=caches_t,
            sample_rate=SR, **kw)
        assert mel_t.shape == (1, n_gen, N_MEL)
        np.testing.assert_allclose(mel_t.numpy(), np.asarray(mel_j), atol=2e-3)
        np.testing.assert_array_equal(caches_t[0].numpy(), np.asarray(caches_j[0]))
        np.testing.assert_allclose(caches_t[1].numpy(), np.asarray(caches_j[1]), atol=2e-3)
    assert caches_t[0].shape == (1, P + 34, N_MEL)
    np.testing.assert_array_equal(caches_t[0][0, P:].numpy(), NOISE[0, P + n_gen - 34:P + n_gen])


def test_interpolate_regulator_forward_matches_jax():
    _, params, tm = _flow()
    reg = jflow.InterpolateRegulator(N_MEL, 1)
    x = np.random.default_rng(5).standard_normal((2, 9, N_MEL)).astype(np.float32)
    lens = np.array([20, 14])
    want = jax.jit(reg.apply, static_argnums=3)(
        {"params": params["params"]["length_regulator"]}, jnp.asarray(x), jnp.asarray(lens), 20)
    with torch.no_grad():
        got = tm.length_regulator(torch.from_numpy(x), torch.from_numpy(lens), 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


# ---- the LM ---------------------------------------------------------------

def _lm_cfgs(sampling):
    te = dict(dim=32, heads=4, linear_units=48, num_blocks=1, input_size=24,
              static_chunk_size=1)
    body = dict(dim=32, heads=4, linear_units=48, num_blocks=2, input_size=32,
                static_chunk_size=1, input_layer="linear_legacy", activation="relu")
    (jte, tte), (jbody, tbody) = _conf(**te), _conf(**body)
    common = dict(text_encoder_input_size=24, llm_input_size=32, llm_output_size=32,
                  text_token_size=300, speech_token_size=VOCAB, spk_embed_dim=SPK)
    return (jllm.TransformerLMConfig(**common, sampling=jllm.SamplingConfig(**sampling),
                                     text_encoder=jte, llm=jbody),
            tllm.TransformerLMConfig(**common, sampling=tllm.SamplingConfig(**sampling),
                                     text_encoder=tte, llm=tbody))


@lru_cache(maxsize=None)
def _lm(eos_bias: float = 0.0):
    """(jax model, jax params, port model), greedy; eos_bias moves the EOS
    logit (the streaming stacks keep their decodes at the cap)."""
    jcfg, tcfg = _lm_cfgs(dict(method="greedy"))
    jm = jllm.TransformerLM(jcfg)
    params = U.random_params(jm.init, U.KEY, jnp.zeros((1, 4), jnp.int32), jnp.asarray([4]),
                             jnp.zeros((1, 3), jnp.int32), jnp.asarray([3]),
                             jnp.zeros((1, SPK)), seed=5)
    if eos_bias:
        bias = np.array(params["params"]["llm_decoder"]["bias"])
        bias[VOCAB] += eos_bias
        params["params"]["llm_decoder"]["bias"] = bias
    tm = tllm.TransformerLM(tcfg)
    tm.load_state_dict(convert.transformer_lm_state_from_jax(params), strict=True)
    return jm, params, tm.eval()


@pytest.mark.parametrize("spk", [True, False], ids=["speaker", "no_speaker"])
def test_lm_greedy_matches_jax(spk):
    """Greedy v1 decode token for token (EOS is sampled on these weights),
    and the streamed decode's chunks equal the one-shot decode."""
    jm, params, tm = _lm()
    rng = np.random.default_rng(6)
    text = rng.integers(0, 300, (1, 9))
    psp = rng.integers(0, VOCAB, (1, 5))
    emb = rng.standard_normal((1, SPK)).astype(np.float32)
    max_steps, cache_len = 40, 64
    out, count = jllm.lm_generate_v1(jm, params, jnp.asarray(text), jnp.asarray([9]),
                                     jnp.asarray(psp), jnp.asarray([5]), jnp.asarray(emb),
                                     jnp.asarray([0]), jnp.asarray([max_steps]), U.KEY,
                                     max_steps=max_steps, cache_len=cache_len, has_spk=spk)
    want = np.asarray(out[0, :int(count[0])])
    args = (torch.from_numpy(text), torch.tensor([9]), torch.from_numpy(psp), torch.tensor([5]),
            torch.from_numpy(emb) if spk else None, torch.tensor([max_steps]), None)
    got, n = tllm.lm_generate_v1(tm, *args, max_steps=max_steps, cache_len=cache_len)
    np.testing.assert_array_equal(got[0, :int(n[0])].numpy(), want)
    assert 0 < len(want) < max_steps       # it stopped at EOS
    stream = tllm.lm_prefill_stream_v1(tm, *args, max_steps=max_steps, cache_len=cache_len)
    while not bool(stream.gen.done.all()):
        tllm.lm_decode_chunk_v1(tm, stream, 7)
    np.testing.assert_array_equal(stream.gen.out[0, :int(stream.gen.count[0])].numpy(), want)


def test_non_random_ras_keep_sets():
    """The candidate nucleus (top_p, top_k) and the fallback's expanded one
    (top_p + 0.15, top_k * expand_scale) keep what the JAX rule keeps; every
    draw lies in its set, and a token repeated past win_size * tau_r takes
    the fallback."""
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((4, 64)) * 2).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    order = np.argsort(-probs, axis=-1, kind="stable")
    sorted_p = np.take_along_axis(probs, order, axis=-1)
    for top_p, top_k in ((0.8, 10), (0.95, 20)):
        want = np.asarray(jsamp.nucleus_mask(jnp.asarray(sorted_p), top_p, top_k))
        got = tsamp.nucleus_mask(torch.from_numpy(sorted_p), top_p, top_k).numpy()
        np.testing.assert_array_equal(got, want)
    keep = lambda p, k: [set(order[b][np.asarray(jsamp.nucleus_mask(
        jnp.asarray(sorted_p[b]), p, k))]) for b in range(4)]
    narrow, wide = keep(0.8, 10), keep(0.95, 20)
    gen = torch.Generator().manual_seed(0)
    lt = torch.from_numpy(logits)
    no_recent = torch.zeros((4, 50), dtype=torch.long)
    for _ in range(20):
        tok = tsamp.non_random_ras_sample(gen, lt, no_recent, torch.zeros((4, 50), dtype=bool),
                                          0.8, 10, 50, 0.1, 2)
        assert all(int(t) in narrow[b] for b, t in enumerate(tok))
    # every row's arg-max repeated 5 times in the window: the fallback draws
    top = torch.from_numpy(order[:, :1]).expand(4, 50)
    seen = set()
    for _ in range(40):
        tok = tsamp.non_random_ras_sample(gen, lt, top, torch.arange(50)[None] < 5,
                                          0.8, 10, 50, 0.1, 2)
        assert all(int(t) in wide[b] for b, t in enumerate(tok))
        seen |= {(b, int(t)) for b, t in enumerate(tok) if int(t) not in narrow[b]}
    assert seen, "the expanded nucleus was never drawn from"


# ---- CosyVoiceV1Model and the CosyVoice API ------------------------------

def _speech_tokens(wav):
    seed = int(np.abs(wav).sum() * 1e3) % (1 << 32)
    return np.random.default_rng(seed).integers(0, VOCAB, len(wav) * 25 // 16000)


def _spk_embedding(wav):
    seed = int(np.abs(wav).sum() * 1e3) % (1 << 32)
    return np.random.default_rng(seed + 1).standard_normal(SPK).astype(np.float32)


PROMPT = (np.sin(np.arange(8000) * 0.05) * 0.3).astype(np.float32)        # 0.5 s at 16 kHz
SOURCE = (np.sin(np.arange(16000 * CAP // 25) * 0.07) * 0.3).astype(np.float32)
SPK_VEC = np.random.default_rng(8).standard_normal(SPK).astype(np.float32)
FRONTEND = dict(speech_tokenizer=_speech_tokens, spk_embedder=_spk_embedding,
                sample_rate=SR, n_mels=N_MEL, mel_n_fft=512, mel_hop=256,
                spk2info={"spk": {"embedding": SPK_VEC}})


@lru_cache(maxsize=None)
def _models():
    """(JAX CosyVoiceV1Model, port CosyVoiceV1Model) on one set of weights,
    both flows given NOISE's rows and both HiFTs deterministic; the LM's EOS
    logit is lowered by 30 so every decode runs to the cap."""
    jlm, lm_params, tlm = _lm(-30.0)
    jf, flow_params, tf = _flow()
    hift_cfg = dict(U.HIFT, sampling_rate=SR)
    jh = jhift.HiFTGenerator(jhift.HiFTConfig(**hift_cfg), deterministic=True)
    hift_params = U.random_params(jh.init, {"params": U.KEY, "noise": U.KEY},
                                  jnp.zeros((1, 2, N_MEL)), seed=6)
    th = thift.HiFTGenerator(thift.HiFTConfig(**hift_cfg), deterministic=True)
    th.load_state_dict(convert.hift_state_from_jax(hift_params), strict=True)
    jm = JModel(llm=jlm, flow=jf, hift=jh, llm_params=lm_params, flow_params=flow_params,
                hift_params=hift_params, sample_rate=SR, max_decode_tokens=CAP)

    @partial(jax.jit, static_argnames=("prompt_token_len", "mel_len2", "has_cache"))
    def flow_infer(params, token, token_len, prompt_feat, embedding, rng, prompt_token_len,
                   mel_len2, flow_cache, has_cache):
        noise = jnp.asarray(NOISE[:, :prompt_feat.shape[1] + mel_len2])
        return jf.apply(params, token, token_len, prompt_feat, embedding, rng,
                        prompt_token_len=prompt_token_len, mel_len2=mel_len2, noise=noise,
                        flow_cache=flow_cache if has_cache else None, sample_rate=SR,
                        method=jflow.MaskedDiffWithXvec.inference)
    jm._flow_infer = flow_infer
    tm = TModel(llm=tlm, flow=tf, hift=th.eval(), sample_rate=SR, max_decode_tokens=CAP,
                device="cpu")
    tm.flow_noise = lambda session, frames: torch.from_numpy(NOISE[:, :frames])
    return jm, tm


def test_model_attributes_match_jax():
    jm, tm = _models()
    for name in ("token_min_hop_len", "token_max_hop_len", "token_overlap_len",
                 "mel_overlap_len", "mel_cache_len", "hop_samples", "source_cache_len"):
        assert getattr(tm, name) == getattr(jm, name), name
    assert tm.decode_cap(3) == jm.decode_cap(3) and tm.decode_cap(50) == jm.decode_cap(50)


def _assert_chunks_close(got, want):
    assert [len(w) for w in got] == [len(w) for w in want]
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=1e-2)


def test_model_stream_chunks_match_jax():
    """token2wav driven over a fixed 128-token stream (hop 50, overlap 20:
    two windows, then a 28-token final chunk) with a 12-token prompt: the
    flow cache, the mel fade and the HiFT caches; then a one-shot call of
    the first 70 tokens at speed 1.4 (70 -> 50 mel frames)."""
    jm, tm = _models()
    rng = np.random.default_rng(10)
    tokens = rng.integers(0, VOCAB, 128)
    fpt = rng.integers(0, VOCAB, 12)
    feat = rng.standard_normal((12, N_MEL)).astype(np.float32)
    emb = rng.standard_normal(SPK).astype(np.float32)
    out = {}
    for name, m, session in (("jax", jm, {"hift": None, "mel_overlap": None,
                                          "flow_cache": None}),
                             ("port", tm, tm.new_session())):
        wavs, rest, hop = [], list(tokens), m.token_min_hop_len
        while len(rest) >= hop + m.token_overlap_len:
            wavs.append(m.token2wav(np.asarray(rest[:hop + m.token_overlap_len]), fpt, feat,
                                    emb, session, finalize=False))
            rest = rest[hop:]
        wavs.append(m.token2wav(np.asarray(rest), fpt, feat, emb, session, finalize=True))
        wavs.append(m.token2wav(tokens[:70], fpt, feat, emb,
                                {"hift": None, "mel_overlap": None, "flow_cache": None}
                                if name == "jax" else None, finalize=True, speed=1.4))
        out[name] = wavs
    assert len(out["port"]) == 4 and len(out["port"][-1]) == 50 * tm.hop_samples
    _assert_chunks_close(out["port"], out["jax"])


MODES = ["sft", "zero_shot", "cross_lingual", "instruct", "vc"]
TEXT = "hello there."           # 12 bytes: a 128-token cap


def _call(cv, mode: str, stream: bool, **kw):
    args = {"sft": (TEXT, "spk"), "zero_shot": (TEXT, "hi.", PROMPT),
            "cross_lingual": (TEXT, PROMPT), "instruct": (TEXT, "spk", "calm"),
            "vc": (SOURCE, PROMPT)}[mode]
    fn = getattr(cv, f"inference_{mode}")
    if mode == "vc":
        kw = {}
    return [o["tts_speech"] for o in fn(*args, stream=stream, **kw)]


@pytest.mark.parametrize("stream", [False, True], ids=["one_shot", "stream"])
@pytest.mark.parametrize("mode", MODES)
def test_api_modes_match_jax(mode, stream):
    jm, tm = _models()
    cv_j = JCosyVoice(frontend=JFrontEnd(tokenizer=JByteTokenizer(), **FRONTEND), model=jm,
                      sample_rate=SR)
    cv_t = TCosyVoice(frontend=TFrontEnd(tokenizer=TByteTokenizer(), device="cpu",
                                         **FRONTEND), model=tm, sample_rate=SR)
    want = _call(cv_j, mode, stream, rng=U.KEY)
    got = _call(cv_t, mode, stream, gen=torch.Generator().manual_seed(0))
    # CAP tokens of one frame each: one streamed window and a final chunk
    assert len(got) == (2 if stream else 1)
    assert sum(map(len, got)) == CAP * tm.hop_samples
    _assert_chunks_close(got, want)


# ---- the tokenizer ---------------------------------------------------------

CORPUS = ["hello world this is a test", "the quick brown fox", "Héllo café naïve résumé",
          "你好世界，今天天气很好。", "数字 12345 和 3.14", "I'm you're they've we'll it's don't"]


def _ranks_file(path) -> str:
    """A byte-level BPE ranks file in tiktoken's format: the 256 bytes, then
    merges learned greedily on CORPUS's words (300 ranks)."""
    ranks = {bytes([b]): b for b in range(256)}
    seqs = [[bytes([c]) for c in w.encode()] for t in CORPUS for w in t.split(" ")]
    while len(ranks) < 300:
        pairs = collections.Counter(a + b for s in seqs for a, b in zip(s, s[1:]))
        if not pairs:
            break
        tok = pairs.most_common(1)[0][0]
        ranks[tok] = len(ranks)
        merged = []
        for s in seqs:
            out, i = [], 0
            while i < len(s):
                if i + 1 < len(s) and s[i] + s[i + 1] == tok:
                    out.append(tok)
                    i += 2
                else:
                    out.append(s[i])
                    i += 1
            merged.append(out)
        seqs = merged
    path.write_text("".join(f"{base64.b64encode(t).decode()} {r}\n" for t, r in ranks.items()))
    return str(path)


def test_whisper_tokenizer_matches_tiktoken(tmp_path):
    from cosyvoice_tpu.tokenizer.text import WhisperTiktokenTokenizer as JTokenizer

    path = _ranks_file(tmp_path / "v1.tiktoken")
    want_tok, got_tok = JTokenizer(path), WhisperTiktokenTokenizer(path)
    rng = np.random.default_rng(11)
    alphabet = (list("abcxyz  \n\t'sdéü你好12.,!?<|>")
                + ["<|endofprompt|>", "<|lang3|>", "<|0.02|>", "<|en|>", "'ll", "'S",
                   "<endofprompt>"])
    texts = CORPUS + ["<|endofprompt|>hi", "a<|endoftext|><|notimestamps|>b",
                      "<|bad|> <|lang99|>", "<|x<|lang3|>|>", "   \n\n x", "", "<|", "|>",
                      "calm<endofprompt>"]
    texts += ["".join(rng.choice(alphabet, rng.integers(0, 30))) for _ in range(200)]
    for text in texts:
        ids = got_tok.encode(text)
        assert ids == want_tok.encode(text), text
        assert got_tok.decode(ids) == want_tok.decode(ids), text
    assert got_tok.n_vocab == want_tok.encoding.n_vocab
