"""The phoneme LMs: the port against the JAX package on tiny stacks (the
shapes of tests/test_llm_phoneme.py), weights carried across by convert.py,
inputs drawn with numpy from fixed seeds.  Bars: the factored embedding,
the fusion DecoderLayer, the speaker-adaptive conformer and the decode
prefix of all three Qwen2 variants within 2e-4 in fp32; greedy tokens
exact for phoneme_lm_generate (plain and Src2, ragged rows), the v1
TransformerLMPhoneme (spk_adapt off and on) and the continuous streams;
ServingEngine's staggered phoneme admits equal to phoneme_lm_generate a
request (tests/test_engine.py's bar); streamed chunks within 1e-2 of the
JAX ContinuousSynthesizer's on pinned noise, windowed and incremental;
a reference-named state dict read both ways."""
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
from cosyvoice_tpu.models import llm as jllm
from cosyvoice_tpu.models import llm_phoneme as jpho
from cosyvoice_tpu.models import llm_v1_phoneme as jv1
from cosyvoice_tpu.models.qwen2 import Qwen2Config as JQwen2Config
from cosyvoice_tpu.ops import sampling as jsamp
from cosyvoice_tpu.runtime import engine as JE
from cosyvoice_tpu.runtime import serving as JS
from cosyvoice_tpu.runtime.model import CosyVoice2Model as JModel
from cosyvoice_tpu_torch import convert
from cosyvoice_tpu_torch.models import conformer as tconf
from cosyvoice_tpu_torch.models import flow as tflow
from cosyvoice_tpu_torch.models import hift as thift
from cosyvoice_tpu_torch.models import llm as tllm
from cosyvoice_tpu_torch.models import llm_phoneme as tpho
from cosyvoice_tpu_torch.models import llm_v1_phoneme as tv1
from cosyvoice_tpu_torch.models.qwen2 import Qwen2Config as TQwen2Config
from cosyvoice_tpu_torch.ops import sampling as tsamp
from cosyvoice_tpu_torch.runtime import engine as TE
from cosyvoice_tpu_torch.runtime import serving as TS
from cosyvoice_tpu_torch.runtime.model import CosyVoice2Model as TModel
from cosyvoice_tpu_torch.utils.checkpoint import load_by_name
from test_torch_continuous import _recording_engine

VOCAB, SPK = U.SPEECH_VOCAB, 24
# 12 + 8 + 2 + 2 = 24-wide phoneme embedding
PHO = dict(text_token_size=30, text_token_dim=12, text_tone_size=16, text_tone_dim=8,
           text_lang_size=2, text_lang_dim=2, text_prsd_size=6, text_prsd_dim=2)
ENC = dict(dim=40, heads=4, linear_units=48, num_blocks=1, input_size=24)
VARIANTS = {"plain": (jpho.Qwen2LMPhoneme, tpho.Qwen2LMPhoneme),
            "src": (jpho.Qwen2LMPhonemeSrc, tpho.Qwen2LMPhonemeSrc),
            "src2": (jpho.Qwen2LMPhonemeSrc2, tpho.Qwen2LMPhonemeSrc2)}


def _jenc(**kw):
    return jconf.ConformerConfig(**kw, dropout_rate=0.0, attention_dropout_rate=0.0)


def _cfgs(prsd: bool = True):
    """(JAX PhonemeLMConfig, port PhonemeLMConfig), greedy."""
    common = dict(llm_input_size=32, llm_output_size=32, speech_token_size=VOCAB,
                  spk_embed_dim=SPK, fusion_heads=4, fusion_ffn=48)
    return (jpho.PhonemeLMConfig(
                **common, sampling=jllm.SamplingConfig(method="greedy"),
                phoneme=jpho.PhonemeEmbedConfig(**PHO, use_frontend_prsd=prsd),
                encoder=_jenc(**ENC), qwen=JQwen2Config(**U.QWEN)),
            tpho.PhonemeLMConfig(
                **common, sampling=tllm.SamplingConfig(method="greedy"),
                phoneme=tpho.PhonemeEmbedConfig(**PHO, use_frontend_prsd=prsd),
                encoder=tconf.ConformerConfig(**ENC), qwen=TQwen2Config(**U.QWEN)))


def pho_tokens(rng, n: int) -> np.ndarray:
    return np.stack([rng.integers(0, PHO["text_token_size"], n),
                     rng.integers(0, PHO["text_tone_size"], n),
                     rng.integers(0, PHO["text_lang_size"], n),
                     rng.integers(0, PHO["text_prsd_size"], n)], axis=-1)


@lru_cache(maxsize=None)
def _params(variant: str):
    """Src2's tree drawn from its shapes; Src has the same tree, and the
    plain variant's is it without the fusion layer."""
    if variant != "src2":
        tree = dict(_params("src2")["params"])
        if variant == "plain":
            del tree["src_attention"]
        return {"params": tree}
    return U.random_params(jpho.Qwen2LMPhonemeSrc2(_cfgs()[0]).init, U.KEY,
                           jnp.zeros((1, 4), jnp.int32), jnp.asarray([4]),
                           jnp.zeros((1, 5, 4), jnp.int32), jnp.asarray([5]),
                           jnp.zeros((1, 3), jnp.int32), jnp.asarray([3]),
                           jnp.zeros((1, SPK)), seed=3)


@lru_cache(maxsize=None)
def _lm(variant: str, eos_bias: float = 0.0):
    """(JAX model, JAX params, port model) of one variant; params drawn from
    the shapes alone; eos_bias moves the logits of EOS and the ids past it
    (the streaming stack keeps every decode at its cap with -30)."""
    jcls, tcls = VARIANTS[variant]
    jcfg, tcfg = _cfgs()
    jm = jcls(jcfg)
    params = _params(variant)
    if eos_bias:
        bias = np.array(params["params"]["llm_decoder"]["bias"])
        bias[VOCAB:] += eos_bias
        params = jax.tree_util.tree_map(lambda x: x, params)    # a new tree, same leaves
        params["params"]["llm_decoder"] = dict(params["params"]["llm_decoder"], bias=bias)
    tm = tcls(tcfg)
    tm.load_state_dict(convert.phoneme_lm_state_from_jax(params), strict=True)
    return jm, params, tm.eval()


def _batch(seed: int, lens, Tt: int, Tp: int, Ts: int):
    """Right-padded rows (text, pho, prompt speech lengths per row) in
    buckets of Tt / Tp / Ts, and a speaker vector a row."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    text, pho, psp = (np.zeros((B, Tt), np.int64), np.zeros((B, Tp, 4), np.int64),
                      np.zeros((B, Ts), np.int64))
    for b, (nt, npho, ns) in enumerate(lens):
        text[b, :nt] = rng.integers(0, U.QWEN["vocab_size"], nt)
        pho[b, :npho] = pho_tokens(rng, npho)
        psp[b, :ns] = rng.integers(0, VOCAB, ns)
    emb = rng.standard_normal((B, SPK)).astype(np.float32)
    tl, pl, sl = (np.asarray([x[i] for x in lens]) for i in range(3))
    return text, tl, pho, pl, psp, sl, emb


# ---- modules ----------------------------------------------------------------

@pytest.mark.parametrize("prsd", [True, False], ids=["prsd", "no_prsd"])
def test_phoneme_embedding_matches_jax(prsd):
    jcfg, tcfg = _cfgs(prsd)
    jm = jpho.PhonemeEmbedding(jcfg.phoneme)
    ids = jnp.asarray(pho_tokens(np.random.default_rng(0), 9)[None])
    params = U.random_params(jm.init, U.KEY, ids, seed=1)
    tm = tpho.PhonemeEmbedding(tcfg.phoneme)
    tm.load_state_dict({f"{i}.weight": torch.from_numpy(np.asarray(
        params["params"][f"embed_{i}"]["embedding"])) for i in range(4)}, strict=True)
    want = np.asarray(jm.apply(params, ids))
    got = tm(torch.from_numpy(np.asarray(ids))).detach().numpy()
    assert got.shape == (1, 9, 24) and (np.abs(got[..., -2:]).max() == 0) != prsd
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_decoder_layer_matches_jax():
    """Src2's fusion layer (src_attention.0, weights through convert.py) over
    ragged query and memory rows (key-only masks)."""
    jm, params, tm = _lm("src2")
    rng = np.random.default_rng(1)
    tgt = rng.standard_normal((2, 7, 32)).astype(np.float32)
    mem = rng.standard_normal((2, 5, 32)).astype(np.float32)
    tmask = np.arange(7)[None, None] < np.array([7, 4])[:, None, None]
    mmask = np.arange(5)[None, None] < np.array([3, 5])[:, None, None]
    want = np.asarray(jax.jit(lambda p, *a: jm.apply(
        p, *a, method=lambda m, *b: m.src_attention(*b)))(params, tgt, tmask, mem, mmask))
    with torch.no_grad():
        got = tm.src_attention[0](*(torch.from_numpy(x) for x in (tgt, tmask, mem, mmask)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


def test_spk_adapt_conformer_matches_jax():
    """ConformerConfig.spk_adapt: the raw speaker vector through each layer's
    spk_linear at its entry, eps 1e-5 norms; ragged rows."""
    kw = dict(ENC, num_blocks=2, spk_adapt=True, spk_emb_size=SPK)
    jm = jconf.ConformerEncoder(_jenc(**kw))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 24)).astype(np.float32)
    lens = np.array([6, 4])
    spk = rng.standard_normal((2, SPK)).astype(np.float32) * 3
    params = U.random_params(jm.init, U.KEY, x, lens, spk_emb=spk, seed=4)
    tm = tconf.ConformerEncoder(tconf.ConformerConfig(**kw))
    tm.load_state_dict(convert.conformer_encoder_state_from_jax(params), strict=True)
    want, _ = jax.jit(lambda p, *a: jm.apply(p, *a[:2], spk_emb=a[2]))(params, x, lens, spk)
    got, _ = tm(torch.from_numpy(x), torch.from_numpy(lens), spk_emb=torch.from_numpy(spk))
    valid = np.arange(6)[None] < lens[:, None]
    np.testing.assert_allclose(got.detach().numpy()[valid], np.asarray(want)[valid], atol=2e-4)
    assert tm.encoders[0].norm_mha.eps == 1e-5


# ---- the decode prefix and the decode ------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefix_for_decode_matches_jax(variant):
    """Embeds within 2e-4 and seq_len equal, two ragged rows in padded
    buckets (pad rows of text and phonemes are keys under their lengths,
    and queries that the packing drops)."""
    jm, params, tm = _lm(variant)
    args = _batch(4, [(6, 7, 4), (3, 5, 2)], Tt=8, Tp=8, Ts=5)
    want, want_len = jax.jit(lambda p, *a: jm.apply(p, *a, method=type(jm).prefix_for_decode))(
        params, *args)
    with torch.no_grad():
        got, got_len = tm.prefix_for_decode(*map(torch.as_tensor, args))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("variant", ["plain", "src2"])
def test_phoneme_lm_generate_matches_jax(variant):
    """Greedy tokens exact, two ragged rows (one of them ends at EOS, one at
    its max_len); EOS masked before min_len."""
    jm, params, tm = _lm(variant)
    args = _batch(5, [(6, 9, 4), (4, 5, 2)], Tt=8, Tp=16, Ts=8)
    min_len, max_len, max_steps, cache_len = np.array([3, 0]), np.array([20, 12]), 20, 64
    out, count = jpho.phoneme_lm_generate(
        jm, params, *map(jnp.asarray, args), jnp.asarray(min_len), jnp.asarray(max_len), U.KEY,
        max_steps=max_steps, cache_len=cache_len)
    got, n = tpho.phoneme_lm_generate(tm, *map(torch.as_tensor, args), torch.as_tensor(min_len),
                                      torch.as_tensor(max_len), None, max_steps, cache_len)
    np.testing.assert_array_equal(n.numpy(), np.asarray(count))
    for b in range(2):
        np.testing.assert_array_equal(got[b, :int(n[b])].numpy(),
                                      np.asarray(out[b, :int(count[b])]), err_msg=f"row {b}")
    assert int(count.min()) > 0


def test_non_random_ras_keep_sets_match_jax():
    """The production recipe's sampling (non_random_ras, top_p 0.8, top_k 10,
    win 10): the candidate nucleus and the fallback's expanded one keep what
    the JAX rule keeps over the 6564-way head; the port's draws lie in them."""
    cfg = tpho.PhonemeLMConfig().sampling
    assert (cfg.method, cfg.top_p, cfg.top_k, cfg.win_size) == ("non_random_ras", 0.8, 10, 10)
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((3, 6564)) * 3).astype(np.float32)
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    probs = np.exp(logp)
    order = np.argsort(-probs, axis=-1, kind="stable")
    sorted_p = np.take_along_axis(probs, order, axis=-1)
    sets = {}
    for top_p, top_k in ((cfg.top_p, cfg.top_k), (cfg.top_p + 0.15, cfg.top_k * 2)):
        want = np.asarray(jsamp.nucleus_mask(jnp.asarray(sorted_p), top_p, top_k))
        got = tsamp.nucleus_mask(torch.from_numpy(sorted_p), top_p, top_k).numpy()
        np.testing.assert_array_equal(got, want)
        sets[top_k] = [set(order[b][want[b]]) for b in range(3)]
    gen = torch.Generator().manual_seed(0)
    lp = torch.from_numpy(logp)
    for recent_n in (0, 10):     # the row's arg-max repeated: the fallback draws
        recent = torch.from_numpy(order[:, :1]).expand(3, 10)
        valid = torch.arange(10)[None] < recent_n
        for _ in range(20):
            tok = tllm._sample(cfg, gen, lp, recent, valid)
            keep = sets[20] if recent_n else sets[10]
            assert all(int(t) in keep[b] for b, t in enumerate(tok))


def test_v1_phoneme_generate_matches_jax():
    """TransformerLMPhoneme greedy tokens exact with spk_adapt off and on (on:
    the raw speaker vector reaches the text encoder's layers)."""
    te = dict(dim=32, heads=4, linear_units=48, num_blocks=1, input_size=24,
              static_chunk_size=1)
    body = dict(dim=32, heads=4, linear_units=48, num_blocks=1, input_size=32,
                static_chunk_size=1, input_layer="linear_legacy", activation="relu")
    common = dict(text_encoder_input_size=24, llm_input_size=32, llm_output_size=32,
                  text_token_size=300, speech_token_size=VOCAB, spk_embed_dim=SPK)
    rng = np.random.default_rng(8)
    pho = pho_tokens(rng, 9)[None]
    psp = rng.integers(0, VOCAB, (1, 5))
    emb = (rng.standard_normal((1, SPK)) * 3).astype(np.float32)
    max_steps, cache_len = 30, 64
    for spk_adapt in (False, True):
        jm = jv1.TransformerLMPhoneme(jv1.V1PhonemeLMConfig(
            **common, sampling=jllm.SamplingConfig(method="greedy"), text_encoder=_jenc(**te),
            llm=_jenc(**body), phoneme=jpho.PhonemeEmbedConfig(**PHO), spk_adapt=spk_adapt))
        params = U.random_params(jm.init, U.KEY, jnp.zeros((1, 4, 4), jnp.int32),
                                 jnp.asarray([4]), jnp.zeros((1, 3), jnp.int32),
                                 jnp.asarray([3]), jnp.zeros((1, SPK)), seed=6)
        tm = tv1.TransformerLMPhoneme(tv1.V1PhonemeLMConfig(
            **common, sampling=tllm.SamplingConfig(method="greedy"),
            text_encoder=tconf.ConformerConfig(**te), llm=tconf.ConformerConfig(**body),
            phoneme=tpho.PhonemeEmbedConfig(**PHO), spk_adapt=spk_adapt))
        tm.load_state_dict(convert.v1_phoneme_lm_state_from_jax(params), strict=True)
        assert (tm.text_encoder.encoders[0].spk_linear is not None) == spk_adapt
        out, count = jv1.v1_phoneme_generate(
            jm, params, jnp.asarray(pho), jnp.asarray([9]), jnp.asarray(psp), jnp.asarray([5]),
            jnp.asarray(emb), jnp.asarray([0]), jnp.asarray([max_steps]), U.KEY,
            max_steps=max_steps, cache_len=cache_len)
        got, n = tv1.v1_phoneme_generate(
            tm.eval(), torch.from_numpy(pho), torch.tensor([9]), torch.from_numpy(psp),
            torch.tensor([5]), torch.from_numpy(emb), torch.tensor([max_steps]), None,
            max_steps, cache_len)
        want = np.asarray(out[0, :int(count[0])])
        np.testing.assert_array_equal(got[0, :int(n[0])].numpy(), want,
                                      err_msg=f"spk_adapt={spk_adapt}")
        assert len(want) > 0


# ---- weights ----------------------------------------------------------------

@pytest.mark.parametrize("variant", ["plain", "src2"])
def test_reference_state_dict_both_ways(variant):
    """A seeded state dict under the reference checkpoint's names: the JAX
    package's import_phoneme_lm_torch, then convert.phoneme_lm_state_from_jax,
    gives it back exactly, and load_by_name reads it into the port."""
    _, _, tm = _lm(variant)
    g = torch.Generator().manual_seed(11)
    ref = {k: torch.randn(v.shape, generator=g) for k, v in tm.state_dict().items()}
    params = jpho.import_phoneme_lm_torch({k: v.numpy() for k, v in ref.items()},
                                          _cfgs()[0], variant=variant)
    back = convert.phoneme_lm_state_from_jax(params)
    assert sorted(back) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(back[k].numpy(), ref[k].numpy(), err_msg=k)
    model = VARIANTS[variant][1](_cfgs()[1])
    load_by_name(model, ref, "llm.pt")
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref[k].numpy(), err_msg=k)


# ---- the engine ----------------------------------------------------------

def _generate_one(tm, r, max_steps, cache_len):
    t = lambda x: torch.as_tensor(np.asarray(x))[None]
    out, n = tpho.phoneme_lm_generate(
        tm, t(r.text), torch.tensor([len(r.text)]), t(r.pho_token),
        torch.tensor([len(r.pho_token)]), t(r.prompt_speech),
        torch.tensor([len(r.prompt_speech)]), t(r.embedding), torch.tensor([r.min_len]),
        torch.tensor([r.max_len]), None, max_steps, cache_len)
    return out[0, :int(n[0])].numpy()


def test_engine_staggered_phoneme_admits():
    """Src2 through ServingEngine, 5 requests through 2 slots at three
    phoneme buckets (and two requests of one bucket admitted together):
    each request's tokens equal a B=1 phoneme_lm_generate of it
    (tests/test_engine.py's phoneme test)."""
    _, _, tm = _lm("src2")
    rng = np.random.default_rng(9)
    reqs = [TE.GenRequest(text=rng.integers(0, 300, nt), prompt_speech=rng.integers(0, VOCAB, ns),
                          pho_token=pho_tokens(rng, npho),
                          embedding=rng.standard_normal(SPK).astype(np.float32),
                          min_len=2, max_len=18, new_text_len=npho)
            for nt, npho, ns in ((6, 7, 4), (4, 5, 2), (8, 13, 3), (5, 3, 6), (7, 11, 1))]
    engine = TE.ServingEngine(tm, num_slots=2, cache_len=128, max_out=18, segment_steps=5,
                              text_bucket=4, speech_bucket=8, device="cpu")
    got = engine.generate(reqs)
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(got[i], _generate_one(tm, r, 18, 128),
                                      err_msg=f"request {i}")


def test_mixed_burst_admits(monkeypatch):
    """Phoneme and text requests of one text / speech bucket in one burst:
    the phoneme requests share one batched phoneme prefill, the text
    requests one text prefill (Qwen2LM's prefix on the same body), and each
    request's tokens equal its own B=1 decode."""
    _, _, tm = _lm("src2")
    rng = np.random.default_rng(10)
    mk = lambda pho: TE.GenRequest(
        text=rng.integers(0, 300, 6), prompt_speech=rng.integers(0, VOCAB, 3),
        pho_token=pho_tokens(rng, 7) if pho else None,
        embedding=rng.standard_normal(SPK).astype(np.float32) if pho else None,
        min_len=1, max_len=10)
    reqs = [mk(True), mk(False), mk(True), mk(False)]
    calls = []
    for name in ("engine_admit_many", "engine_admit_many_pho"):
        fn = getattr(TE, name)
        monkeypatch.setattr(TE, name, lambda *a, _n=name, _f=fn, **k: (
            calls.append((_n, len(a[2]))), _f(*a, **k))[1])
    got = TE.ServingEngine(tm, num_slots=4, cache_len=64, max_out=10, text_bucket=8,
                           speech_bucket=8, device="cpu").generate(reqs)
    assert sorted(calls) == [("engine_admit_many", 2), ("engine_admit_many_pho", 2)]
    for i, r in enumerate(reqs):
        if r.pho_token is not None:
            want = _generate_one(tm, r, 10, 64)
        else:
            t = lambda x: torch.as_tensor(np.asarray(x))[None]
            out, n = tllm.lm_generate(tm, t(r.text), torch.tensor([6]), t(r.prompt_speech),
                                      torch.tensor([3]), torch.tensor([1]), torch.tensor([10]),
                                      None, 10, 64)
            want = out[0, :int(n[0])].numpy()
        np.testing.assert_array_equal(got[i], want, err_msg=f"request {i}")


# ---- continuous streaming -------------------------------------------------

FR = 5                      # flow input frames a second: hop 10 tokens
HOP, LA, MAX_OUT = 2 * FR, 3, 20
W = 2 * HOP + LA            # the windowed flow's context
NOISE = np.random.default_rng(9).standard_normal((1, 4000, U.N_MEL)).astype(np.float32)
SYNTH = dict(num_slots=2, cache_len=128, text_bucket=16, speech_bucket=8)


def _flow_configs(incremental: bool):
    """The flow of tests/test_torch_stream.py at 5 frames a second, on the
    plain (unfused) estimator route; incremental: the stream family on
    10-frame chunks with 2 chunks of left context."""
    est = (dict(stream=True, static_chunk_size=HOP, left_chunks=2) if incremental
           else dict(stream=False, static_chunk_size=50, left_chunks=-1))
    common = dict(input_size=64, output_size=U.N_MEL, spk_embed_dim=SPK,
                  vocab_size=VOCAB + 3, input_frame_rate=FR)
    enc = dict(U.ENC, static_chunk_size=2 * FR)
    return (jflow.FlowConfig(**common, encoder=_jenc(**enc),
                             estimator=dataclasses.replace(U.jax_est_config(False), **est),
                             cfm=jflow.CFMConfig(noise_frames=4000)),
            tflow.FlowConfig(**common, encoder=tconf.ConformerConfig(**enc),
                             estimator=dataclasses.replace(U.torch_est_config(False), **est),
                             cfm=tflow.CFMConfig(noise_frames=4000)))


@lru_cache(maxsize=None)
def _flow_hift_params():
    """The flow's params (both families have the same tree) and the HiFT's,
    drawn from their shapes (the flow's from its training forward, which
    traces in a fifth of inference's time and has the same tree)."""
    flow_params = U.random_params(
        jflow.CausalMaskedDiffWithXvec(_flow_configs(False)[0]).init, U.KEY,
        jnp.zeros((1, 8), jnp.int32), jnp.asarray([8]), jnp.zeros((1, 16, U.N_MEL)),
        jnp.asarray([16]), jnp.zeros((1, SPK)), U.KEY, seed=1)
    hift_params = U.random_params(
        jhift.HiFTGenerator(jhift.HiFTConfig(**U.HIFT), deterministic=True).init,
        {"params": U.KEY, "noise": U.KEY}, jnp.zeros((1, 2, U.N_MEL)), seed=2)
    return flow_params, hift_params


@lru_cache(maxsize=None)
def _stacks(incremental: bool):
    """(JAX CosyVoice2Model, port CosyVoice2Model): the Src2 LM biased away
    from EOS (every stream decodes MAX_OUT tokens: one chunk and a final
    one), the flow and a deterministic HiFT on one set of weights."""
    jlm, lm_params, tlm = _lm("src2", -30.0)
    jcfg, tcfg = _flow_configs(incremental)
    flow_params, hift_params = _flow_hift_params()
    jh = jhift.HiFTGenerator(jhift.HiFTConfig(**U.HIFT), deterministic=True)
    tf = tflow.CausalMaskedDiffWithXvec(tcfg)
    tf.load_state_dict(convert.flow_state_from_jax(flow_params), strict=True)
    th = thift.HiFTGenerator(thift.HiFTConfig(**U.HIFT), deterministic=True)
    th.load_state_dict(convert.hift_state_from_jax(hift_params), strict=True)
    window = {} if incremental else dict(flow_context_tokens=W)
    return (JModel(llm=jlm, flow=jflow.CausalMaskedDiffWithXvec(jcfg), hift=jh,
                   llm_params=lm_params, flow_params=flow_params, hift_params=hift_params,
                   max_decode_tokens=MAX_OUT, flow_noise=NOISE, **window),
            TModel(llm=tlm, flow=tf.eval(), hift=th.eval(), max_decode_tokens=MAX_OUT,
                   flow_noise=torch.from_numpy(NOISE), device="cpu", **window))


def _stream_requests(cls):
    """Two phoneme requests of 9 phonemes (so 20 x 9 > MAX_OUT tokens) with
    their own speaker vectors, prompts of 5 tokens."""
    rng = np.random.default_rng(12)
    return [cls(text_tokens=rng.integers(0, 300, 8), prompt_text_len=0,
                prompt_speech_tokens=rng.integers(0, VOCAB, 5),
                prompt_feat=(rng.standard_normal((10, U.N_MEL)) * 0.3).astype(np.float32),
                embedding=rng.standard_normal(SPK).astype(np.float32),
                pho_token=pho_tokens(rng, 9)) for _ in range(2)]


@pytest.mark.parametrize("incremental", [False, True], ids=["windowed", "incremental"])
def test_continuous_phoneme_streams_match_jax(incremental, monkeypatch):
    """ContinuousSynthesizer over the Src2 LM: the tokens each stream's
    engine emits equal the JAX engine's, and every chunk (a streamed one and
    the final one a stream) has the JAX chunk's length and lies within
    1e-2 of it.  Windowed: the port's ragged flush groups against the JAX
    sequential flush (batch_chunks off: its final-group padding is ROADMAP
    Queue 3's); incremental: both FlowSlotEngines."""
    jm, tm = _stacks(incremental)
    mode = dict(incremental=True) if incremental else {}
    tok_j, want = [], [[], []]
    with monkeypatch.context() as mp:
        _recording_engine(mp, JE, tok_j)
        JS.ContinuousSynthesizer(jm, **SYNTH, **mode, batch_chunks=False).synthesize_batch(
            _stream_requests(JS.TTSRequest), rng=jax.random.PRNGKey(0),
            on_chunk=lambda i, wav, fin: want[i].append(np.asarray(wav)))
    tok_t, got = [], [[], []]
    _recording_engine(monkeypatch, TS, tok_t)
    TS.ContinuousSynthesizer(tm, **SYNTH, **mode).synthesize_batch(
        _stream_requests(TS.TTSRequest),
        on_chunk=lambda i, wav, fin: got[i].append(np.asarray(wav)))
    for i in range(2):
        np.testing.assert_array_equal(tok_t[i], tok_j[i], err_msg=f"request {i}")
        assert len(tok_t[i]) == MAX_OUT and len(got[i]) == 2
        assert [len(w) for w in got[i]] == [len(w) for w in want[i]], f"request {i}"
        for k, (g, w) in enumerate(zip(got[i], want[i])):
            assert np.isfinite(g).all()
            np.testing.assert_allclose(g, w, atol=1e-2, err_msg=f"request {i} chunk {k}")
