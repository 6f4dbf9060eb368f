"""The port's batched serving and continuous-batching LM engine against the JAX
package on a tiny stack (the weights of tests/torch_port_util.py carried over
by cosyvoice_tpu_torch.convert), and against the port's own sequential
paths.  Greedy decoding throughout; all inputs come from seeded numpy
generators."""
import numpy as np
import pytest
import torch

import jax

import torch_port_util as U
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)
from cosyvoice_tpu.runtime import engine as JE
from cosyvoice_tpu.runtime import serving as JS
from cosyvoice_tpu.runtime.model import CosyVoice2Model as JModel
from cosyvoice_tpu_torch.models.llm import lm_generate
from cosyvoice_tpu_torch.runtime import engine as TE
from cosyvoice_tpu_torch.runtime import serving as TS
from cosyvoice_tpu_torch.runtime.model import CosyVoice2Model as TModel


def _requests(cls, rng):
    """Three ragged zero-shot requests: text, prompt speech, its mel (2 frames
    a token) and a speaker vector."""
    return [cls(text_tokens=rng.integers(0, 250, n).astype(np.int32), prompt_text_len=0,
                prompt_speech_tokens=rng.integers(0, U.SPEECH_VOCAB, p).astype(np.int32),
                prompt_feat=(rng.standard_normal((2 * p, U.N_MEL)) * 0.3).astype(np.float32),
                embedding=rng.standard_normal(24).astype(np.float32))
            for n, p in [(20, 5), (14, 2), (9, 8)]]


def _recording(module, monkeypatch) -> list:
    """Record every lm_generate result that `module`'s batched synthesizer gets."""
    log, orig = [], module.lm_generate

    def wrapped(*a, **k):
        out, count = orig(*a, **k)
        log.append([np.asarray(out)[i, :int(c)] for i, c in enumerate(np.asarray(count))])
        return out, count

    monkeypatch.setattr(module, "lm_generate", wrapped)
    return log


@pytest.fixture(scope="module")
def stacks():
    """(JAX model, port model) over one set of tiny weights: int8 LM over the
    packed cache, the serving estimator, pinned noise, deterministic HiFT."""
    jlm, lm_params, tlm = U.build_lm("int8", fused=True)
    jflow_m, flow_params, tflow_m = U.build_flow(fused=True)
    jhift_m, hift_params, thift_m = U.build_hift()
    noise = np.random.default_rng(9).standard_normal((1, 4000, U.N_MEL)).astype(np.float32)
    jmodel = JModel(llm=jlm, flow=jflow_m, hift=jhift_m, llm_params=lm_params,
                    flow_params=flow_params, hift_params=hift_params,
                    max_decode_tokens=96, flow_noise=noise)
    tmodel = TModel(llm=tlm, flow=tflow_m, hift=thift_m, max_decode_tokens=96,
                    flow_noise=torch.from_numpy(noise), device="cpu")
    return jmodel, tmodel


def test_batched_synthesizer_matches_jax(stacks, monkeypatch):
    """BatchedSynthesizer (batched LM, one ragged flow call, one HiFT call)
    against the JAX BatchedSynthesizer: greedy tokens exact, waveforms 1e-2
    (the slice's end-to-end bar)."""
    U.interpret_pallas(monkeypatch)
    jmodel, tmodel = stacks
    jlog, tlog = _recording(JS, monkeypatch), _recording(TS, monkeypatch)
    wavs_j = JS.BatchedSynthesizer(jmodel, text_bucket=8, speech_bucket=8).synthesize_batch(
        _requests(JS.TTSRequest, np.random.default_rng(3)), rng=jax.random.PRNGKey(2))
    wavs_t = TS.BatchedSynthesizer(tmodel, text_bucket=8, speech_bucket=8).synthesize_batch(
        _requests(TS.TTSRequest, np.random.default_rng(3)),
        gen=torch.Generator().manual_seed(2))
    assert len(jlog) == len(tlog) == 1 and sum(len(t) for t in tlog[0]) > 0
    for i, (tj, tt, wj, wt) in enumerate(zip(jlog[0], tlog[0], wavs_j, wavs_t)):
        np.testing.assert_array_equal(tt, tj, err_msg=f"request {i}")
        assert wt.shape == wj.shape == (len(tt) * 2 * 48,) and np.isfinite(wt).all()
        np.testing.assert_allclose(wt, wj, atol=1e-2, err_msg=f"request {i}")


def test_batched_synthesizer_matches_sequential(stacks, monkeypatch):
    """The batched path against the port's own sequential path per request
    (llm_generate + token2wav): greedy tokens identical, waveforms within
    atol 2e-3 / rtol 1e-3 (the bar of tests/test_runtime.py for the JAX
    package's batched-vs-sequential check)."""
    _, tmodel = stacks
    tlog = _recording(TS, monkeypatch)
    reqs = _requests(TS.TTSRequest, np.random.default_rng(3))
    wavs = TS.BatchedSynthesizer(tmodel, text_bucket=8, speech_bucket=8).synthesize_batch(
        reqs, gen=torch.Generator().manual_seed(2))
    for i, r in enumerate(reqs):
        toks = tmodel.llm_generate(r.text_tokens, 0, r.prompt_speech_tokens,
                                   torch.Generator().manual_seed(7))
        np.testing.assert_array_equal(tlog[0][i], toks, err_msg=f"request {i}")
        want = tmodel.token2wav(toks, r.prompt_speech_tokens, r.prompt_feat, r.embedding)
        assert wavs[i].shape == want.shape, f"request {i}"
        np.testing.assert_allclose(wavs[i], want, atol=2e-3, rtol=1e-3, err_msg=f"request {i}")


def test_batched_synthesizer_refuses_what_is_not_ported(stacks):
    """A mesh runs (one process: the 1 x 1 mesh, the same wavs as without;
    more ranks: tests/test_torch_parallel.py); a phoneme request raises."""
    from cosyvoice_tpu_torch.parallel.mesh import make_mesh

    _, tmodel = stacks
    reqs = _requests(TS.TTSRequest, np.random.default_rng(3))
    want = TS.BatchedSynthesizer(tmodel, text_bucket=8, speech_bucket=8).synthesize_batch(
        reqs, gen=torch.Generator().manual_seed(2))
    got = TS.BatchedSynthesizer(tmodel, text_bucket=8, speech_bucket=8,
                                mesh=make_mesh()).synthesize_batch(
        reqs, gen=torch.Generator().manual_seed(2))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    r = _requests(TS.TTSRequest, np.random.default_rng(3))[0]
    r.pho_token = np.zeros((4, 4), np.int32)
    with pytest.raises(NotImplementedError, match="phoneme"):
        TS.BatchedSynthesizer(tmodel).synthesize_batch([r])


# (text length, prompt speech length) per request, slots, segment steps; the
# cases of the JAX package's tests/test_engine.py
ENGINE_CASES = {
    # staggered admission and slot reuse
    "4_requests_2_slots": ([(3, 4), (6, 2), (2, 7), (5, 0)], 2, 5),
    # one same-bucket burst, admitted by one batched prefill (the JAX package
    # pads it to 8 rows)
    "burst_of_5": ([(1 + i % 4, 1 + (i * 2) % 4) for i in range(5)], 8, 6),
    # 7 requests through the first case's 2 slots and segments, so the JAX
    # engine reuses that case's compiled segment (tests/test_engine.py takes
    # 3 slots and 8-step segments)
    "more_requests_than_slots": ([(2 + i % 3, i % 4) for i in range(7)], 2, 5),
}


@pytest.mark.parametrize("quant,fused", [("int8", True), ("none", False)],
                         ids=["int8_packed_cache", "fp_headmajor_cache"])
@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_greedy_tokens_match(case, quant, fused, monkeypatch):
    """ServingEngine's greedy tokens equal, request by request, a B=1
    lm_generate of the port and the JAX ServingEngine on the same weights,
    and every request's tokens stream out exactly once to the end.  With the
    packed cache the decode step is the lm_decode_attention kernel's per-row
    pos mode (its plain version here, the JAX kernel in interpret mode)."""
    U.interpret_pallas(monkeypatch)
    lens, slots, seg = ENGINE_CASES[case]
    jm, params, tm = U.build_lm(quant, fused)
    rng = np.random.default_rng(7)
    reqs = [TE.GenRequest(text=rng.integers(0, 300, n).astype(np.int32),
                          prompt_speech=rng.integers(0, U.SPEECH_VOCAB, p).astype(np.int32))
            for n, p in lens]
    kw = dict(num_slots=slots, cache_len=256, max_out=128, segment_steps=seg, text_bucket=4,
              speech_bucket=4)
    admits = {"one": 0, "many": 0}
    for name, key in (("engine_admit", "one"), ("engine_admit_many", "many")):
        orig = getattr(TE, name)
        monkeypatch.setattr(TE, name, lambda *a, _o=orig, _k=key, **k: (
            admits.__setitem__(_k, admits[_k] + 1), _o(*a, **k))[1])
    stream = {i: [] for i in range(len(reqs))}
    fins = {i: 0 for i in range(len(reqs))}

    def on_tokens(i, toks, fin):
        stream[i].extend(toks.tolist())
        fins[i] += fin

    got = TE.ServingEngine(tm, device="cpu", **kw).generate(reqs, on_tokens=on_tokens)
    want_jax = JE.ServingEngine(jm, params, **kw).generate(
        [JE.GenRequest(text=r.text, prompt_speech=r.prompt_speech) for r in reqs],
        rng=jax.random.PRNGKey(0))
    if case == "burst_of_5":
        assert admits == {"one": 0, "many": 1}
    assert all(v == 1 for v in fins.values()) and sum(len(g) for g in got) > 0
    for i, r in enumerate(reqs):
        n = len(r.text)
        t = lambda *a: torch.as_tensor(np.asarray(a))
        out, cnt = lm_generate(tm, t(r.text), t(n), t(r.prompt_speech), t(len(r.prompt_speech)),
                               t(2 * n), t(min(20 * n, 128)), None, max_steps=128,
                               cache_len=256)
        want = out[0, :int(cnt[0])].numpy()
        np.testing.assert_array_equal(got[i], want, err_msg=f"request {i} vs lm_generate")
        np.testing.assert_array_equal(got[i], want_jax[i], err_msg=f"request {i} vs JAX")
        np.testing.assert_array_equal(np.asarray(stream[i]), want)
