"""The port's modules against their JAX counterparts on the CPU, with the JAX
weights carried over by cosyvoice_tpu_torch.convert and the same numpy
inputs fed to both."""
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
from cosyvoice_tpu.models.qwen2 import causal_prefill_bias as j_causal_bias
from cosyvoice_tpu.ops import mel as jmel
from cosyvoice_tpu.ops import sampling as jsamp
from cosyvoice_tpu.ops import stft as jstft
from cosyvoice_tpu_torch import convert
from cosyvoice_tpu_torch.models import conformer as tconf
from cosyvoice_tpu_torch.models import flow as tflow
from cosyvoice_tpu_torch.models import llm as tllm
from cosyvoice_tpu_torch.models.qwen2 import causal_prefill_bias as t_causal_bias
from cosyvoice_tpu_torch.ops import mel as tmel
from cosyvoice_tpu_torch.ops import sampling as tsamp
from cosyvoice_tpu_torch.ops import stft as tstft


def test_stft_istft_match():
    """1e-4 (the JAX package's own stft bar); same DFT-matmul arithmetic."""
    x = np.random.default_rng(0).standard_normal((2, 640)).astype(np.float32)
    win = jstft.hann_window(16)
    re_j, im_j = jstft.stft(jnp.asarray(x), 16, 4, win)
    re_t, im_t = tstft.stft(torch.from_numpy(x), 16, 4, tstft.hann_window(16))
    np.testing.assert_allclose(re_t.numpy(), np.asarray(re_j), atol=1e-4)
    np.testing.assert_allclose(im_t.numpy(), np.asarray(im_j), atol=1e-4)
    y_j = jstft.istft(re_j, im_j, 16, 4, win)
    y_t = tstft.istft(re_t, im_t, 16, 4, tstft.hann_window(16))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-4)


def test_log_mel_matches():
    """1e-4 in log-mel: the prompt features the flow is conditioned on."""
    y = (np.random.default_rng(1).standard_normal(4800) * 0.1).astype(np.float32)
    want = jmel.log_mel_spectrogram(jnp.asarray(y)[None], n_fft=96, n_mels=16, sr=2304,
                                    hop=48, win=96, fmax=1152.0)
    got = tmel.log_mel_spectrogram(torch.from_numpy(y)[None], n_fft=96, n_mels=16,
                                   sr=2304, hop=48, win=96, fmax=1152.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_nucleus_keep_set_exact():
    """The reference keep rule (mass before i < top_p and i < top_k) is exact."""
    p = np.sort(np.random.default_rng(2).dirichlet(np.ones(50), size=8), axis=-1)[:, ::-1]
    p = np.ascontiguousarray(p, dtype=np.float32)
    want = jsamp.nucleus_mask(jnp.asarray(p), 0.8, 25)
    got = tsamp.nucleus_mask(torch.from_numpy(p), 0.8, 25)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_qwen2_body_hidden_matches():
    """Final-normed hidden states of the Qwen2 body, fp32, 2e-5."""
    jm, params, tm = U.build_lm()
    rng = np.random.default_rng(3)
    B, T = 2, 11
    emb = rng.standard_normal((B, T, 32)).astype(np.float32)
    lens = np.asarray([11, 7])
    pos = np.broadcast_to(np.arange(T)[None], (B, T))
    hj, _ = jax.jit(lambda *a: jm.apply(params, *a, method=jllm.Qwen2LM.forward_hidden))(
        jnp.asarray(emb), jnp.asarray(pos), j_causal_bias(T, T, jnp.asarray(lens), B))
    ht, _ = tm.forward_hidden(torch.from_numpy(emb), torch.from_numpy(pos.copy()),
                              t_causal_bias(T, T, torch.from_numpy(lens), B))
    np.testing.assert_allclose(ht.detach().numpy(), np.asarray(hj), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("quant,fused", [("int8", True), ("none", False)],
                         ids=["int8_fused_cache", "fp_headmajor_cache"])
def test_lm_generate_greedy_tokens_exact(quant, fused):
    """Greedy decode emits the same tokens, token for token.  With
    fused_cache_update the JAX side interprets its decode kernel on the CPU
    and the port runs the kernel's plain version."""
    jm, params, tm = U.build_lm(quant, fused)
    rng = np.random.default_rng(4)
    text = rng.integers(0, 300, (1, 9))
    psp = rng.integers(0, U.SPEECH_VOCAB, (1, 5))
    # text, text_len, prompt speech, its length, min_len, max_len
    inputs = (text, [9], psp, [5], [6], [40])
    cap, cache_len = 40, 128
    out_j, cnt_j = jllm.lm_generate(jm, params, *map(jnp.asarray, inputs),
                                    jax.random.PRNGKey(0), max_steps=cap,
                                    cache_len=cache_len)
    out_t, cnt_t = tllm.lm_generate(tm, *(torch.as_tensor(np.asarray(a)) for a in inputs),
                                    None, max_steps=cap, cache_len=cache_len)
    n = int(cnt_j[0])
    assert int(cnt_t[0]) == n and n >= 6
    np.testing.assert_array_equal(out_t[0, :n].numpy(), np.asarray(out_j)[0, :n])


def test_conformer_encoder_matches():
    """UpsampleConformerEncoder (chunk-masked rel-pos attention, lookahead
    conv, x2 upsample), fp32, 2e-4."""
    jcfg = jconf.ConformerConfig(**U.ENC, dropout_rate=0.0, attention_dropout_rate=0.0)
    jm = jconf.UpsampleConformerEncoder(jcfg, up_blocks=2)
    rng = np.random.default_rng(5)
    xs = rng.standard_normal((2, 12, 64)).astype(np.float32)
    lens = np.asarray([12, 9])
    params = jax.jit(jm.init)(U.KEY, jnp.asarray(xs), jnp.asarray(lens))
    hj, mj = jax.jit(jm.apply)(params, jnp.asarray(xs), jnp.asarray(lens))
    tm = tconf.UpsampleConformerEncoder(tconf.ConformerConfig(**U.ENC), up_blocks=2)
    tm.load_state_dict(convert.encoder_state_from_jax(params), strict=True)
    with torch.no_grad():
        ht, mt = tm(torch.from_numpy(xs), torch.from_numpy(lens))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("fused", [True, False], ids=["serving_fused", "reference_quirk"])
def test_estimator_matches(fused, monkeypatch):
    """ConditionalDecoder, fp32, 2e-4.  Serving config (fused_attention +
    fused_norm + approx_gelu, 2 heads x 64): T=12 is padded to 128 and the
    DiT attention runs the dit_attention path (the JAX Pallas kernel in
    interpret mode, the port's plain version); the other config adds the
    reference's 0/1 float mask as a bias."""
    U.interpret_pallas(monkeypatch)
    rng = np.random.default_rng(6)
    B, T, C = 2, 12, U.N_MEL
    x, mu, cond = (rng.standard_normal((B, T, C)).astype(np.float32) for _ in range(3))
    spks = rng.standard_normal((B, C)).astype(np.float32)
    mask = (np.arange(T)[None] < np.asarray([12, 9])[:, None]).astype(np.float32)
    t = np.asarray([0.3, 0.8], np.float32)
    inputs = (x, mask, mu, t, spks, cond)
    params = jax.jit(jflow.ConditionalDecoder(U.jax_est_config(False)).init)(
        U.KEY, *map(jnp.asarray, inputs))
    want = jax.jit(jflow.ConditionalDecoder(U.jax_est_config(fused)).apply)(
        params, *map(jnp.asarray, inputs))
    tm = tflow.ConditionalDecoder(U.torch_est_config(fused))
    tm.load_state_dict(convert.estimator_state_from_jax(params), strict=True)
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, inputs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)


def test_token_to_mel_matches():
    """CausalMaskedDiffWithXvec.inference (encoder + 10 Euler CFG steps, the
    estimator masking pad keys with a -inf bias) with injected noise, fp32,
    2e-3.  The serving estimator's kernels are covered by test_estimator_matches
    and, end to end, by test_torch_slice.py."""
    jm, params, tm = U.build_flow(fused=False)
    rng = np.random.default_rng(7)
    token = rng.integers(0, U.SPEECH_VOCAB, (1, 14))
    prompt_feat = rng.standard_normal((1, 8, U.N_MEL)).astype(np.float32)
    emb = rng.standard_normal((1, 24)).astype(np.float32)
    noise = rng.standard_normal((1, 28, U.N_MEL)).astype(np.float32)
    want = jax.jit(lambda *a, z: jm.apply(params, *a, noise=z,
                                          method=jflow.CausalMaskedDiffWithXvec.inference))(
        jnp.asarray(token), jnp.asarray([14]), jnp.asarray(prompt_feat), jnp.asarray(emb),
        z=jnp.asarray(noise))
    got = tm.inference(torch.from_numpy(token), torch.tensor([14]),
                       torch.from_numpy(prompt_feat), torch.from_numpy(emb),
                       noise=torch.from_numpy(noise))
    assert got.shape == want.shape == (1, 20, U.N_MEL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=2e-3)


def test_hift_matches():
    """HiFT (deterministic source), fp32, 2e-4 on the waveform and source."""
    jm, params, tm = U.build_hift()
    mel = np.random.default_rng(8).standard_normal((1, 10, U.N_MEL)).astype(np.float32)
    wav_j, s_j = jax.jit(lambda m: jm.apply(params, m, method=jhift.HiFTGenerator.inference))(
        jnp.asarray(mel))
    wav_t, s_t = tm.inference(torch.from_numpy(mel))
    assert wav_t.shape == wav_j.shape == (1, 10 * 48)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=2e-4)
    np.testing.assert_allclose(wav_t.numpy(), np.asarray(wav_j), atol=2e-4)
