"""The port's CosyVoice2 zero-shot path end to end against the JAX package on
a tiny stack: CosyVoice2.inference_zero_shot with greedy decoding, an int8
LM over the packed decode cache, the serving estimator (fused attention +
fused norm), pinned CFM noise and a deterministic HiFT.  Tokens must match
exactly and the waveform within 1e-2 (the end-to-end bar of PARITY.md)."""
import numpy as np
import torch

import jax

import torch_port_util as U
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)
from cosyvoice_tpu.runtime.api import CosyVoice2 as JCosyVoice2
from cosyvoice_tpu.runtime.frontend import CosyVoiceFrontEnd as JFrontEnd
from cosyvoice_tpu.runtime.model import CosyVoice2Model as JModel
from cosyvoice_tpu.tokenizer.text import ByteTokenizer as JByteTokenizer
from cosyvoice_tpu_torch.runtime.api import CosyVoice2 as TCosyVoice2
from cosyvoice_tpu_torch.runtime.frontend import CosyVoiceFrontEnd as TFrontEnd
from cosyvoice_tpu_torch.runtime.model import CosyVoice2Model as TModel
from cosyvoice_tpu_torch.tokenizer.text import ByteTokenizer as TByteTokenizer


def _speech_tokens(wav):
    """Prompt-speech tokenizer stub, seeded from the prompt wav (25 Hz)."""
    seed = int(np.abs(wav).sum() * 1e3) % (1 << 32)
    return np.random.default_rng(seed).integers(0, U.SPEECH_VOCAB, len(wav) * 25 // 16000)


def _spk_embedding(wav):
    seed = int(np.abs(wav).sum() * 1e3) % (1 << 32)
    return np.random.default_rng(seed + 1).standard_normal(24).astype(np.float32)


def _recording(fn, log):
    def wrapped(*args, **kwargs):
        tokens = fn(*args, **kwargs)
        log.append(np.asarray(tokens))
        return tokens
    return wrapped


def test_zero_shot_end_to_end_matches_jax(monkeypatch):
    U.interpret_pallas(monkeypatch)
    jlm, lm_params, tlm = U.build_lm("int8", fused=True)
    jflow_m, flow_params, tflow_m = U.build_flow(fused=True)
    jhift_m, hift_params, thift_m = U.build_hift()
    noise = np.random.default_rng(9).standard_normal((1, 4000, U.N_MEL)).astype(np.float32)
    fe = dict(speech_tokenizer=_speech_tokens, spk_embedder=_spk_embedding,
              sample_rate=2304, n_mels=U.N_MEL, mel_n_fft=96, mel_hop=48)
    jmodel = JModel(llm=jlm, flow=jflow_m, hift=jhift_m, llm_params=lm_params,
                    flow_params=flow_params, hift_params=hift_params,
                    max_decode_tokens=96, flow_noise=noise)
    tmodel = TModel(llm=tlm, flow=tflow_m, hift=thift_m, max_decode_tokens=96,
                    flow_noise=torch.from_numpy(noise), device="cpu")
    tokens_j, tokens_t = [], []
    jmodel.llm_generate = _recording(jmodel.llm_generate, tokens_j)
    tmodel.llm_generate = _recording(tmodel.llm_generate, tokens_t)
    cv_j = JCosyVoice2(frontend=JFrontEnd(tokenizer=JByteTokenizer(), **fe), model=jmodel,
                       sample_rate=2304)
    cv_t = TCosyVoice2(frontend=TFrontEnd(tokenizer=TByteTokenizer(), device="cpu", **fe),
                       model=tmodel, sample_rate=2304)

    prompt = (np.sin(np.arange(8000) * 0.05) * 0.3).astype(np.float32)  # 0.5 s at 16 kHz
    args = ("hello world, this is a test.", "hi there.", prompt)
    wavs_j = [o["tts_speech"] for o in cv_j.inference_zero_shot(
        *args, rng=jax.random.PRNGKey(0))]
    wavs_t = [o["tts_speech"] for o in cv_t.inference_zero_shot(
        *args, gen=torch.Generator().manual_seed(0))]

    assert len(tokens_t) == len(tokens_j) == len(wavs_t) == len(wavs_j) == 1
    np.testing.assert_array_equal(tokens_t[0], tokens_j[0])
    assert len(tokens_t[0]) > 0
    assert wavs_t[0].shape == wavs_j[0].shape == (len(tokens_t[0]) * 2 * 48,)
    assert np.isfinite(wavs_t[0]).all()
    np.testing.assert_allclose(wavs_t[0], wavs_j[0], atol=1e-2)
