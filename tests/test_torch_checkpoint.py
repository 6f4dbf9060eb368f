"""`from_pretrained` over a released-format model directory: the port's
(device="cpu") against the JAX package's on the same files, and the
command-line server and offline inference over it.

The directory is built here without the torch reference: seeded JAX
parameter trees for the LM, flow and HiFT, turned into reference-named
state_dicts by the port's convert.py (llm.pt with a tied lm_head that both
loaders ignore, hift.pt under `generator.`), a seeded port CAMPPlus with
perturbed BatchNorm statistics as campplus.onnx, JAX S3 variables through
the JAX `s3tokenizer_state_dict` as speech_tokenizer_v2.onnx, spk2info.pt
and a byte-level BPE tokenizer.json trained with `tokenizers`.  The LM's
head is biased away from its stop ids, so each decode runs to the 30-token
cap (three streamed chunks at a hop of 10 tokens); greedy sampling and a
deterministic HiFT on both sides (as tests/test_torch_stream.py holds the
API modes), so every chunk is held to the JAX chunk at 1e-2."""
import functools
import json
import shutil
import threading
import wave

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_port_util as U
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)
from cosyvoice_tpu.models import campplus as jcamp
from cosyvoice_tpu.models import conformer as jconf
from cosyvoice_tpu.models import flow as jflow
from cosyvoice_tpu.models import hift as jhift
from cosyvoice_tpu.models import llm as jllm
from cosyvoice_tpu.models import s3tokenizer as js3
from cosyvoice_tpu.models.qwen2 import Qwen2Config as JQwen2Config
from cosyvoice_tpu.runtime import api as japi
from cosyvoice_tpu.utils.npz_io import save_params_npz
from cosyvoice_tpu.utils.quant import quantize_qwen_int8 as jquantize_int8
from cosyvoice_tpu_torch import convert
from cosyvoice_tpu_torch.models import campplus as tcamp
from cosyvoice_tpu_torch.models import conformer as tconf
from cosyvoice_tpu_torch.models import flow as tflow
from cosyvoice_tpu_torch.models import hift as thift
from cosyvoice_tpu_torch.models import llm as tllm
from cosyvoice_tpu_torch.models import s3tokenizer as ts3
from cosyvoice_tpu_torch.models.qwen2 import Qwen2Config as TQwen2Config
from cosyvoice_tpu_torch.runtime import api as tapi
from cosyvoice_tpu_torch.utils import onnx_io as tonnx

FR = 5                        # flow input frames a second: a hop of 10 tokens
MAX_TOKENS = 30
SPK_DIM = 24
QWEN = dict(U.QWEN, vocab_size=512)            # covers the tokenizer's ~420 ids
LM = dict(llm_input_size=32, llm_output_size=32, speech_token_size=U.SPEECH_VOCAB)
ENC = dict(U.ENC, static_chunk_size=2 * FR)
EST = dict(in_channels=320, out_channels=80, n_blocks=1, num_mid_blocks=1, num_heads=2,
           attention_head_dim=64)
FLOW = dict(input_size=64, output_size=80, spk_embed_dim=SPK_DIM,
            vocab_size=U.SPEECH_VOCAB + 3, input_frame_rate=FR)
HIFT = dict(U.HIFT, in_channels=80, sampling_rate=24000)

JCFG = dict(lm_cfg=jllm.LMConfig(**LM, qwen=JQwen2Config(**QWEN),
                                 sampling=jllm.SamplingConfig(method="greedy")),
            flow_cfg=jflow.FlowConfig(**FLOW, encoder=jconf.ConformerConfig(
                **ENC, dropout_rate=0.0, attention_dropout_rate=0.0),
                estimator=jflow.EstimatorConfig(**EST, causal=True, channels=(32,)),
                cfm=jflow.CFMConfig(noise_frames=4000)),
            hift_cfg=jhift.HiFTConfig(**HIFT), campplus_cfg=jcamp.CAMPPlusConfig(**U.CAMP),
            s3_cfg=js3.S3Config(**U.S3))
TCFG = dict(lm_cfg=tllm.LMConfig(**LM, qwen=TQwen2Config(**QWEN),
                                 sampling=tllm.SamplingConfig(method="greedy")),
            flow_cfg=tflow.FlowConfig(**FLOW, encoder=tconf.ConformerConfig(**ENC),
                                      estimator=tflow.EstimatorConfig(**EST, causal=True,
                                                                      channels=(32,)),
                                      cfm=tflow.CFMConfig(noise_frames=4000)),
            hift_cfg=thift.HiFTConfig(**HIFT), campplus_cfg=tcamp.CAMPPlusConfig(**U.CAMP),
            s3_cfg=ts3.S3Config(**U.S3))

PROMPT = U.prompt_wav(0.9)
SOURCE = U.prompt_wav(1.3, seed=1)
MODES = {"zero_shot": ("hello world this is a test", "the quick fox", PROMPT),
         "cross_lingual": ("hello brown fox", PROMPT),
         "instruct2": ("quick test", "hello", PROMPT),
         "sft": ("hello world", "spk1"),
         "vc": (SOURCE, PROMPT)}


def jax_trees() -> dict:
    """Seeded JAX parameter trees (drawn from their shapes alone), the LM's
    head biased by -30 on every id past the speech vocabulary."""
    lm = U.random_params(jllm.Qwen2LM(JCFG["lm_cfg"]).init, U.KEY,
                         jnp.zeros((1, 4), jnp.int32), jnp.asarray([4]),
                         jnp.zeros((1, 3), jnp.int32), jnp.asarray([3]), seed=11)
    lm["params"]["llm_decoder"]["bias"][U.SPEECH_VOCAB:] = -30.0
    flow = U.random_params(
        jflow.CausalMaskedDiffWithXvec(JCFG["flow_cfg"]).init, U.KEY,
        jnp.zeros((1, 8), jnp.int32), jnp.asarray([8]), jnp.zeros((1, 4, 80)),
        jnp.zeros((1, SPK_DIM)), method=jflow.CausalMaskedDiffWithXvec.inference, seed=12)
    hift = U.random_params(jhift.HiFTGenerator(JCFG["hift_cfg"], deterministic=True).init,
                           {"params": U.KEY, "noise": U.KEY}, jnp.zeros((1, 2, 80)), seed=13)
    s3 = U.random_params(js3.S3TokenizerV2(JCFG["s3_cfg"]).init, U.KEY,
                         jnp.zeros((1, 20, 128)), jnp.asarray([20]), seed=14)
    return {"llm": lm, "flow": flow, "hift": hift, "s3": s3}


SPK2INFO = {"spk1": {"embedding": np.random.default_rng(4).standard_normal(SPK_DIM)
                     .astype(np.float32)}}


def share_frontend_files(src, dst) -> None:
    """The ONNX files and the tokenizer directory of `src`, copied to `dst`."""
    for name in ("campplus.onnx", "speech_tokenizer_v2.onnx"):
        shutil.copy(src / name, dst / name)
    shutil.copytree(src / "CosyVoice-BlankEN", dst / "CosyVoice-BlankEN")


@pytest.fixture(scope="module")
def trees():
    return jax_trees()


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory, trees):
    d = tmp_path_factory.mktemp("cosyvoice2_pt")
    llm = convert.lm_state_from_jax(trees["llm"])
    llm["llm.model.lm_head.weight"] = llm["llm.model.model.embed_tokens.weight"].clone()
    torch.save(llm, d / "llm.pt")
    torch.save(convert.flow_state_from_jax(trees["flow"]), d / "flow.pt")
    torch.save({f"generator.{k}": v for k, v in convert.hift_state_from_jax(
        trees["hift"]).items()}, d / "hift.pt")
    torch.save({k: {"embedding": torch.from_numpy(v["embedding"])}
                for k, v in SPK2INFO.items()}, d / "spk2info.pt")
    U.write_campplus_onnx(str(d / "campplus.onnx"), U.seeded_campplus())
    tonnx.write_onnx_tensors(str(d / "speech_tokenizer_v2.onnx"),
                             js3.s3tokenizer_state_dict(trees["s3"], JCFG["s3_cfg"]))
    U.tokenizer_dir(d / "CosyVoice-BlankEN", "gpt2")
    return d


@pytest.fixture(scope="module")
def pair(model_dir):
    """(JAX CosyVoice2, port CosyVoice2) from the same directory, each with
    a deterministic HiFT (no NSF noise)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jhift, "HiFTGenerator", functools.partial(jhift.HiFTGenerator,
                                                         deterministic=True))
    mp.setattr(tapi, "HiFTGenerator", functools.partial(thift.HiFTGenerator,
                                                        deterministic=True))
    try:
        jcv = japi.from_pretrained(str(model_dir), max_decode_tokens=MAX_TOKENS, **JCFG)
        tcv = tapi.from_pretrained(str(model_dir), max_decode_tokens=MAX_TOKENS, device="cpu",
                                   **TCFG)
    finally:
        mp.undo()
    return jcv, tcv


def test_frontend_inputs_match_jax(pair):
    """Text ids and speech tokens exact, the speaker vector within 5e-4, the
    prompt mel within 1e-4, and the sft speaker table as loaded."""
    jcv, tcv = pair
    a = tcv.frontend.frontend_zero_shot("hello world this is a test", "the quick fox", PROMPT)
    b = jcv.frontend.frontend_zero_shot("hello world this is a test", "the quick fox", PROMPT)
    assert set(a) == set(b)
    for k in ("text", "prompt_text", "llm_prompt_speech_token", "flow_prompt_speech_token"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert len(a["flow_prompt_speech_token"]) == 22 and len(a["text"]) > 3
    np.testing.assert_allclose(a["flow_embedding"], b["flow_embedding"], atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(a["prompt_speech_feat"], b["prompt_speech_feat"], atol=1e-4)
    vc_a, vc_b = tcv.frontend.frontend_vc(SOURCE, PROMPT), jcv.frontend.frontend_vc(SOURCE,
                                                                                    PROMPT)
    np.testing.assert_array_equal(vc_a["source_speech_token"], vc_b["source_speech_token"])
    assert tcv.list_available_spks() == jcv.list_available_spks() == ["spk1"]
    np.testing.assert_array_equal(tcv.frontend.spk2info["spk1"]["embedding"],
                                  SPK2INFO["spk1"]["embedding"])
    assert set(tcv.load_seconds) == {"llm.pt", "flow.pt", "hift.pt", "tokenizer",
                                     "campplus.onnx", "speech_tokenizer_v2.onnx"}


def _recording(monkeypatch, model, log):
    """Record the generated tokens each token2wav call hands the flow."""
    token2wav = model.token2wav

    def wrapped(tokens, *args, **kw):
        log.append(np.asarray(tokens)[:kw.get("n_tokens")].copy())
        return token2wav(tokens, *args, **kw)
    monkeypatch.setattr(model, "token2wav", wrapped)


@pytest.mark.parametrize("stream", [False, True], ids=["oneshot", "stream"])
@pytest.mark.parametrize("mode", list(MODES))
def test_modes_match_jax(pair, mode, stream, monkeypatch):
    """Every API mode of both loaded models: the tokens each chunk's flow
    gets equal (greedy), every chunk within 1e-2 of the JAX chunk."""
    U.interpret_pallas(monkeypatch)
    jcv, tcv = pair
    tokens_j, tokens_t = [], []
    _recording(monkeypatch, jcv.model, tokens_j)
    _recording(monkeypatch, tcv.model, tokens_t)
    wavs_j = [o["tts_speech"] for o in getattr(jcv, f"inference_{mode}")(*MODES[mode],
                                                                          stream=stream)]
    wavs_t = [o["tts_speech"] for o in getattr(tcv, f"inference_{mode}")(*MODES[mode],
                                                                          stream=stream)]
    assert len(tokens_t) == len(tokens_j) == len(wavs_t) == len(wavs_j)
    assert len(wavs_t) >= (3 if stream else 1) and len(tokens_t[-1]) > 0
    for tt, tj in zip(tokens_t, tokens_j):
        np.testing.assert_array_equal(tt, tj)
    for wt, wj in zip(wavs_t, wavs_j):
        assert wt.shape == wj.shape and np.isfinite(wt).all()
        np.testing.assert_allclose(wt, wj, atol=1e-2)


def _state(cv) -> dict:
    m = cv.model
    return {f"{name}.{k}": v for name, mod in (("llm", m.llm), ("flow", m.flow),
                                               ("hift", m.hift))
            for k, v in mod.state_dict().items()}


def test_npz_directory_loads_the_same_weights(pair, trees, model_dir, tmp_path):
    """The JAX package's deployable format (its save_params_npz of the same
    trees, spk2info.npz) loads to state_dicts exactly equal to the .pt
    directory's."""
    d = tmp_path / "npz"
    d.mkdir()
    for stem in ("llm", "flow", "hift"):
        save_params_npz(str(d / f"{stem}.npz"), trees[stem])
    save_params_npz(str(d / "spk2info.npz"), SPK2INFO)
    share_frontend_files(model_dir, d)
    cv = tapi.from_pretrained(str(d), max_decode_tokens=MAX_TOKENS, device="cpu", **TCFG)
    want, got = _state(pair[1]), _state(cv)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert set(cv.load_seconds) >= {"llm.npz", "flow.npz", "hift.npz"}
    np.testing.assert_array_equal(cv.frontend.spk2info["spk1"]["embedding"],
                                  SPK2INFO["spk1"]["embedding"])


def test_directory_without_frontend_models(model_dir, tmp_path):
    """Without the two ONNX files sft runs and zero-shot raises ValueError."""
    d = tmp_path / "no_onnx"
    shutil.copytree(model_dir, d, ignore=shutil.ignore_patterns("*.onnx"))
    cv = tapi.from_pretrained(str(d), max_decode_tokens=MAX_TOKENS, device="cpu", **TCFG)
    wav = np.concatenate([o["tts_speech"] for o in cv.inference_sft("hello world", "spk1")])
    assert wav.size > 0 and np.isfinite(wav).all()
    with pytest.raises(ValueError, match="no speech tokenizer"):
        next(cv.inference_zero_shot("hello world", "the quick fox", PROMPT))


@pytest.mark.parametrize("stem,key", [("flow", "decoder.estimator.final_proj.weight"),
                                      ("llm", "llm_decoder.bias")])
def test_missing_weight_raises(model_dir, tmp_path, stem, key):
    d = tmp_path / "partial"
    shutil.copytree(model_dir, d)
    sd = torch.load(d / f"{stem}.pt", weights_only=True)
    del sd[key]
    torch.save(sd, d / f"{stem}.pt")
    with pytest.raises(KeyError, match=key):
        tapi.from_pretrained(str(d), device="cpu", **TCFG)


def test_fp16_int8_knobs_follow_the_jax_package(model_dir):
    """fp16 + int8 on the CPU: the JAX package's config choices (K2 only on
    the card; K1 and K3 left off), the int8 LM weights and fp32 scales equal
    to the JAX package's quantization of the same bf16 tree, and a finite
    sft waveform."""
    kw = dict(max_decode_tokens=MAX_TOKENS, fp16=True, quant="int8")
    cv = tapi.from_pretrained(str(model_dir), device="cpu", **kw, **TCFG)
    est, q = cv.model.flow.cfg.estimator, cv.model.llm.cfg.qwen
    assert (est.dtype, est.approx_gelu, est.fused_attention, est.fused_norm) == \
        ("bfloat16", True, False, False)
    assert cv.model.flow.cfg.encoder_dtype == "bfloat16"
    assert (q.quant, q.fused_cache_update) == ("int8", False)
    assert (cv.model.hift.cfg.dtype, cv.model.hift.cfg.approx_sin) == ("bfloat16", True)
    jcv = japi.from_pretrained(str(model_dir), **kw, **JCFG)
    want = convert.lm_state_from_jax(jcv.model.llm_params)
    got = cv.model.llm.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert got["llm.model.model.layers.0.mlp.up_proj.scale"].dtype == torch.float32
    wav = np.concatenate([o["tts_speech"] for o in cv.inference_sft("hello world", "spk1")])
    assert wav.size > 0 and np.isfinite(wav).all()


def test_from_pretrained_needs_a_gpu_unless_cpu_requested(model_dir):
    if torch.cuda.is_available():
        pytest.skip("this check is for hosts without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.from_pretrained(str(model_dir), **TCFG)


def _tiny_from_pretrained(monkeypatch):
    """The command-line entry points build full-size models; give their
    from_pretrained the tiny configurations of this directory."""
    monkeypatch.setattr(tapi, "from_pretrained",
                        functools.partial(tapi.from_pretrained, **TCFG))


def test_serve_main_answers_a_streamed_request(model_dir, monkeypatch, capsys):
    """bin/serve.py's command line with --device cpu: warmed up, /health,
    one streamed /tts/zero_shot whose PCM equals pcm16 of a direct run."""
    import http.client

    from cosyvoice_tpu_torch.bin import serve as S

    _tiny_from_pretrained(monkeypatch)
    httpd = S.build_server(["--model_dir", str(model_dir), "--device", "cpu", "--host",
                            "127.0.0.1", "--port", "0", "--max-decode-tokens",
                            str(MAX_TOKENS)])
    assert "warmup done" in capsys.readouterr().out
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        port = httpd.server_address[1]
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        c.request("GET", "/health")
        r = c.getresponse()
        assert r.status == 200 and json.loads(r.read()) == {"status": "ok"}
        body = {"text": "hello world this is a test", "prompt_text": "the quick fox",
                "prompt_wav": PROMPT.tolist(), "stream": True}
        c.request("POST", "/tts/zero_shot", json.dumps(body),
                  {"Content-Type": "application/json"})
        r = c.getresponse()
        data = r.read()
    finally:
        httpd.shutdown()
        httpd.worker.close()
    assert r.status == 200 and data[:4] == b"RIFF"
    direct = b"".join(S.pcm16(o["tts_speech"]) for o in httpd.worker.cv.inference_zero_shot(
        body["text"], body["prompt_text"], PROMPT, stream=True))
    assert len(direct) > 0 and data[44:] == direct


def test_inference_main_writes_the_api_output(model_dir, monkeypatch, tmp_path):
    """bin/inference.py's command line with --device cpu: each request's wav
    equals the API's output (as 16-bit PCM), and rtf.log has a line each."""
    from cosyvoice_tpu_torch.bin import inference as I

    _tiny_from_pretrained(monkeypatch)
    I.write_wav(str(tmp_path / "prompt.wav"), PROMPT, 16000)
    reqs = [{"utt": "a", "tts_text": "hello world this is a test", "prompt_text": "the quick",
             "prompt_wav": str(tmp_path / "prompt.wav")},
            {"utt": "b", "tts_text": "quick brown fox", "prompt_text": "hello",
             "prompt_wav": str(tmp_path / "prompt.wav")}]
    (tmp_path / "reqs.jsonl").write_text("".join(json.dumps(r) + "\n" for r in reqs))
    I.main(["--model_dir", str(model_dir), "--requests", str(tmp_path / "reqs.jsonl"),
            "--result_dir", str(tmp_path / "out"), "--device", "cpu"])
    cv = tapi.from_pretrained(str(model_dir), device="cpu")
    prompt16, sr = I.read_wav(str(tmp_path / "prompt.wav"))
    assert sr == 16000
    for r in reqs:
        want = np.concatenate([o["tts_speech"] for o in cv.inference_zero_shot(
            r["tts_text"], r["prompt_text"], prompt16)])
        with wave.open(str(tmp_path / "out" / f"{r['utt']}.wav"), "rb") as w:
            assert w.getframerate() == cv.sample_rate
            got = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        np.testing.assert_array_equal(got, (np.clip(want, -1, 1) * 32767).astype(np.int16))
    lines = (tmp_path / "out" / "rtf.log").read_text().splitlines()
    assert [ln.split()[0] for ln in lines] == ["a", "b"] and all(" rtf " in ln for ln in lines)
