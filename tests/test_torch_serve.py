"""The port's HTTP front end (cosyvoice_tpu_torch/bin/serve.py), port only:
the cases of tests/test_serve.py on a tiny torch-initialized stack on the CPU
(health, a one-shot and a chunked streaming WAV, the bad requests' status
codes, concurrent requests to the continuous server, the other modes' and
the vc endpoints, both warmups), and the continuous server's PCM equal to
pcm16 of a direct ContinuousSynthesizer run of the same requests."""
import http.client
import json
import struct
import threading

import numpy as np
import pytest
import torch

import torch_port_util as U
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)
from cosyvoice_tpu_torch.bin import serve as S
from cosyvoice_tpu_torch.models.conformer import ConformerConfig
from cosyvoice_tpu_torch.models.flow import CausalMaskedDiffWithXvec, FlowConfig
from cosyvoice_tpu_torch.models.hift import HiFTConfig, HiFTGenerator
from cosyvoice_tpu_torch.models.llm import LMConfig, Qwen2LM, SamplingConfig
from cosyvoice_tpu_torch.models.qwen2 import Qwen2Config
from cosyvoice_tpu_torch.runtime.api import CosyVoice2
from cosyvoice_tpu_torch.runtime.frontend import CosyVoiceFrontEnd
from cosyvoice_tpu_torch.runtime.model import CosyVoice2Model
from cosyvoice_tpu_torch.runtime.serving import ContinuousSynthesizer
from cosyvoice_tpu_torch.tokenizer.text import ByteTokenizer

SR = 2304
PROMPT = np.sin(np.arange(8000) * 0.01).tolist()
SPK = {"speaker": {"embedding": np.ones(24, np.float32)}}


def _cosyvoice() -> CosyVoice2:
    """A greedy tiny stack at 5 flow frames a second (hop 10 tokens), its LM
    head biased away from the ids it does not emit so that every request
    streams chunks up to the 30-token cap; HiFT draws its source noise."""
    torch.manual_seed(0)
    llm = Qwen2LM(LMConfig(32, 32, U.SPEECH_VOCAB, qwen=Qwen2Config(**U.QWEN),
                           sampling=SamplingConfig(method="greedy")))
    with torch.no_grad():
        llm.llm_decoder.bias[U.SPEECH_VOCAB:] = -30.0
    flow = CausalMaskedDiffWithXvec(FlowConfig(
        64, U.N_MEL, 24, U.SPEECH_VOCAB + 3, input_frame_rate=5,
        encoder=ConformerConfig(**dict(U.ENC, static_chunk_size=10)),
        estimator=U.torch_est_config(True)))
    model = CosyVoice2Model(llm=llm, flow=flow, hift=HiFTGenerator(HiFTConfig(**U.HIFT)),
                            max_decode_tokens=30, device="cpu")
    frontend = CosyVoiceFrontEnd(
        tokenizer=ByteTokenizer(), speech_tokenizer=lambda wav: np.arange(10) % U.SPEECH_VOCAB,
        spk_embedder=lambda wav: np.ones(24, np.float32), spk2info=SPK, sample_rate=SR,
        n_mels=U.N_MEL, mel_n_fft=96, mel_hop=48, device="cpu")
    return CosyVoice2(frontend=frontend, model=model, sample_rate=SR)


def _start(cv, **kw):
    httpd = S.serve(cv, host="127.0.0.1", port=0, **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


@pytest.fixture(scope="module")
def cv():
    return _cosyvoice()


@pytest.fixture(scope="module")
def server(cv):
    httpd = _start(cv)
    yield httpd.server_address[1]
    httpd.shutdown()
    httpd.worker.close()


@pytest.fixture(scope="module")
def continuous_server(cv):
    """The continuous server with the sequential flush (batch_chunks off): a
    chunk's audio then does not depend on which streams share its flush, so
    the PCM is comparable bit for bit."""
    httpd = _start(cv, worker=S.ContinuousWorker(cv, num_slots=2, batch_chunks=False))
    yield httpd.server_address[1]
    httpd.shutdown()
    httpd.worker.close()


def _post(port, path, body, raw: bool = False):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    c.request("POST", path, body if raw else json.dumps(body),
              {"Content-Type": "application/json"})
    r = c.getresponse()
    return r, r.read()


def _parse_wav(data: bytes):
    assert data[:4] == b"RIFF" and data[8:12] == b"WAVE" and data[36:40] == b"data"
    return struct.unpack("<I", data[24:28])[0], np.frombuffer(data[44:], dtype="<i2")


def test_health(server):
    c = http.client.HTTPConnection("127.0.0.1", server)
    c.request("GET", "/health")
    r = c.getresponse()
    assert r.status == 200 and json.loads(r.read())["status"] == "ok"


def test_zero_shot_wav(server):
    r, data = _post(server, "/tts/zero_shot", {"text": "Hello there, friend.",
                                               "prompt_text": "Hi.", "prompt_wav": PROMPT})
    assert r.status == 200 and r.getheader("Content-Type") == "audio/wav"
    sr, pcm = _parse_wav(data)
    assert sr == SR and pcm.size > 0 and struct.unpack("<I", data[40:44])[0] == 2 * pcm.size


def test_zero_shot_streaming_chunked(server):
    r, data = _post(server, "/tts/zero_shot", {
        "text": "Such a long sentence needs several chunks to stream properly.",
        "prompt_text": "Hi.", "stream": True, "prompt_wav": PROMPT})
    assert r.status == 200 and r.getheader("Transfer-Encoding") == "chunked"
    assert data[:44] == S.wav_header(SR)
    assert np.frombuffer(data[44:], dtype="<i2").size > 0


def test_bad_requests(server):
    assert _post(server, "/tts/nope", "{}", raw=True)[0].status == 404
    assert _post(server, "/tts/zero_shot", "not json", raw=True)[0].status == 400
    # a missing field fails in the worker: 500
    assert _post(server, "/tts/instruct2", {"text": "x"})[0].status == 500
    c = http.client.HTTPConnection("127.0.0.1", server)
    c.request("GET", "/nope")
    assert c.getresponse().status == 404


@pytest.mark.parametrize("mode,body", [
    ("sft", {"text": "Hello there.", "spk_id": "speaker"}),
    ("cross_lingual", {"text": "Hello there.", "prompt_wav": PROMPT}),
    ("instruct2", {"text": "Hello there.", "instruct_text": "slowly.", "prompt_wav": PROMPT}),
    ("vc", {"source_wav": np.sin(np.arange(8000) * 0.02).tolist(), "prompt_wav": PROMPT}),
])
def test_other_modes(server, continuous_server, mode, body):
    """The sft, cross-lingual, instruct2 and vc endpoints of both servers
    answer well-formed WAVs of the model's sample rate."""
    for port in (server, continuous_server):
        r, data = _post(port, f"/tts/{mode}", body)
        assert r.status == 200, (port, mode)
        sr, pcm = _parse_wav(data)
        assert sr == SR and pcm.size > 0


def test_continuous_server_concurrent_requests(cv, continuous_server):
    """Three concurrent requests (two streamed) through 2 slots come back as
    WAVs whose PCM equals pcm16 of a direct ContinuousSynthesizer run of the
    same requests."""
    texts = ["Hello there, my friend.", "A second, longer request arrives concurrently.",
             "And a third one."]
    results = {}

    def call(i):
        results[i] = _post(continuous_server, "/tts/zero_shot", {
            "text": texts[i], "prompt_text": "Hi.", "prompt_wav": PROMPT, "stream": i > 0})

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    body = {"prompt_text": "Hi.", "prompt_wav": PROMPT}
    reqs = [r for text in texts for r in S.tts_requests(cv, "zero_shot", dict(body, text=text))]
    assert len(reqs) == 3
    direct = ContinuousSynthesizer(cv.model, num_slots=2, batch_chunks=False).synthesize_batch(
        reqs)
    for i in range(3):
        r, data = results[i]
        assert r.status == 200, f"request {i}"
        sr, pcm = _parse_wav(data)
        assert sr == SR and pcm.size > 0
        assert pcm.tobytes() == S.pcm16(direct[i]), f"request {i}"


def test_warmups_on_tiny_model(cv, capsys):
    """warmup drives one streaming request through the stack; warmup_continuous
    drives rounds of 1 and 2 concurrent requests through the continuous
    worker (flush groups on) and reports what warming did; neither raises."""
    assert S.warmup(cv) > 0
    worker = S.ContinuousWorker(cv, num_slots=2)
    try:
        assert S.warmup_continuous(worker, 2) > 0
        q = worker.submit("zero_shot", {"text": "warmup synthesis request.",
                                        "prompt_text": "prompt text.", "prompt_wav": PROMPT})
        pieces = []
        while (piece := q.get()) is not None:
            assert not isinstance(piece, Exception), piece
            pieces.append(piece)
        assert sum(len(p) for p in pieces) > 0
    finally:
        worker.close()
    out = capsys.readouterr().out
    assert "warmup done" in out and "group rounds [1, 2]" in out and "failed" not in out
