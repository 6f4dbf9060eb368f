"""HTTP front end for CosyVoice2 TTS (standard library only).

Port of cosyvoice_tpu/bin/serve.py: a threaded HTTP server in front of one
synthesis worker, or with `continuous=True` in front of the continuous
server (runtime/serving.ContinuousSynthesizer), where concurrent requests
share the LM's slot engine.

Endpoints (JSON in, WAV out):
  GET  /health                     -> {"status": "ok"}
  POST /tts/sft                    {"text", "spk_id", "stream"?}
  POST /tts/zero_shot              {"text", "prompt_text",
                                    "prompt_wav_b64" (base64 f32le PCM at 16 kHz)
                                    | "prompt_wav": [floats], "stream"?}
  POST /tts/cross_lingual          {"text", prompt wav as above}
  POST /tts/instruct2              {"text", "instruct_text", prompt wav}
  POST /tts/vc                     {"source_wav_b64" | "source_wav", prompt wav}

A one-shot response is a complete RIFF/WAV (16-bit PCM at the model's sample
rate); with "stream": true it is chunked WAV with an unbounded data-size
header, one chunk a synthesis hop.  An unknown path is 404, a body that is
not JSON 400, and a failed synthesis 500.

From the command line, over a released-format model directory on the GPU:

    python -m cosyvoice_tpu_torch.bin.serve --model_dir DIR --fp16 --quant int8 \
        --continuous [--port 8080] [--no-warmup] [--device cuda]

loads it with `runtime/api.from_pretrained`, builds the worker, warms it up
and prints `serving on HOST:PORT` (the bound port: `--port 0` takes a free
one).  From Python, over a CosyVoice2 (runtime/api.py):

    httpd = serve(cv, host="0.0.0.0", port=8080, continuous=True)
    httpd.serve_forever()
"""
from __future__ import annotations

import argparse
import base64
import io
import json
import queue
import struct
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from cosyvoice_tpu_torch.runtime.serving import ContinuousSynthesizer, TTSRequest

MODES = {"sft", "zero_shot", "cross_lingual", "instruct2", "vc"}


def wav_header(sample_rate: int, num_samples: int = -1) -> bytes:
    """RIFF header for 16-bit mono PCM; num_samples -1 gives streaming sizes."""
    data_bytes = 0xFFFFFFFF - 44 if num_samples < 0 else 2 * num_samples
    return (b"RIFF" + struct.pack("<I", 36 + data_bytes) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, 2 * sample_rate, 2, 16)
            + b"data" + struct.pack("<I", data_bytes))


def pcm16(wav: np.ndarray) -> bytes:
    return (np.clip(wav, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()


def _wav_field(body: dict, name: str) -> np.ndarray:
    if f"{name}_b64" in body:
        return np.frombuffer(base64.b64decode(body[f"{name}_b64"]), dtype="<f4").astype(
            np.float32)
    return np.asarray(body.get(name, []), np.float32)


def decode_prompt_wav(body: dict) -> np.ndarray:
    return _wav_field(body, "prompt_wav")


def run_inference(cv, mode: str, body: dict):
    """Dispatch one request body to the matching CosyVoice2.inference_*
    generator (it yields {"tts_speech"} chunks)."""
    stream = bool(body.get("stream", False))
    if mode == "vc":
        if "source_wav_b64" not in body and "source_wav" not in body:
            raise KeyError("source_wav")
        return cv.inference_vc(_wav_field(body, "source_wav"), decode_prompt_wav(body),
                               stream=stream)
    text = body["text"]
    if mode == "sft":
        return cv.inference_sft(text, body["spk_id"], stream=stream)
    prompt = decode_prompt_wav(body)
    if mode == "zero_shot":
        return cv.inference_zero_shot(text, body.get("prompt_text", ""), prompt, stream=stream)
    if mode == "cross_lingual":
        return cv.inference_cross_lingual(text, prompt, stream=stream)
    if mode == "instruct2":
        return cv.inference_instruct2(text, body["instruct_text"], prompt, stream=stream)
    raise ValueError(f"unknown mode {mode}")


def tts_requests(cv, mode: str, body: dict):
    """The TTSRequest of each text segment of a request body, in order (the
    modes with an LM stage)."""
    fe = cv.frontend
    prompt = decode_prompt_wav(body)
    n_mel = cv.model.flow.cfg.output_size
    for seg in fe.text_normalize(body["text"]):
        if mode == "sft":
            mi = fe.frontend_sft(seg, body["spk_id"])
        elif mode == "zero_shot":
            mi = fe.frontend_zero_shot(
                seg, fe.text_normalize(body.get("prompt_text", ""), split=False), prompt)
        elif mode == "cross_lingual":
            mi = fe.frontend_cross_lingual(seg, prompt)
        elif mode == "instruct2":
            mi = fe.frontend_instruct2(seg, body["instruct_text"], prompt)
        else:
            raise ValueError(f"unknown mode {mode}")
        ptext = mi.get("prompt_text", np.zeros(0, np.int32))
        yield TTSRequest(
            text_tokens=np.concatenate([ptext, mi["text"]]).astype(np.int32),
            prompt_text_len=len(ptext),
            prompt_speech_tokens=np.asarray(mi.get("flow_prompt_speech_token",
                                                   np.zeros(0, np.int32)), np.int32),
            prompt_feat=np.asarray(mi.get("prompt_speech_feat", np.zeros((0, n_mel))),
                                   np.float32),
            embedding=np.asarray(mi["flow_embedding"], np.float32))


class SynthesisWorker:
    """One thread owns the model and runs requests strictly in order.  Each
    job streams its wav chunks (np.ndarray) into its queue and closes it with
    None, or with the Exception that stopped it."""

    def __init__(self, cosyvoice):
        self.cv = cosyvoice
        self.jobs: queue.Queue = queue.Queue()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while True:
            job = self.jobs.get()
            if job is None:
                return
            mode, body, out = job
            try:
                for piece in run_inference(self.cv, mode, body):
                    out.put(piece["tts_speech"])
                out.put(None)
            except Exception as e:      # the handler answers 500
                out.put(e)

    def submit(self, mode: str, body: dict) -> queue.Queue:
        out: queue.Queue = queue.Queue()
        self.jobs.put((mode, body, out))
        return out

    def close(self) -> None:
        self.jobs.put(None)
        self.thread.join()


class ContinuousWorker:
    """The continuous-batching backend: requests share the slot engine, so
    many HTTP streams synthesize at once.  Same submit() contract as
    SynthesisWorker.  A request's text segments are chained in order (segment
    k + 1 is submitted after k's final chunk); voice conversion has no LM
    stage and runs its token2wav path on the request's own thread.  If the
    server's thread fails, every waiting request and every later one gets
    its exception."""

    def __init__(self, cosyvoice, num_slots: int = 8, **synth_kw):
        self.cv = cosyvoice
        self.synth = ContinuousSynthesizer(cosyvoice.model, num_slots=num_slots, **synth_kw)
        self.subs: queue.Queue = queue.Queue()
        self.error: Optional[Exception] = None
        self._waiting: set = set()
        self._lock = threading.Lock()
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        try:
            self.synth.serve(self.subs)
        except Exception as e:
            with self._lock:
                self.error = e
                for q in self._waiting:
                    q.put((e, True))

    def submit(self, mode: str, body: dict) -> queue.Queue:
        out: queue.Queue = queue.Queue()

        def drive():
            try:
                if mode == "vc":
                    for piece in run_inference(self.cv, mode, body):
                        out.put(piece["tts_speech"])
                    out.put(None)
                    return
                for req in tts_requests(self.cv, mode, body):
                    seg_q: queue.Queue = queue.Queue()
                    with self._lock:
                        if self.error is not None:
                            raise self.error
                        self._waiting.add(seg_q)
                    try:
                        self.subs.put((req, lambda wav, fin, q=seg_q: q.put((wav, fin))))
                        while True:
                            wav, fin = seg_q.get()
                            if isinstance(wav, Exception):
                                raise wav
                            out.put(wav)
                            if fin:
                                break
                    finally:
                        with self._lock:
                            self._waiting.discard(seg_q)
                out.put(None)
            except Exception as e:
                out.put(e)

        threading.Thread(target=drive, daemon=True).start()
        return out

    def close(self) -> None:
        """Drain live work and stop the server's thread."""
        self.subs.put(None)
        self.thread.join()


def make_handler(worker, sample_rate: int):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):     # quiet by default
            pass

        def _json(self, code: int, obj: dict):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path != "/health":
                return self._json(404, {"error": "not found"})
            self._json(200, {"status": "ok"})

        def do_POST(self):
            mode = self.path.removeprefix("/tts/")
            if not self.path.startswith("/tts/") or mode not in MODES:
                return self._json(404, {"error": "not found"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
            except ValueError as e:
                return self._json(400, {"error": f"bad request: {e}"})
            out = worker.submit(mode, body)
            if body.get("stream", False):
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                self._chunk(wav_header(sample_rate))
                while True:
                    piece = out.get()
                    if piece is None or isinstance(piece, Exception):
                        break                  # a started stream just ends
                    self._chunk(pcm16(piece))
                self.wfile.write(b"0\r\n\r\n")
                return
            pieces = []
            while True:
                piece = out.get()
                if piece is None:
                    break
                if isinstance(piece, Exception):
                    return self._json(500, {"error": str(piece)})
                pieces.append(piece)
            wav = np.concatenate(pieces) if pieces else np.zeros(0, np.float32)
            buf = io.BytesIO()
            buf.write(wav_header(sample_rate, len(wav)))
            buf.write(pcm16(wav))
            data = buf.getvalue()
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _chunk(self, data: bytes):
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")

    return Handler


def _warm_prompt() -> np.ndarray:
    rng = np.random.default_rng(0)
    return (rng.standard_normal(16000) * 0.05).astype(np.float32)   # 1 s at 16 kHz


def _card_report(device: torch.device) -> str:
    """What warming did on the card: the kernels' build and the allocator's
    peak (nothing on the CPU, where the plain versions run)."""
    if device.type != "cuda":
        return "on the CPU: plain kernel versions, nothing built"
    from cosyvoice_tpu_torch.ops.kernels import build

    rep = build.report
    built = ("kernels not built" if not rep else
             f"kernel build {rep['seconds']:.1f}s ({'cached' if rep['cached'] else 'nvcc'})")
    return f"{built}; allocator peak {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB"


def warmup_continuous(worker: ContinuousWorker, num_slots: int) -> float:
    """Drive synthetic zero-shot streaming requests through the server's own
    worker in concurrency rounds 1, 2, 4, ..., num_slots, so that the first
    real requests find the kernels built and the allocator's pools grown at
    every group size.  A failure is printed and serving goes on.  Prints the
    kernel build and the allocator's peak; returns wall seconds."""
    t0 = time.time()
    rounds, k = [], 1
    while k < num_slots:
        rounds.append(k)
        k *= 2
    rounds.append(num_slots)
    prompt = _warm_prompt().tolist()
    try:
        for k in rounds:
            outs = [worker.submit("zero_shot", {"text": "warmup synthesis request.",
                                                "prompt_text": "prompt text.",
                                                "prompt_wav": prompt, "stream": True})
                    for _ in range(k)]
            for q in outs:
                while (piece := q.get()) is not None:
                    if isinstance(piece, Exception):
                        raise piece
    except Exception as e:                  # never block serving on a warmup failure
        print(f"continuous warmup failed (continuing): {e}", flush=True)
    dt = time.time() - t0
    print(f"continuous warmup done in {dt:.1f}s: group rounds {rounds}; "
          f"{_card_report(worker.cv.model.device)}", flush=True)
    return dt


def warmup(cv) -> float:
    """One synthetic zero-shot streaming request through the whole stack
    before traffic; a failure is printed and serving goes on.  Returns wall
    seconds."""
    t0 = time.time()
    try:
        for _ in cv.inference_zero_shot("warmup synthesis request.", "prompt text.",
                                        _warm_prompt(), stream=True):
            pass
    except Exception as e:
        print(f"warmup failed (continuing): {e}", flush=True)
    dt = time.time() - t0
    print(f"warmup done in {dt:.1f}s; {_card_report(cv.model.device)}", flush=True)
    return dt


def serve(cosyvoice, host: str = "0.0.0.0", port: int = 8080, continuous: bool = False,
          num_slots: int = 8, worker=None) -> ThreadingHTTPServer:
    """The HTTP server over `cosyvoice` (its worker as `httpd.worker`); the
    caller runs httpd.serve_forever(), and httpd.shutdown() and
    httpd.worker.close() to stop."""
    if worker is None:
        worker = (ContinuousWorker(cosyvoice, num_slots=num_slots) if continuous
                  else SynthesisWorker(cosyvoice))
    httpd = ThreadingHTTPServer((host, port), make_handler(worker, cosyvoice.sample_rate))
    httpd.worker = worker
    return httpd


def build_server(argv: Optional[list] = None) -> ThreadingHTTPServer:
    """Parse the command line, load the model directory, build the worker
    (so that the warm-up drives the serving backend itself), warm it up
    unless --no-warmup, and bind the server; the caller runs
    serve_forever()."""
    ap = argparse.ArgumentParser(description="CosyVoice2 HTTP server over a model directory")
    ap.add_argument("--model_dir", required=True)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8080, help="0 takes a free port")
    ap.add_argument("--fp16", action="store_true")
    ap.add_argument("--quant", default="none", choices=["none", "int8", "int4"])
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching backend (requests share the slot engine "
                         "instead of queueing one by one)")
    ap.add_argument("--num_slots", type=int, default=8)
    ap.add_argument("--max-decode-tokens", type=int, default=1600,
                    help="hard per-segment speech-token ceiling (~tokens/25 s of audio)")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the synthetic warm-up requests (the first real request "
                         "then builds the kernels)")
    ap.add_argument("--flow-context-tokens", type=int, default=None,
                    help="streaming flow context window in generated tokens (>= 53)")
    ap.add_argument("--device", default=None, help="default: the GPU; 'cpu' runs the "
                                                   "plain PyTorch versions")
    args = ap.parse_args(argv)
    from cosyvoice_tpu_torch.runtime.api import from_pretrained

    cv = from_pretrained(args.model_dir, fp16=args.fp16, quant=args.quant,
                         max_decode_tokens=args.max_decode_tokens,
                         flow_context_tokens=args.flow_context_tokens, device=args.device)
    print("loaded " + ", ".join(f"{k} {v:.2f}s" for k, v in cv.load_seconds.items()),
          flush=True)
    worker = (ContinuousWorker(cv, num_slots=args.num_slots) if args.continuous
              else SynthesisWorker(cv))
    if not args.no_warmup:
        if args.continuous:
            warmup_continuous(worker, args.num_slots)
        else:
            warmup(cv)
    return serve(cv, args.host, args.port, worker=worker)


def main(argv: Optional[list] = None) -> None:
    httpd = build_server(argv)
    host, port = httpd.server_address[:2]
    print(f"serving on {host}:{port}", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.worker.close()


if __name__ == "__main__":
    main()
