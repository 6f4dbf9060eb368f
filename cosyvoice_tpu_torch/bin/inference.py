"""Offline batch synthesis over a model directory, with RTF logging.

Port of cosyvoice_tpu/bin/inference.py (the reference's bin/inference.py):
read a jsonl file of requests, synthesize each through `from_pretrained`'s
CosyVoice2, write `<utt>.wav` (16-bit PCM at the model's rate) and a line a
request to `rtf.log`.

    python -m cosyvoice_tpu_torch.bin.inference --model_dir DIR \\
        --requests reqs.jsonl --result_dir out [--mode zero_shot] [--stream] \\
        [--device cuda]

One request a line:
  {"utt": "id", "tts_text": "...", "prompt_text": "...",
   "prompt_wav": "path.wav (16 kHz mono)"}     (sft: "spk_id" in place of the prompt)
"""
from __future__ import annotations

import argparse
import json
import os
import time
import wave
from typing import Optional

import numpy as np


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """A 16-bit PCM WAV -> (mono float32 in [-1, 1), sample rate)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        data = np.frombuffer(w.readframes(w.getnframes()), dtype=np.int16)
        if w.getnchannels() > 1:
            data = data.reshape(-1, w.getnchannels()).mean(axis=1)
    return data.astype(np.float32) / 32768.0, sr


def write_wav(path: str, wav: np.ndarray, sr: int) -> None:
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(wav, -1, 1) * 32767).astype(np.int16).tobytes())


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser(description="CosyVoice2 offline synthesis over a model directory")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--requests", required=True, help="jsonl request file")
    p.add_argument("--result_dir", required=True)
    p.add_argument("--mode", default="zero_shot", choices=["zero_shot", "cross_lingual", "sft"])
    p.add_argument("--stream", action="store_true")
    p.add_argument("--device", default=None, help="default: the GPU; 'cpu' runs the plain "
                                                  "PyTorch versions")
    args = p.parse_args(argv)
    from cosyvoice_tpu_torch.runtime.api import from_pretrained

    cv = from_pretrained(args.model_dir, device=args.device)
    os.makedirs(args.result_dir, exist_ok=True)
    rtf_lines = []
    with open(args.requests) as f:
        requests = [json.loads(line) for line in f if line.strip()]
    for req in requests:
        t0 = time.time()
        if args.mode == "sft":
            outs = cv.inference_sft(req["tts_text"], req["spk_id"], stream=args.stream)
        else:
            wav16, sr = read_wav(req["prompt_wav"])
            if sr != 16000:
                raise ValueError(f"{req['prompt_wav']}: prompt wavs must be 16 kHz, got {sr}")
            outs = (cv.inference_zero_shot(req["tts_text"], req["prompt_text"], wav16,
                                           stream=args.stream)
                    if args.mode == "zero_shot"
                    else cv.inference_cross_lingual(req["tts_text"], wav16, stream=args.stream))
        wav = np.concatenate([o["tts_speech"] for o in outs])
        dt = time.time() - t0
        dur = len(wav) / cv.sample_rate
        rtf_lines.append(f"{req['utt']} rtf {dt / max(dur, 1e-6):.4f} dur {dur:.2f}")
        print(rtf_lines[-1], flush=True)
        write_wav(os.path.join(args.result_dir, f"{req['utt']}.wav"), wav, cv.sample_rate)
    with open(os.path.join(args.result_dir, "rtf.log"), "w") as f:
        f.write("\n".join(rtf_lines) + "\n")


if __name__ == "__main__":
    main()
