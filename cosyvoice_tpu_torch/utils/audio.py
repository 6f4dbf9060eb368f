"""Host-side audio helpers for the offline tools."""
from __future__ import annotations

import numpy as np


def read_wav_16k(path: str) -> np.ndarray:
    """PCM WAV file -> mono float32 at 16 kHz (the speaker embedder's and the
    speech tokenizer's input rate)."""
    from cosyvoice_tpu_torch.bin.inference import read_wav
    from cosyvoice_tpu_torch.runtime.frontend import resample_poly

    wav, sr = read_wav(path)
    if sr != 16000:
        wav = resample_poly(wav, sr, 16000)
    return wav.astype(np.float32)
