"""On-the-fly ASR transcription for untranscribed training audio.

Port of cosyvoice_tpu/data/transcriber.py: `transcribe_stage` fills a
sample's missing `txt` from its audio through a lazily built funasr model
(or an injected `transcriber(wav, sr) -> text`).  funasr is an optional
dependency that needs a model download; without it `available()` is False
and building the model raises RuntimeError, so the rest of the pipeline
works without it.
"""
from __future__ import annotations

from typing import Callable, Optional

_MODEL = None


def available() -> bool:
    try:
        import funasr  # noqa: F401
        return True
    except ImportError:
        return False


def get_transcriber(model: str = "paraformer-zh",
                    device: str = "cpu") -> Callable[[object, int], str]:
    """The funasr model, built once -> fn(waveform, sample_rate) -> text."""
    global _MODEL
    if _MODEL is None:
        try:
            from funasr import AutoModel
        except ImportError as e:
            raise RuntimeError("funasr is required for on-the-fly transcription; install it "
                               "or provide transcripts in the data dir") from e
        _MODEL = AutoModel(model=model, device=device, disable_update=True)

    def transcribe(wav, sr: int) -> str:
        res = _MODEL.generate(input=wav, fs=sr)
        return res[0]["text"] if res else ""

    return transcribe


def transcribe_stage(model: str = "paraformer-zh", device: str = "cpu",
                     transcriber: Optional[Callable] = None):
    """Pipeline stage: fill a missing sample['txt'] by ASR; the model is
    built at the first sample that needs it."""

    def stage(it):
        fn = transcriber
        for sample in it:
            if not sample.get("txt"):
                if fn is None:
                    fn = get_transcriber(model, device)
                sample["txt"] = fn(sample["speech"], sample["sample_rate"])
            yield sample

    return stage
