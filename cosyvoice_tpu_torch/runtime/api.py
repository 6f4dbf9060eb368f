"""User-facing CosyVoice2 API (zero-shot mode).

Port of cosyvoice_tpu/runtime/api.py::CosyVoice2.inference_zero_shot:
normalize and split the text, then run `model.tts()` per segment, logging
the RTF of each yielded chunk: one chunk a segment, or with `stream=True`
the segment's streamed chunks as they are synthesized.  Loading released
checkpoints (`from_pretrained`) comes with checkpoint support.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from cosyvoice_tpu_torch.runtime.frontend import CosyVoiceFrontEnd
from cosyvoice_tpu_torch.runtime.model import CosyVoice2Model

logger = logging.getLogger(__name__)


@dataclass
class CosyVoice2:
    frontend: CosyVoiceFrontEnd
    model: CosyVoice2Model
    sample_rate: int = 24000

    def _run(self, model_input: dict, stream: bool, speed: float,
             gen: Optional[torch.Generator]) -> Iterator[dict]:
        ptext = model_input.get("prompt_text", np.zeros(0, np.int32))
        full_text = np.concatenate([ptext, model_input["text"]]).astype(np.int32)
        start = time.time()
        for out in self.model.tts(
                text_tokens=full_text, prompt_text_len=len(ptext),
                llm_prompt_speech_token=model_input.get(
                    "llm_prompt_speech_token", np.zeros(0, np.int32)),
                flow_prompt_speech_token=model_input.get(
                    "flow_prompt_speech_token", np.zeros(0, np.int32)),
                prompt_speech_feat=model_input.get(
                    "prompt_speech_feat", np.zeros((0, 80), np.float32)),
                flow_embedding=model_input["flow_embedding"],
                stream=stream, speed=speed, gen=gen):
            audio_dur = len(out["tts_speech"]) / self.sample_rate
            logger.info("yield speech len %.2f, rtf %f", audio_dur,
                        (time.time() - start) / max(audio_dur, 1e-6))
            yield out
            start = time.time()

    def inference_zero_shot(self, tts_text: str, prompt_text: str,
                            prompt_speech_16k: np.ndarray, stream: bool = False,
                            speed: float = 1.0, text_frontend: bool = True,
                            gen: Optional[torch.Generator] = None) -> Iterator[dict]:
        prompt_text_n = (self.frontend.text_normalize(prompt_text, split=False)
                         if text_frontend else prompt_text)
        segs = self.frontend.text_normalize(tts_text) if text_frontend else [tts_text]
        for seg in segs:
            if len(seg) < 0.5 * len(prompt_text_n):
                logger.warning("synthesis text %s too short than prompt %s",
                               seg, prompt_text_n)
            yield from self._run(self.frontend.frontend_zero_shot(
                seg, prompt_text_n, prompt_speech_16k), stream, speed, gen)
