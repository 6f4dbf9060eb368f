"""User-facing CosyVoice2 API: the sft, zero-shot, cross-lingual, instruct2
and voice-conversion modes.

Port of cosyvoice_tpu/runtime/api.py::CosyVoice2: each `inference_*`
normalizes and splits the text, then runs `model.tts()` a segment, logging
the RTF of each yielded chunk: one chunk a segment, or with `stream=True`
the segment's streamed chunks as they are synthesized.  `inference_vc` has
no LM stage: the source's speech tokens go through the flow and vocoder,
streamed in hop-sized chunks with `stream=True`.  Loading released
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

    def list_available_spks(self) -> list[str]:
        return list(self.frontend.spk2info.keys())

    def _segments(self, tts_text: str, text_frontend: bool) -> list:
        return self.frontend.text_normalize(tts_text) if text_frontend else [tts_text]

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
                    "prompt_speech_feat",
                    np.zeros((0, self.model.flow.cfg.output_size), np.float32)),
                flow_embedding=model_input["flow_embedding"],
                stream=stream, speed=speed, gen=gen):
            audio_dur = len(out["tts_speech"]) / self.sample_rate
            logger.info("yield speech len %.2f, rtf %f", audio_dur,
                        (time.time() - start) / max(audio_dur, 1e-6))
            yield out
            start = time.time()

    def inference_sft(self, tts_text: str, spk_id: str, stream: bool = False,
                      speed: float = 1.0, text_frontend: bool = True,
                      gen: Optional[torch.Generator] = None) -> Iterator[dict]:
        for seg in self._segments(tts_text, text_frontend):
            yield from self._run(self.frontend.frontend_sft(seg, spk_id), stream, speed, gen)

    def inference_zero_shot(self, tts_text: str, prompt_text: str,
                            prompt_speech_16k: np.ndarray, stream: bool = False,
                            speed: float = 1.0, text_frontend: bool = True,
                            gen: Optional[torch.Generator] = None) -> Iterator[dict]:
        prompt_text_n = (self.frontend.text_normalize(prompt_text, split=False)
                         if text_frontend else prompt_text)
        for seg in self._segments(tts_text, text_frontend):
            if len(seg) < 0.5 * len(prompt_text_n):
                logger.warning("synthesis text %s too short than prompt %s",
                               seg, prompt_text_n)
            yield from self._run(self.frontend.frontend_zero_shot(
                seg, prompt_text_n, prompt_speech_16k), stream, speed, gen)

    def inference_cross_lingual(self, tts_text: str, prompt_speech_16k: np.ndarray,
                                stream: bool = False, speed: float = 1.0,
                                text_frontend: bool = True,
                                gen: Optional[torch.Generator] = None) -> Iterator[dict]:
        for seg in self._segments(tts_text, text_frontend):
            yield from self._run(self.frontend.frontend_cross_lingual(seg, prompt_speech_16k),
                                 stream, speed, gen)

    def inference_instruct2(self, tts_text: str, instruct_text: str,
                            prompt_speech_16k: np.ndarray, stream: bool = False,
                            speed: float = 1.0, text_frontend: bool = True,
                            gen: Optional[torch.Generator] = None) -> Iterator[dict]:
        for seg in self._segments(tts_text, text_frontend):
            yield from self._run(self.frontend.frontend_instruct2(seg, instruct_text,
                                                                  prompt_speech_16k),
                                 stream, speed, gen)

    def inference_vc(self, source_speech_16k: np.ndarray, prompt_speech_16k: np.ndarray,
                     stream: bool = False, speed: float = 1.0) -> Iterator[dict]:
        mi = self.frontend.frontend_vc(source_speech_16k, prompt_speech_16k)
        m = self.model
        session = m.new_session()
        tokens = mi["source_speech_token"]
        args = (mi["flow_prompt_speech_token"], mi["prompt_speech_feat"], mi["flow_embedding"])
        if not stream:
            yield {"tts_speech": m.token2wav(tokens, *args, 0, session, finalize=True,
                                             speed=speed)}
            return
        hop, la = m.token_hop_len, m.pre_lookahead_len
        off = 0
        while len(tokens) - off >= hop + la:
            yield {"tts_speech": m.token2wav(tokens[:off + hop + la], *args, off, session,
                                             finalize=False)}
            off += hop
        yield {"tts_speech": m.token2wav(tokens, *args, off, session, finalize=True)}
