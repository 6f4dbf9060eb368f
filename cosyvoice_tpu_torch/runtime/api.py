"""User-facing APIs: CosyVoice2 (sft, zero-shot, cross-lingual, instruct2
and voice conversion) and CosyVoice v1 (sft, zero-shot, cross-lingual,
instruct and voice conversion).

Port of cosyvoice_tpu/runtime/api.py::CosyVoice2 and ::CosyVoice: each `inference_*`
normalizes and splits the text, then runs `model.tts()` a segment, logging
the RTF of each yielded chunk: one chunk a segment, or with `stream=True`
the segment's streamed chunks as they are synthesized.  `inference_vc` has
no LM stage: the source's speech tokens go through the flow and vocoder,
streamed in hop-sized chunks with `stream=True` (v1: hop-sized windows
with 20 tokens of overlap).  `from_pretrained` builds a CosyVoice2 from a
released-format model directory; like the JAX package, v1 has no loader.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from cosyvoice_tpu_torch import convert
from cosyvoice_tpu_torch.device import resolve_device
from cosyvoice_tpu_torch.models.campplus import (CAMPPlusConfig, import_campplus_onnx,
                                                 make_campplus_frontend_fn)
from cosyvoice_tpu_torch.models.flow import (CausalMaskedDiffWithXvec, FlowConfig,
                                             reference_rand_noise)
from cosyvoice_tpu_torch.models.hift import HiFTConfig, HiFTGenerator
from cosyvoice_tpu_torch.models.llm import LMConfig, Qwen2LM
from cosyvoice_tpu_torch.models.s3tokenizer import (S3Config, import_s3tokenizer_onnx,
                                                    make_s3_frontend_fn)
from cosyvoice_tpu_torch.runtime.frontend import CosyVoiceFrontEnd
from cosyvoice_tpu_torch.runtime.model import CosyVoice2Model, CosyVoiceV1Model
from cosyvoice_tpu_torch.tokenizer.text import QwenTokenizer
from cosyvoice_tpu_torch.utils.checkpoint import load_by_name
from cosyvoice_tpu_torch.utils.npz_io import load_params_npz
from cosyvoice_tpu_torch.utils.quant import quantize_qwen_int4, quantize_qwen_int8

logger = logging.getLogger(__name__)


@dataclass
class CosyVoice2:
    frontend: CosyVoiceFrontEnd
    model: CosyVoice2Model
    sample_rate: int = 24000
    # seconds `from_pretrained` took for each file it read (and the tokenizer)
    load_seconds: dict = field(default_factory=dict)

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


@dataclass
class CosyVoice:
    """The CosyVoice v1 API over CosyVoiceV1Model: the LM gets the speaker
    vector as its own input (none in the instruct mode)."""

    frontend: CosyVoiceFrontEnd
    model: CosyVoiceV1Model
    sample_rate: int = 22050

    def list_available_spks(self) -> list[str]:
        return list(self.frontend.spk2info.keys())

    def _segments(self, tts_text: str, text_frontend: bool) -> list:
        return self.frontend.text_normalize(tts_text) if text_frontend else [tts_text]

    def _run(self, model_input: dict, stream: bool, speed: float,
             gen: Optional[torch.Generator]) -> Iterator[dict]:
        ptext = model_input.get("prompt_text", np.zeros(0, np.int32))
        start = time.time()
        for out in self.model.tts(
                text_tokens=np.concatenate([ptext, model_input["text"]]).astype(np.int32),
                prompt_text_len=len(ptext),
                llm_prompt_speech_token=model_input.get(
                    "llm_prompt_speech_token", np.zeros(0, np.int32)),
                flow_prompt_speech_token=model_input.get(
                    "flow_prompt_speech_token", np.zeros(0, np.int32)),
                prompt_speech_feat=model_input.get(
                    "prompt_speech_feat",
                    np.zeros((0, self.model.flow.cfg.output_size), np.float32)),
                flow_embedding=model_input["flow_embedding"],
                llm_embedding=model_input.get("llm_embedding"),
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
            yield from self._run(self.frontend.frontend_zero_shot(
                seg, prompt_text_n, prompt_speech_16k), stream, speed, gen)

    def inference_cross_lingual(self, tts_text: str, prompt_speech_16k: np.ndarray,
                                stream: bool = False, speed: float = 1.0,
                                text_frontend: bool = True,
                                gen: Optional[torch.Generator] = None) -> Iterator[dict]:
        for seg in self._segments(tts_text, text_frontend):
            yield from self._run(self.frontend.frontend_cross_lingual(seg, prompt_speech_16k),
                                 stream, speed, gen)

    def inference_instruct(self, tts_text: str, spk_id: str, instruct_text: str,
                           stream: bool = False, speed: float = 1.0,
                           text_frontend: bool = True,
                           gen: Optional[torch.Generator] = None) -> Iterator[dict]:
        for seg in self._segments(tts_text, text_frontend):
            yield from self._run(self.frontend.frontend_instruct(seg, spk_id, instruct_text),
                                 stream, speed, gen)

    def inference_vc(self, source_speech_16k: np.ndarray, prompt_speech_16k: np.ndarray,
                     stream: bool = False, speed: float = 1.0) -> Iterator[dict]:
        mi = self.frontend.frontend_vc(source_speech_16k, prompt_speech_16k)
        m = self.model
        session = m.new_session()
        tokens = mi["source_speech_token"]
        args = (mi["flow_prompt_speech_token"], mi["prompt_speech_feat"], mi["flow_embedding"])
        if not stream:
            yield {"tts_speech": m.token2wav(tokens, *args, session, finalize=True,
                                             speed=speed)}
            return
        hop, lap = m.token_min_hop_len, m.token_overlap_len
        while len(tokens) >= hop + lap:
            yield {"tts_speech": m.token2wav(tokens[:hop + lap], *args, session,
                                             finalize=False)}
            tokens = tokens[hop:]
            hop = min(m.token_max_hop_len, int(hop * m.stream_scale_factor))
        yield {"tts_speech": m.token2wav(tokens, *args, session, finalize=True)}


def _weights_file(model_dir: str, stem: str) -> str:
    """`<stem>.npz` (a JAX parameter tree) when the directory has one, else
    `<stem>.pt` (a reference state_dict)."""
    npz = os.path.join(model_dir, f"{stem}.npz")
    return npz if os.path.exists(npz) else os.path.join(model_dir, f"{stem}.pt")


def _load_weights(module: torch.nn.Module, path: str, from_jax: Callable[[dict], dict],
                  strip: str = "") -> None:
    """A .npz through convert.py's `from_jax`, or a .pt with `strip` removed
    from its keys, loaded by name into `module`."""
    if path.endswith(".npz"):
        tensors = from_jax(load_params_npz(path))
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        tensors = {k.removeprefix(strip): v for k, v in sd.items()}
    load_by_name(module, tensors, path)


def _load_spk2info(model_dir: str) -> dict:
    """spk2info.npz (the JAX package's table) or spk2info.pt (the reference's
    sft speakers; loaded with weights_only) -> {spk: {"embedding": [D]}}."""
    npz = os.path.join(model_dir, "spk2info.npz")
    pt = os.path.join(model_dir, "spk2info.pt")
    if os.path.exists(npz):
        raw = load_params_npz(npz)
    elif os.path.exists(pt):
        raw = torch.load(pt, map_location="cpu", weights_only=True)
    else:
        return {}
    return {k: {"embedding": np.asarray(v["embedding"], np.float32).reshape(-1)}
            for k, v in raw.items()}


def from_pretrained(model_dir: str, tokenizer_path: Optional[str] = None,
                    max_decode_tokens: int = 1600, fp16: bool = False, quant: str = "none",
                    lm_cfg: Optional[LMConfig] = None, flow_cfg: Optional[FlowConfig] = None,
                    hift_cfg: Optional[HiFTConfig] = None,
                    campplus_cfg: Optional[CAMPPlusConfig] = None,
                    s3_cfg: Optional[S3Config] = None, reference_noise: bool = True,
                    flow_context_tokens: Optional[int] = None, device=None) -> CosyVoice2:
    """CosyVoice2 on `device` (None: the GPU; raises without one) from a
    released-format model directory:
      llm / flow / hift: `<stem>.npz` (a JAX parameter tree) if present, else
        `<stem>.pt` (hift.pt's `generator.` prefix stripped), loaded by name;
        a weight the module needs and the file lacks raises KeyError, and
        what the module does not read (a tied lm_head) is ignored;
      spk2info.npz or spk2info.pt: the sft speakers (optional);
      campplus.onnx, speech_tokenizer_v2.onnx: the speaker embedder and the
        speech tokenizer, each optional (without one, the modes that need it
        raise ValueError and sft still runs);
      the Qwen tokenizer from `tokenizer_path` or <dir>/CosyVoice-BlankEN.
    The knobs are the JAX package's (runtime/api.py::from_pretrained), the
    JAX "on a TPU" read as "on the card":
      fp16: a bf16 LM; a bf16 conformer encoder and estimator with
        tanh-gelu and, on the card, the fused DiT attention (K2); a bf16
        HiFT with the polynomial sine.  The LM's fused cache update (K1)
        and the fused LayerNorm (K3) stay as the configs have them (off by
        default), as in the JAX package;
      quant: "int8" or "int4" LM projections (int4 through K5), quantized
        after the bf16 cast, so the scales stay fp32;
      reference_noise: pin the reference's seed-0 CFM noise when the flow
        has 80 mel bins (the port's CFM slices the same buffer by default);
      max_decode_tokens, flow_context_tokens: as in CosyVoice2Model.
    The *_cfg keywords replace the full-size configurations (tests, smaller
    deployments).  `load_seconds` on the result times each file read."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    lm_cfg, flow_cfg = lm_cfg or LMConfig(), flow_cfg or FlowConfig()
    hift_cfg = hift_cfg or HiFTConfig()
    if quant not in ("none", "int8", "int4"):
        raise ValueError(f"quant must be none, int8 or int4, got {quant!r}")
    if fp16:
        flow_cfg = dataclasses.replace(
            flow_cfg, encoder_dtype="bfloat16", estimator=dataclasses.replace(
                flow_cfg.estimator, dtype="bfloat16", approx_gelu=True,
                fused_attention=on_card))
        hift_cfg = dataclasses.replace(hift_cfg, dtype="bfloat16", approx_sin=True)
    seconds: dict = {}

    def timed(name: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    with torch.device(device):          # build on the device: no host-side init
        llm = Qwen2LM(lm_cfg)
        flow = CausalMaskedDiffWithXvec(flow_cfg)
        hift = HiFTGenerator(hift_cfg)
    for module, stem, from_jax, strip in ((llm, "llm", convert.lm_state_from_jax, ""),
                                          (flow, "flow", convert.flow_state_from_jax, ""),
                                          (hift, "hift", convert.hift_state_from_jax,
                                           "generator.")):
        path = _weights_file(model_dir, stem)
        timed(os.path.basename(path), _load_weights, module, path, from_jax, strip)
    if fp16:
        llm.to(torch.bfloat16)
        flow.encoder.to(torch.bfloat16)
        flow.decoder.estimator.to(torch.bfloat16)
        hift.to(torch.bfloat16)
    if quant != "none":
        quantize = quantize_qwen_int8 if quant == "int8" else quantize_qwen_int4
        state = quantize(llm.state_dict())
        del llm
        with torch.device(device):
            llm = Qwen2LM(dataclasses.replace(lm_cfg, qwen=dataclasses.replace(
                lm_cfg.qwen, quant=quant)))
        llm.load_state_dict(state, strict=True, assign=True)  # int weights, fp32 scales
    flow_noise = None
    if reference_noise and flow_cfg.output_size == 80:
        flow_noise = reference_rand_noise(flow_cfg.cfm.noise_frames)
    model = CosyVoice2Model(llm=llm, flow=flow, hift=hift, max_decode_tokens=max_decode_tokens,
                            flow_noise=flow_noise, device=device,
                            flow_context_tokens=flow_context_tokens)
    tok = timed("tokenizer", QwenTokenizer,
                tokenizer_path or os.path.join(model_dir, "CosyVoice-BlankEN"))
    spk_embedder = speech_tokenizer = None
    path = os.path.join(model_dir, "campplus.onnx")
    if os.path.exists(path):
        spk_embedder = make_campplus_frontend_fn(timed(
            "campplus.onnx", import_campplus_onnx, path, campplus_cfg or CAMPPlusConfig(),
            device))
    path = os.path.join(model_dir, "speech_tokenizer_v2.onnx")
    if os.path.exists(path):
        speech_tokenizer = make_s3_frontend_fn(timed(
            "speech_tokenizer_v2.onnx", import_s3tokenizer_onnx, path, s3_cfg or S3Config(),
            device))
    frontend = CosyVoiceFrontEnd(tokenizer=tok, speech_tokenizer=speech_tokenizer,
                                 spk_embedder=spk_embedder, spk2info=_load_spk2info(model_dir),
                                 device=device)
    return CosyVoice2(frontend=frontend, model=model, load_seconds=seconds)
