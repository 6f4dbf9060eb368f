"""The port (and chip_smoke.py) stands alone: it imports neither JAX nor
the JAX package (nor optax / orbax: the training path keeps optax's
semantics in its own optimizer and saves with torch; nor `transformers` / `tokenizers` / `tiktoken`: it reads
tokenizer.json and the v1 ranks file itself; nor `yaml`: config.py reads
the recipes itself), and its entry points do not fall back to the CPU
unless asked to."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import sys
import cosyvoice_tpu_torch.runtime.api, cosyvoice_tpu_torch.convert
import cosyvoice_tpu_torch.utils.quant, cosyvoice_tpu_torch.tokenizer.text
import cosyvoice_tpu_torch.ops.kernels.lm_step, cosyvoice_tpu_torch.ops.kernels.int4_matmul
import cosyvoice_tpu_torch.models.llm
import cosyvoice_tpu_torch.runtime.serving, cosyvoice_tpu_torch.runtime.engine
import cosyvoice_tpu_torch.ops.kernels.dit_block
import cosyvoice_tpu_torch.models.bigvgan, cosyvoice_tpu_torch.ops.kernels.snake_aa
import cosyvoice_tpu_torch.ops.resample
import cosyvoice_tpu_torch.models.flow_chunk, cosyvoice_tpu_torch.runtime.flow_engine
import cosyvoice_tpu_torch.bin.serve, cosyvoice_tpu_torch.bin.inference
import cosyvoice_tpu_torch.utils.onnx_io, cosyvoice_tpu_torch.utils.npz_io
import cosyvoice_tpu_torch.utils.audio, cosyvoice_tpu_torch.utils.checkpoint
import cosyvoice_tpu_torch.ops.kaldi, cosyvoice_tpu_torch.models.campplus
import cosyvoice_tpu_torch.models.s3tokenizer
import cosyvoice_tpu_torch.models.conformer, cosyvoice_tpu_torch.models.flow
import cosyvoice_tpu_torch.ops.sampling, cosyvoice_tpu_torch.nn.norm
import cosyvoice_tpu_torch.models.llm_phoneme, cosyvoice_tpu_torch.models.llm_v1_phoneme
import cosyvoice_tpu_torch.tokenizer.phoneme, cosyvoice_tpu_torch.tokenizer.phoneme_frontend
import cosyvoice_tpu_torch.tokenizer.polyphone
import cosyvoice_tpu_torch.models.vits, cosyvoice_tpu_torch.models.speaker
import cosyvoice_tpu_torch.ops.splines, cosyvoice_tpu_torch.bin.extract_speaker_vec
from cosyvoice_tpu_torch.models.llm_v1_phoneme import TransformerLMPhonemeWithSpk
import cosyvoice_tpu_torch.models.llm_multicode, cosyvoice_tpu_torch.ops.delay
import cosyvoice_tpu_torch.models.decoder, cosyvoice_tpu_torch.config
from cosyvoice_tpu_torch.config import build_from_yaml, recipe_config
recipe_config("cosyvoice2/conf/cosyvoice2_multicode.yaml", "llm")
from cosyvoice_tpu_torch.models.vits import RECIPE
import chip_smoke
from cosyvoice_tpu_torch.runtime.api import CosyVoice
from cosyvoice_tpu_torch.runtime.model import CosyVoiceV1Model
from cosyvoice_tpu_torch.tokenizer.text import WhisperTiktokenTokenizer
import cosyvoice_tpu_torch.ops.block_attention, cosyvoice_tpu_torch.nn.dropout
import cosyvoice_tpu_torch.train.optim, cosyvoice_tpu_torch.train.ema
import cosyvoice_tpu_torch.train.step, cosyvoice_tpu_torch.train.packing
import cosyvoice_tpu_torch.train.checkpoint, cosyvoice_tpu_torch.train.executor
import cosyvoice_tpu_torch.data.pipeline, cosyvoice_tpu_torch.bin.train
import cosyvoice_tpu_torch.ops.f0, cosyvoice_tpu_torch.models.discriminator
import cosyvoice_tpu_torch.train.gan, cosyvoice_tpu_torch.utils.safetensors_io
import cosyvoice_tpu_torch.bin.average_model, cosyvoice_tpu_torch.bin.ckpt_resave
import cosyvoice_tpu_torch.bin.export_serving_lm
import cosyvoice_tpu_torch.train.lora, cosyvoice_tpu_torch.train.online_codec
import cosyvoice_tpu_torch.data.parquet_io, cosyvoice_tpu_torch.data.transcriber
import cosyvoice_tpu_torch.tokenizer.preprocess
import cosyvoice_tpu_torch.parallel.distributed, cosyvoice_tpu_torch.parallel.mesh
import cosyvoice_tpu_torch.parallel.collectives
bad = [m for m in sys.modules
       if m in ("jax", "flax", "cosyvoice_tpu", "transformers", "tokenizers", "tiktoken",
                "yaml", "optax", "orbax")
       or m.startswith(("jax.", "flax.", "cosyvoice_tpu.", "transformers.", "tokenizers.",
                        "tiktoken.", "yaml.", "optax.", "orbax."))]
print(",".join(bad))
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "", f"the port imported {out.stdout.strip()}"


def _tiny_model(device):
    from cosyvoice_tpu_torch.models.conformer import ConformerConfig
    from cosyvoice_tpu_torch.models.flow import CausalMaskedDiffWithXvec, FlowConfig
    from cosyvoice_tpu_torch.models.hift import HiFTConfig, HiFTGenerator
    from cosyvoice_tpu_torch.models.llm import LMConfig, Qwen2LM
    from cosyvoice_tpu_torch.models.qwen2 import Qwen2Config
    from cosyvoice_tpu_torch.runtime.model import CosyVoice2Model
    import torch_port_util as U

    llm = Qwen2LM(LMConfig(32, 32, U.SPEECH_VOCAB, qwen=Qwen2Config(**U.QWEN)))
    flow = CausalMaskedDiffWithXvec(FlowConfig(
        64, U.N_MEL, 24, U.SPEECH_VOCAB + 3, encoder=ConformerConfig(**U.ENC),
        estimator=U.torch_est_config(True)))
    return CosyVoice2Model(llm=llm, flow=flow, hift=HiFTGenerator(HiFTConfig(**U.HIFT)),
                           device=device)


@pytest.mark.parametrize("device", [None, "cuda"], ids=["default", "explicit_cuda"])
def test_entry_point_needs_gpu_unless_cpu_requested(device):
    if torch.cuda.is_available():
        pytest.skip("this check is for hosts without a GPU")
    from cosyvoice_tpu_torch.device import resolve_device

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(device)
    assert resolve_device("cpu").type == "cpu"


def test_model_raises_without_gpu_and_runs_on_cpu_when_asked():
    if torch.cuda.is_available():
        pytest.skip("this check is for hosts without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _tiny_model(None)
    model = _tiny_model("cpu")
    assert all(p.device.type == "cpu" for p in model.flow.parameters())


def test_frontend_raises_without_gpu_and_runs_on_cpu_when_asked():
    if torch.cuda.is_available():
        pytest.skip("this check is for hosts without a GPU")
    from cosyvoice_tpu_torch.runtime.frontend import CosyVoiceFrontEnd
    from cosyvoice_tpu_torch.tokenizer.text import ByteTokenizer

    with pytest.raises(RuntimeError, match="no CUDA device"):
        CosyVoiceFrontEnd(tokenizer=ByteTokenizer())
    fe = CosyVoiceFrontEnd(tokenizer=ByteTokenizer(), device="cpu")
    feat = fe._extract_speech_feat(np.zeros(4800, np.float32))
    assert fe.device.type == "cpu" and feat.shape == (10, 80)


def test_bigvgan_raises_without_gpu_and_runs_on_cpu_when_asked():
    if torch.cuda.is_available():
        pytest.skip("this check is for hosts without a GPU")
    from cosyvoice_tpu_torch.models.bigvgan import BigVGANConfig, load_bigvgan

    cfg = BigVGANConfig(vocab_size=30, input_size=16, output_size=16, mel_bin=8,
                        upsample_rates=(2,), upsample_kernel_sizes=(4,),
                        upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                        resblock_dilation_sizes=((1,),), speaker_embedding_dim=8,
                        use_pallas_act=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_bigvgan(cfg)
    model = load_bigvgan(cfg, device="cpu")
    wav, mel = model(torch.zeros(1, 5, dtype=torch.long), torch.tensor([5]),
                     torch.zeros(1, 8))
    assert wav.shape == (1, 10) and mel.shape == (1, 5, 8)


def test_v1_model_raises_without_gpu_and_runs_on_cpu_when_asked():
    if torch.cuda.is_available():
        pytest.skip("this check is for hosts without a GPU")
    from cosyvoice_tpu_torch.models.conformer import ConformerConfig
    from cosyvoice_tpu_torch.models.flow import (EstimatorConfig, FlowV1Config,
                                                 MaskedDiffWithXvec)
    from cosyvoice_tpu_torch.models.hift import HiFTConfig, HiFTGenerator
    from cosyvoice_tpu_torch.models.llm import TransformerLM, TransformerLMConfig
    from cosyvoice_tpu_torch.runtime.model import CosyVoiceV1Model
    import torch_port_util as U

    enc = ConformerConfig(32, 4, 48, 1, 32, static_chunk_size=1)
    llm = TransformerLM(TransformerLMConfig(32, 32, 32, 300, U.SPEECH_VOCAB, 24,
                                            text_encoder=enc, llm=enc))
    flow = MaskedDiffWithXvec(FlowV1Config(32, U.N_MEL, 24, U.SPEECH_VOCAB, encoder=enc,
                                           estimator=EstimatorConfig(
                                               4 * U.N_MEL, U.N_MEL, False, (16, 16), 1, 1,
                                               2, 8), regulator_stages=1))
    parts = dict(llm=llm, flow=flow, hift=HiFTGenerator(HiFTConfig(**U.HIFT)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CosyVoiceV1Model(**parts)
    model = CosyVoiceV1Model(**parts, device="cpu")
    assert all(p.device.type == "cpu" for p in model.llm.parameters())


def test_phoneme_engine_raises_without_gpu_and_runs_on_cpu_when_asked():
    if torch.cuda.is_available():
        pytest.skip("this check is for hosts without a GPU")
    from cosyvoice_tpu_torch.models.conformer import ConformerConfig
    from cosyvoice_tpu_torch.models.llm_phoneme import (PhonemeEmbedConfig, PhonemeLMConfig,
                                                        Qwen2LMPhonemeSrc2)
    from cosyvoice_tpu_torch.models.qwen2 import Qwen2Config
    from cosyvoice_tpu_torch.runtime.engine import GenRequest, ServingEngine
    import torch_port_util as U

    llm = Qwen2LMPhonemeSrc2(PhonemeLMConfig(
        32, 32, U.SPEECH_VOCAB, 24, phoneme=PhonemeEmbedConfig(30, 12, 16, 8, 2, 2, 6, 2),
        encoder=ConformerConfig(32, 4, 48, 1, 24), qwen=Qwen2Config(**U.QWEN),
        fusion_heads=4, fusion_ffn=48))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(llm)
    engine = ServingEngine(llm, num_slots=1, cache_len=160, max_out=4, device="cpu")
    req = GenRequest(text=np.arange(5), prompt_speech=np.arange(3),
                     pho_token=np.zeros((6, 4), np.int64), embedding=np.ones(24, np.float32),
                     min_len=4, max_len=4)
    (tokens,) = engine.generate([req])
    assert len(tokens) <= 4 and (tokens < U.SPEECH_VOCAB).all()


def test_vits_and_speaker_loaders_raise_without_gpu_and_run_on_cpu_when_asked():
    if torch.cuda.is_available():
        pytest.skip("this check is for hosts without a GPU")
    from cosyvoice_tpu_torch.models.campplus import CAMPPlusConfig
    from cosyvoice_tpu_torch.models.speaker import (SpeakerEmbeddingConfig,
                                                    load_speaker_embedding, speaker_embed)
    from cosyvoice_tpu_torch.models.vits import VitsConfig, load_vits
    import torch_port_util as U

    vcfg = VitsConfig(n_vocab=30, spec_channels=9, inter_channels=8, hidden_channels=8,
                      filter_channels=8, n_heads=2, n_layers=1, resblock_kernel_sizes=(3,),
                      resblock_dilation_sizes=((1,),), upsample_rates=(2,),
                      upsample_initial_channel=8, upsample_kernel_sizes=(4,), gin_channels=4)
    scfg = SpeakerEmbeddingConfig(spec_channels=33, inter_channels=8, hidden_channels=8,
                                  speaker_emb_dim=8, hop_length=48, filter_length=64,
                                  campplus=CAMPPlusConfig(**U.CAMP), style_hidden=8,
                                  style_layers=1, gst_tokens=4, gst_heads=2, gst_layers=1)
    for load, cfg in ((load_vits, vcfg), (load_speaker_embedding, scfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load(cfg)
    wav = load_vits(vcfg, device="cpu").inference(
        torch.zeros(1, 5, dtype=torch.long), torch.tensor([5]), torch.zeros(1, 4),
        gen=torch.Generator().manual_seed(0))
    assert wav.shape == (1, 10)
    vec = speaker_embed(load_speaker_embedding(scfg, device="cpu"), np.zeros(4800, np.float32),
                        gen=torch.Generator().manual_seed(0))
    assert vec.shape == (8,) and np.isfinite(vec).all()
