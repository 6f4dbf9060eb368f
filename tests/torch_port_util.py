"""Tiny CosyVoice2 stacks built twice from one set of weights: the JAX
package's modules (the reference) and the PyTorch port's, with the JAX
params carried over by cosyvoice_tpu_torch.convert.  Sizes follow
tests/test_runtime.py::build_tiny_stack, with 2 x 64 estimator heads so the
DiT attention kernel's path is taken."""
import json
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosyvoice_tpu.models import conformer as jconf
from cosyvoice_tpu.models import flow as jflow
from cosyvoice_tpu.models import hift as jhift
from cosyvoice_tpu.models import llm as jllm
from cosyvoice_tpu.models.qwen2 import Qwen2Config as JQwen2Config
from cosyvoice_tpu.utils.quant import quantize_qwen_int8
from cosyvoice_tpu_torch import convert
from cosyvoice_tpu_torch.models import campplus as tcamp
from cosyvoice_tpu_torch.models import conformer as tconf
from cosyvoice_tpu_torch.models import flow as tflow
from cosyvoice_tpu_torch.models import hift as thift
from cosyvoice_tpu_torch.models import llm as tllm
from cosyvoice_tpu_torch.models.qwen2 import Qwen2Config as TQwen2Config
from cosyvoice_tpu_torch.utils import onnx_io as tonnx

SPEECH_VOCAB = 24
N_MEL = 16
KEY = jax.random.PRNGKey(0)

QWEN = dict(vocab_size=300, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=8, intermediate_size=64, rope_theta=10000.0)
ENC = dict(dim=64, heads=4, linear_units=64, num_blocks=1, input_size=64,
           static_chunk_size=4)
HIFT = dict(in_channels=N_MEL, base_channels=32, nb_harmonics=2, upsample_rates=(4, 3),
            upsample_kernel_sizes=(8, 7), resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 3),), source_resblock_kernel_sizes=(5, 7),
            source_resblock_dilation_sizes=((1, 3), (1, 3)), f0_cond_channels=24,
            sampling_rate=2304)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread while a module that imports this fixture
    runs: the suite runs in several worker processes at once, and tiny eager
    ops with a thread a core each spin against the other workers' threads
    (six parallel runs of tests/test_torch_continuous.py's port-only cases
    did not finish in 900 s on 8 cores with the default, and took 30 s with
    one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def est_kwargs(fused: bool) -> dict:
    """Estimator config fields shared by both packages (each config adds the
    causal one-level topology, causal=True, channels=(32,))."""
    return dict(in_channels=4 * N_MEL, out_channels=N_MEL, n_blocks=1, num_mid_blocks=1,
                num_heads=2, attention_head_dim=64, fused_attention=fused,
                fused_norm=fused, approx_gelu=fused)


def jax_est_config(fused: bool):
    return jflow.EstimatorConfig(**est_kwargs(fused), causal=True, channels=(32,))


def torch_est_config(fused: bool):
    return tflow.EstimatorConfig(**est_kwargs(fused), causal=True, channels=(32,))


def random_params(init, *args, seed: int = 0, **kwargs):
    """A module's parameter tree drawn with numpy from the shapes of
    `init(*args, **kwargs)` alone (jax.eval_shape: nothing is compiled):
    LayerNorm scales, weight-norm gains and snake alphas/betas 1 + 0.2 N,
    biases 0.05 N, embedding tables N, other weights N / sqrt(fan_in)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        z = rng.standard_normal(shape).astype(np.float32)
        if name in ("scale", "g", "alpha", "beta"):
            return 1.0 + 0.2 * z
        if name == "bias":
            return 0.05 * z
        if name == "embedding":
            return z
        return z / np.sqrt(max(int(np.prod(shape[:-1])), 1))

    shapes = jax.eval_shape(lambda *a: init(*a, **kwargs), *args)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def interpret_pallas(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode on the CPU."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **dict(k, interpret=True)))


LM = dict(llm_input_size=32, llm_output_size=32, speech_token_size=SPEECH_VOCAB)


@lru_cache(maxsize=None)
def _lm_params():
    jfp = jllm.Qwen2LM(jllm.LMConfig(**LM, qwen=JQwen2Config(**QWEN)))
    return jax.jit(lambda k: jfp.init(k, jnp.zeros((1, 4), jnp.int32), jnp.asarray([4]),
                                      jnp.zeros((1, 3), jnp.int32), jnp.asarray([3])))(KEY)


def build_lm(quant: str = "none", fused: bool = False):
    """-> (jax model, jax params, port model); greedy sampling."""
    samp, lm = dict(method="greedy"), LM
    params = _lm_params()
    if quant == "int8":
        params = quantize_qwen_int8(params)
    jm = jllm.Qwen2LM(jllm.LMConfig(
        **lm, qwen=JQwen2Config(**QWEN, quant=quant, fused_cache_update=fused),
        sampling=jllm.SamplingConfig(**samp)))
    tm = tllm.Qwen2LM(tllm.LMConfig(
        **lm, qwen=TQwen2Config(**QWEN, quant=quant, fused_cache_update=fused),
        sampling=tllm.SamplingConfig(**samp)))
    tm.load_state_dict(convert.lm_state_from_jax(params), strict=True)
    return jm, params, tm.eval()


def flow_configs(fused: bool):
    jcfg = jflow.FlowConfig(
        input_size=64, output_size=N_MEL, spk_embed_dim=24, vocab_size=SPEECH_VOCAB + 3,
        encoder=jconf.ConformerConfig(**ENC, dropout_rate=0.0, attention_dropout_rate=0.0),
        estimator=jax_est_config(fused),
        cfm=jflow.CFMConfig(noise_frames=4000))
    tcfg = tflow.FlowConfig(
        input_size=64, output_size=N_MEL, spk_embed_dim=24, vocab_size=SPEECH_VOCAB + 3,
        encoder=tconf.ConformerConfig(**ENC),
        estimator=torch_est_config(fused),
        cfm=tflow.CFMConfig(noise_frames=4000))
    return jcfg, tcfg


@lru_cache(maxsize=None)
def _flow_params():
    # one Euler step: flax draws each parameter from its module path, so the
    # values equal those of the default ten-step trace, which compiles longer
    init = jflow.CausalMaskedDiffWithXvec(flow_configs(False)[0]).init
    return jax.jit(lambda k: init(
        k, jnp.zeros((1, 8), jnp.int32), jnp.asarray([8]), jnp.zeros((1, 4, N_MEL)),
        jnp.zeros((1, 24)), n_timesteps=1,
        method=jflow.CausalMaskedDiffWithXvec.inference))(KEY)


def build_flow(fused: bool = False):
    """-> (jax model, jax params, port model)."""
    jcfg, tcfg = flow_configs(fused)
    jm = jflow.CausalMaskedDiffWithXvec(jcfg)
    params = _flow_params()
    tm = tflow.CausalMaskedDiffWithXvec(tcfg)
    tm.load_state_dict(convert.flow_state_from_jax(params), strict=True)
    return jm, params, tm.eval()


def build_hift():
    """-> (jax deterministic model, jax params, port deterministic model)."""
    jm = jhift.HiFTGenerator(jhift.HiFTConfig(**HIFT), deterministic=True)
    # two frames: the params do not depend on the length, and compile sooner
    params = jax.jit(lambda k: jm.init({"params": k, "noise": k},
                                       jnp.zeros((1, 2, N_MEL))))(KEY)
    tm = thift.HiFTGenerator(thift.HiFTConfig(**HIFT), deterministic=True)
    tm.load_state_dict(convert.hift_state_from_jax(params), strict=True)
    return jm, params, tm.eval()


# ---- model-directory pieces (tests/test_torch_frontend_models.py,
# tests/test_torch_checkpoint.py) ----------

# a CAMPPlus with the released layout but few, narrow dense layers; an S3
# tokenizer of two 64-wide layers with 9 ids (fsq_dim 2)
CAMP = dict(feat_dim=80, embedding_size=24, growth_rate=4, bn_size=2, init_channels=8,
            blocks=((3, 3, 1), (4, 3, 2), (3, 3, 2)))
S3 = dict(dim=64, heads=4, layers=2, fsq_dim=2)


def prompt_wav(seconds: float, seed: int = 0) -> np.ndarray:
    """Two tones with a slow tremolo and a little noise, at 16 kHz."""
    t = np.arange(int(16000 * seconds)) / 16000.0
    noise = np.random.default_rng(seed).standard_normal(len(t))
    return (0.3 * np.sin(2 * np.pi * 220 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
            + 0.1 * np.sin(2 * np.pi * 443 * t) + 0.01 * noise).astype(np.float32)


def seeded_campplus(seed: int = 0) -> tcamp.CAMPPlus:
    """A port CAMPPlus with torch's default init and perturbed BatchNorm
    affines and running statistics (so eval-mode BN is not an identity)."""
    torch.manual_seed(seed)
    model = tcamp.CAMPPlus(tcamp.CAMPPlusConfig(**CAMP))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                m.running_mean += torch.randn_like(m.running_mean) * 0.1
                m.running_var *= torch.rand_like(m.running_var) * 0.5 + 0.75
                if m.affine:
                    m.weight += torch.randn_like(m.weight) * 0.1
                    m.bias += torch.randn_like(m.bias) * 0.1
    return model


def write_campplus_onnx(path: str, model: tcamp.CAMPPlus) -> None:
    """The export's initializers: every state_dict entry but BN's counter."""
    tonnx.write_onnx_tensors(path, {k: v.numpy() for k, v in model.state_dict().items()
                                    if not k.endswith("num_batches_tracked")})


CORPUS = ["hello world this is a test", "the quick brown fox", "Héllo café naïve résumé",
          "你好世界，今天天气很好。", "数字 12345 和 3.14", "I'm you're they've we'll it's don't",
          "  multiple   spaces\n\nand\tnewlines\r\n", "ÀÉÎÕÜ ñ ç ß"]

def tokenizer_dir(path, form: str) -> str:
    """A tokenizer.json trained with `tokenizers`: the GPT-2 form (ByteLevel
    with its regex, "<|endoftext|>" in the vocab) or Qwen2's (NFC, Split on
    Qwen2's regex, then ByteLevel without one; its three specials added past
    the vocab, as in Qwen2's file)."""
    from tokenizers import Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers, \
        trainers

    path.mkdir()
    tok = Tokenizer(models.BPE(unk_token=None))
    if form == "gpt2":
        tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
        specials = ["<|endoftext|>"]
    else:
        from cosyvoice_tpu_torch.tokenizer.text import QWEN2_PATTERN

        tok.normalizer = normalizers.NFC()
        tok.pre_tokenizer = pre_tokenizers.Sequence([
            pre_tokenizers.Split(Regex(QWEN2_PATTERN), behavior="isolated", invert=False),
            pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
        specials = []
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(CORPUS * 3, trainers.BpeTrainer(
        vocab_size=400, special_tokens=specials,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    if form == "qwen2":
        tok.add_special_tokens(["<|endoftext|>", "<|im_start|>", "<|im_end|>"])
    tok.save(str(path / "tokenizer.json"))
    (path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "PreTrainedTokenizerFast", "model_max_length": 512}))
    return str(path)


def seeded_state(module: torch.nn.Module, seed: int) -> dict:
    """A state dict for `module` under its (reference checkpoint) names, drawn
    with numpy: norm scales and weight-norm gains 1 + 0.2 N, biases 0.05 N,
    embedding tables N, BatchNorm running means 0.1 N and variances
    0.75 + 0.5 U, other tensors N / sqrt(their size a leading row);
    BatchNorm counters kept."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, v in module.state_dict().items():
        leaf, shape = name.rsplit(".", 1)[-1], tuple(v.shape)
        z = rng.standard_normal(shape).astype(np.float32)
        if leaf == "num_batches_tracked":
            out[name] = v.clone()
            continue
        if leaf == "running_var":
            a = 0.75 + 0.5 * rng.random(shape).astype(np.float32)
        elif leaf == "running_mean":
            a = 0.1 * z
        elif leaf in ("gamma", "weight_g") or (leaf == "weight" and len(shape) == 1):
            a = 1.0 + 0.2 * z
        elif leaf in ("bias", "beta"):
            a = 0.05 * z
        elif leaf == "weight" and isinstance(module.get_submodule(name.rsplit(".", 1)[0]),
                                             torch.nn.Embedding):
            a = z
        else:
            a = z / np.sqrt(max(int(np.prod(shape[1:])), 1))
        out[name] = torch.from_numpy(np.asarray(a, np.float32))
    return out


# ---- training (tests/test_torch_train.py, tests/test_torch_train_cli.py) ----
# the small widths of tests/test_train_cli.py's LM and flow recipe, plus the
# v1 LM and v1 flow at the same widths; registry sections of both packages

TRAIN_SECTIONS = {
    "qwen2lm": {"llm_input_size": 32, "llm_output_size": 32, "speech_token_size": 128,
                "qwen": {"vocab_size": 300, "hidden_size": 32, "num_layers": 1,
                         "num_heads": 4, "num_kv_heads": 2, "head_dim": 8,
                         "intermediate_size": 64}},
    "transformer_lm": {"text_encoder_input_size": 16, "llm_input_size": 32,
                       "llm_output_size": 32, "text_token_size": 300,
                       "speech_token_size": 128, "spk_embed_dim": 512,
                       "text_encoder": {"dim": 32, "heads": 2, "linear_units": 48,
                                        "num_blocks": 1, "input_size": 16,
                                        "static_chunk_size": 1,
                                        "attention_dropout_rate": 0.0},
                       "llm": {"dim": 32, "heads": 2, "linear_units": 48, "num_blocks": 1,
                               "input_size": 32, "static_chunk_size": 1,
                               "input_layer": "linear_legacy", "activation": "relu",
                               "attention_dropout_rate": 0.0}},
    "flow": {"input_size": 32, "output_size": 20, "spk_embed_dim": 512, "vocab_size": 128,
             "encoder": {"dim": 32, "heads": 2, "linear_units": 48, "num_blocks": 1,
                         "input_size": 32, "dropout_rate": 0.0,
                         "attention_dropout_rate": 0.0},
             "estimator": {"in_channels": 80, "out_channels": 20, "causal": True,
                           "channels": [16], "n_blocks": 1, "num_mid_blocks": 1,
                           "num_heads": 2, "attention_head_dim": 8},
             "cfm": {"noise_frames": 2000}},
    "flow_v1": {"input_size": 32, "output_size": 20, "spk_embed_dim": 512, "vocab_size": 128,
                "encoder": {"dim": 32, "heads": 2, "linear_units": 48, "num_blocks": 1,
                            "input_size": 32},
                "estimator": {"in_channels": 80, "out_channels": 20, "causal": False,
                              "channels": [16, 16], "n_blocks": 1, "num_mid_blocks": 1,
                              "num_heads": 2, "attention_head_dim": 8},
                "regulator_stages": 2},
}


def train_section(kind: str, **overrides) -> dict:
    """A deep copy of TRAIN_SECTIONS[kind] with top-level overrides and
    {"qwen": {...}} style nested ones merged in."""
    sec = json.loads(json.dumps(TRAIN_SECTIONS[kind]))
    for k, v in overrides.items():
        if isinstance(v, dict):
            sec[k] = dict(sec.get(k, {}), **v)
        else:
            sec[k] = v
    return sec


def write_train_corpus(dirpath, n: int = 3, seconds: float = 0.65, sr: int = 24000,
                       seed: int = 7) -> str:
    """A seeded jsonl corpus as tests/test_train_cli.py writes it (inline
    waveforms, 30 speech tokens, a 512-d embedding) and its shard list."""
    rng = np.random.default_rng(seed)
    jsonl = dirpath / "data.jsonl"
    with open(jsonl, "w") as f:
        for i in range(n):
            wav = (rng.standard_normal(int(sr * seconds)) * 0.1).tolist()
            f.write(json.dumps({"utt": f"u{i}", "text": "hello world", "speech": wav,
                                "sample_rate": sr,
                                "speech_token": rng.integers(0, 100, 30).tolist(),
                                "embedding": rng.standard_normal(512).tolist()}) + "\n")
    lst = dirpath / "train.list"
    lst.write_text(str(jsonl) + "\n")
    return str(lst)


FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def quick_jit(fn, *args):
    """`fn` jitted and compiled for `args` at XLA's lowest backend
    optimization level: a test's reference program runs once or a few
    times, so its compile is most of its cost (a tiny flow's value and
    gradient: 4.5 s at the default level, 2.5 s here; equal losses)."""
    jitted = fn if hasattr(fn, "lower") else jax.jit(fn)
    return jitted.lower(*args).compile(FAST_COMPILE)
