"""The port's data and tensor parallelism (cosyvoice_tpu_torch/parallel) on
CPU clusters, against the JAX package on one device.

A cluster is torch.multiprocessing.spawn of tests/torch_parallel_worker.py
over gloo with a file:// store, each with its own time limit; the JAX
references run once in this process and reach the ranks as the port's
modules and numpy arrays.  The counterparts of tests/test_parallel.py
(mesh shapes and rules, greedy DP x TP decode, BatchedSynthesizer on a
mesh, the sharded train step, the full-size shard fraction),
tests/test_multihost.py (the executor on two ranks, uneven shards) and
tests/test_engine.py's flow_device case; then what the JAX package runs on a
mesh beyond those: int4 / int4xla weights under TP, a phoneme LM's and a
LoRA overlay's DP x TP steps, the train CLI with --lora and a phoneme kind
on two ranks.  Each test states its bar.
"""
import copy
import time
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import yaml

import test_torch_pho_train as P
import torch_parallel_worker as W
import torch_port_util as U
from torch_port_util import (one_torch_thread, quick_jit,  # noqa: F401 (autouse)
                             random_params, train_section, write_train_corpus)
from cosyvoice_tpu import config as jconfig
from cosyvoice_tpu.models import flow as jflow
from cosyvoice_tpu.models import hift as jhift
from cosyvoice_tpu.models import llm as jllm
from cosyvoice_tpu.models.qwen2 import Qwen2Config as JQwen2Config
from cosyvoice_tpu.models.qwen2 import causal_prefill_bias
from cosyvoice_tpu.runtime import serving as JS
from cosyvoice_tpu.runtime.model import CosyVoice2Model as JModel
from cosyvoice_tpu.train import lora as jlora
from cosyvoice_tpu.train import optim as joptim
from cosyvoice_tpu.train import step as jstep
from cosyvoice_tpu.utils import quant as jquant
from cosyvoice_tpu.utils.quant import quantize_qwen_int8
from cosyvoice_tpu_torch import config as tconfig
from cosyvoice_tpu_torch import convert
from cosyvoice_tpu_torch.models import flow as tflow
from cosyvoice_tpu_torch.models import hift as thift
from cosyvoice_tpu_torch.models import llm as tllm
from cosyvoice_tpu_torch.models.flow import FlowDraws
from cosyvoice_tpu_torch.models.qwen2 import Qwen2Config as TQwen2Config
from cosyvoice_tpu_torch.parallel.mesh import (LM_RULES, Mesh, make_mesh, param_shardings,
                                               shard_params, sharded_bytes_fraction,
                                               sharded_dim)
from cosyvoice_tpu_torch.runtime import serving as TS
from cosyvoice_tpu_torch.runtime.model import CosyVoice2Model as TModel
from cosyvoice_tpu_torch.train import checkpoint as tckpt
from cosyvoice_tpu_torch.train import optim as toptim
from cosyvoice_tpu_torch.train import step as tstep
from cosyvoice_tpu_torch.train.lora import (LoRAConfig, LoRAOverlay, lora_loss_fn,
                                            read_lora_npz)

KEY = jax.random.PRNGKey(0)
CLUSTER_SECONDS = 120
OPT = dict(optim="adam", lr=1e-3, scheduler="warmuplr", scheduler_kwargs={"warmup_steps": 3},
           grad_clip=0.05)
# the tiny LM with a speech head of 28 rows, which model = 2 and 4 divide
GEN_LM = dict(llm_input_size=32, llm_output_size=32, speech_token_size=25)
GEN_QWEN = dict(U.QWEN, vocab_size=120)
# (text, speech) lengths a row: data rank 0's rows hold many more targets
TRAIN_ROWS = [(5, 14), (6, 12), (4, 3), (3, 2)]


class Cluster:
    """`world` ranks of torch_parallel_worker.run_<name> on `inputs`, started
    at once (the JAX references run meanwhile); result() waits, and kills the
    ranks and fails the test CLUSTER_SECONDS after the start."""

    def __init__(self, name: str, world: int, tmp_path, inputs: dict):
        torch.save(inputs, tmp_path / "inputs.pt")
        self.name, self.world, self.tmp = name, world, tmp_path
        self.deadline = time.monotonic() + CLUSTER_SECONDS
        self.ctx = mp.start_processes(W.entry, args=(world, name, str(tmp_path)),
                                      nprocs=world, join=False, start_method="spawn")
        self.out = None

    def result(self) -> list:
        if self.out is None:
            while not self.ctx.join(timeout=1.0):
                if time.monotonic() > self.deadline:
                    for p in self.ctx.processes:
                        p.kill()
                    pytest.fail(f"cluster {self.name} did not finish in {CLUSTER_SECONDS} s")
            self.out = [torch.load(self.tmp / f"out{r}.pt", weights_only=False)
                        for r in range(self.world)]
        return self.out


def _lm_batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    B, Tt, Ts = len(TRAIN_ROWS), max(t for t, _ in TRAIN_ROWS), max(s for _, s in TRAIN_ROWS)
    b = {"text_token": np.zeros((B, Tt), np.int32), "speech_token": np.zeros((B, Ts), np.int32),
         "text_token_len": np.array([t for t, _ in TRAIN_ROWS], np.int32),
         "speech_token_len": np.array([s for _, s in TRAIN_ROWS], np.int32)}
    for i, (t, s) in enumerate(TRAIN_ROWS):
        b["text_token"][i, :t] = rng.integers(0, 300, t)
        b["speech_token"][i, :s] = rng.integers(0, 129, s)
    return b


def _flow_batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    tok_len = np.array([10, 9, 4, 3], np.int32)
    return {"speech_token": rng.integers(0, 128, (4, 10)).astype(np.int32),
            "speech_token_len": tok_len,
            "speech_feat": rng.standard_normal((4, 20, 20)).astype(np.float32),
            "speech_feat_len": 2 * tok_len,
            "embedding": rng.standard_normal((4, 512)).astype(np.float32)}


def _jax_flow_draws(rng, B: int, T: int, C: int, cfg_rate: float) -> dict:
    """The JAX flow's draws from its cfm key (tests/test_torch_train.py)."""
    k_on, k_len, k_cfm = jax.random.split(rng, 3)
    k_t, k_z, k_cfg = jax.random.split(k_cfm, 3)
    return dict(use_cond=np.asarray(jax.random.bernoulli(k_on, 0.5, (B,))),
                frac=np.asarray(jax.random.uniform(k_len, (B,))),
                t=np.asarray(jax.random.uniform(k_t, (B, 1, 1), jnp.float32)[:, 0, 0]),
                z=np.asarray(jax.random.normal(k_z, (B, T, C), jnp.float32)),
                keep=np.asarray(jax.random.uniform(k_cfg, (B,)) > cfg_rate))


def _jax_steps(kind: str, sec: dict, params, batches: list, loss_fn, lora_names=None) -> tuple:
    """The JAX package's make_train_step over the global batches, step i on
    PRNGKey(i) -> (metrics, final params; a LoRA overlay's, under the port's
    names, with `lora_names`)."""
    jtx, _ = joptim.make_optimizer(OPT["optim"], OPT["lr"], OPT["scheduler"],
                                   OPT["scheduler_kwargs"], grad_clip=OPT["grad_clip"])
    st = jstep.make_train_state(params, jtx)
    fn = jstep.make_train_step(loss_fn, jtx, donate=False)
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    fn = quick_jit(fn, st, jb[0], KEY)
    metrics = []
    for i, b in enumerate(jb):
        st, m = fn(st, b, jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, convert.train_state_from_jax(kind, st.params, lora_names=lora_names)


def _port(kind: str, sec: dict, params):
    tm, _ = tconfig.build_model(kind, sec)
    tm.load_state_dict(convert.train_state_from_jax(kind, params), strict=True)
    return tm


def _requests(cls, rng):
    return [cls(text_tokens=rng.integers(0, 250, n).astype(np.int32), prompt_text_len=0,
                prompt_speech_tokens=rng.integers(0, U.SPEECH_VOCAB, p).astype(np.int32),
                prompt_feat=(rng.standard_normal((2 * p, U.N_MEL)) * 0.3).astype(np.float32),
                embedding=rng.standard_normal(24).astype(np.float32))
            for n, p in [(16, 4), (11, 2), (8, 6)]]


@lru_cache(maxsize=None)
def _lm_setup():
    """The train recipe's LM (speech head 132 rows) from one seeded tree, and
    three global batches."""
    sec = train_section("qwen2lm", speech_token_size=129)
    jm, _ = jconfig.build_model("qwen2lm", sec)
    batches = [_lm_batch(s) for s in (1, 2, 3)]
    params = random_params(jm.init, KEY, *(jnp.asarray(batches[0][k]) for k in (
        "text_token", "text_token_len", "speech_token", "speech_token_len")), seed=5)
    return sec, jm, params, batches


@lru_cache(maxsize=None)
def _gen_setup():
    """A 4-row greedy decode's JAX LM, its params and arrays."""
    jm = jllm.Qwen2LM(jllm.LMConfig(**GEN_LM, qwen=JQwen2Config(**GEN_QWEN),
                                    sampling=jllm.SamplingConfig(method="greedy")))
    rng = np.random.default_rng(2)
    text = rng.integers(0, 120, (4, 6)).astype(np.int32)
    tl = np.array([6, 4, 5, 3], np.int32)
    psp = rng.integers(0, 25, (4, 4)).astype(np.int32)
    arrays = [text, tl, psp, np.array([4, 2, 3, 4], np.int32), np.full(4, 4, np.int32),
              np.full(4, 20, np.int32)]
    params = random_params(jm.init, KEY, jnp.asarray(text), jnp.asarray(tl),
                           jnp.asarray(text), jnp.asarray(tl), seed=9)
    return jm, params, arrays


@lru_cache(maxsize=None)
def _flow_setup():
    """The train recipe's flow from one seeded tree, two global batches and
    the JAX flow's draws for each (from PRNGKey(step))."""
    fsec = train_section("flow")
    jm, jcfg = jconfig.build_model("flow", fsec)
    fbatches = [_flow_batch(s) for s in (4, 5)]
    names = ("speech_token", "speech_token_len", "speech_feat", "speech_feat_len", "embedding")
    fparams = random_params(jm.init, KEY, *(jnp.asarray(fbatches[0][k]) for k in names), KEY,
                            deterministic=True, seed=41)
    draws = [_jax_flow_draws(jax.random.PRNGKey(i), 4, 20, 20, jcfg.cfm.training_cfg_rate)
             for i in range(len(fbatches))]
    return fsec, jm, fparams, fbatches, draws


@lru_cache(maxsize=None)
def _stack_params():
    """Seeded parameter trees of the tiny serving stack (numpy draws over the
    JAX inits' shapes: nothing compiles): the LM quantized to int8, the
    flow, the HiFT."""
    z = lambda *shape: jnp.zeros(shape, jnp.int32)  # noqa: E731
    jlm = jllm.Qwen2LM(jllm.LMConfig(**U.LM, qwen=JQwen2Config(**U.QWEN)))
    lm = quantize_qwen_int8(random_params(jlm.init, KEY, z(1, 4), jnp.asarray([4]), z(1, 3),
                                          jnp.asarray([3]), seed=11))
    jf = jflow.CausalMaskedDiffWithXvec(U.flow_configs(False)[0])
    flow = random_params(jf.init, KEY, z(1, 8), jnp.asarray([8]), jnp.zeros((1, 4, U.N_MEL)),
                         jnp.zeros((1, 24)), n_timesteps=1,
                         method=jflow.CausalMaskedDiffWithXvec.inference, seed=12)
    jh = jhift.HiFTGenerator(jhift.HiFTConfig(**U.HIFT), deterministic=True)
    hift = random_params(jh.init, {"params": KEY, "noise": KEY}, jnp.zeros((1, 2, U.N_MEL)),
                         seed=13)
    return lm, flow, hift


def _stack():
    """(JAX model, port model) of the tiny serving stack: the int8 LM (the
    port's on the packed cache), the flow, pinned noise, deterministic HiFT."""
    lm, flow, hift = _stack_params()
    greedy = dict(method="greedy")
    jlm = jllm.Qwen2LM(jllm.LMConfig(**U.LM, qwen=JQwen2Config(**U.QWEN, quant="int8"),
                                     sampling=jllm.SamplingConfig(**greedy)))
    tlm = tllm.Qwen2LM(tllm.LMConfig(**U.LM, qwen=TQwen2Config(**U.QWEN, quant="int8",
                                                               fused_cache_update=True),
                                     sampling=tllm.SamplingConfig(**greedy)))
    tlm.load_state_dict(convert.lm_state_from_jax(lm), strict=True)
    jcfg, tcfg = U.flow_configs(False)
    tflow_m = tflow.CausalMaskedDiffWithXvec(tcfg)
    tflow_m.load_state_dict(convert.flow_state_from_jax(flow), strict=True)
    thift_m = thift.HiFTGenerator(thift.HiFTConfig(**U.HIFT), deterministic=True)
    thift_m.load_state_dict(convert.hift_state_from_jax(hift), strict=True)
    noise = np.random.default_rng(9).standard_normal((1, 4000, U.N_MEL)).astype(np.float32)
    jmodel = JModel(llm=jlm, flow=jflow.CausalMaskedDiffWithXvec(jcfg),
                    hift=jhift.HiFTGenerator(jhift.HiFTConfig(**U.HIFT), deterministic=True),
                    llm_params=lm, flow_params=flow, hift_params=hift,
                    max_decode_tokens=96, flow_noise=noise)
    tmodel = TModel(llm=tlm.eval(), flow=tflow_m.eval(), hift=thift_m.eval(),
                    max_decode_tokens=96, flow_noise=torch.from_numpy(noise), device="cpu")
    return jmodel, tmodel


def _cli_argv(tmp) -> list:
    """The train CLI over a 4-utterance corpus, static batches of 2."""
    corpus = tmp / "corpus"
    corpus.mkdir()
    lst = write_train_corpus(corpus, n=4)
    cfg = corpus / "qwen2lm.yaml"
    cfg.write_text(yaml.safe_dump({
        "llm": dict(train_section("qwen2lm", speech_token_size=129), kind="qwen2lm"),
        "data": {"filter": {"max_length": 99999, "token_max_length": 300},
                 "fbank": {"n_fft": 192, "hop": 48, "n_mels": 20},
                 "batch_type": "static", "batch_size": 2, "shuffle_buf": 4, "sort_buf": 2},
        "train_conf": {"lr": 1e-4, "log_interval": 1,
                       "scheduler_conf": {"warmup_steps": 10}}}, default_flow_style=False))
    return ["--config", str(cfg), "--model", "llm", "--train_data", lst,
            "--model_dir", str(tmp / "cli"), "--epochs", "1", "--device", "cpu"]


EXEC_BATCHES = (7, 8, 9)
# int4 / int4xla LMs of the greedy decode's widths under TP(2): at group 16
# every block shards (local attention and MLP inputs 16 and 32 rows); at
# group 32 attention's 16 local rows are half a group, so it stays whole
QUANT_LMS = [("int4", 16), ("int4", 32), ("int4xla", 16), ("int4xla", 32)]
# LoRA on both kinds of projection: q / gate column-parallel, o / down row-parallel
LORA_CFG = dict(r=4, alpha=8, target_patterns=(
    r".*/(q_proj|o_proj|gate_proj|down_proj)/kernel$",))
LORA_SEED = 3
# sharded_bytes_fraction of the full-size int4 / int4xla LM at model 2 and 4:
# the fp32 vocabularies carry most of the bytes at model 4
FULL_INT4_FRACTIONS = {"int4": (0.96971, 0.75654), "int4xla": (0.95243, 0.61568)}


@lru_cache(maxsize=None)
def _quant_params(quant: str, group: int):
    """The greedy decode's JAX weights quantized by the JAX package."""
    _, gparams, _ = _gen_setup()
    fn = jquant.quantize_qwen_int4 if quant == "int4" else jquant.quantize_qwen_int4xla
    return fn(gparams, group_size=group)


def _quant_lm(quant: str, group: int):
    """The greedy decode's LM over _quant_params (the same quantized weights
    as the JAX reference), in the port."""
    lm = tllm.Qwen2LM(tllm.LMConfig(**GEN_LM, qwen=TQwen2Config(
        **GEN_QWEN, quant=quant, quant_group=group, fused_cache_update=True),
        sampling=tllm.SamplingConfig(method="greedy")))
    lm.load_state_dict(convert.lm_state_from_jax(_quant_params(quant, group)), strict=True)
    return lm.eval()


@lru_cache(maxsize=None)
def _pho_setup():
    """qwen2lm_phoneme_src2 at tests/test_torch_pho_train.py's widths (dropout
    0, so a step is a function of the batch): the JAX module and its seeded
    params."""
    jm, params, _ = P._models("qwen2lm_phoneme_src2", P.pho_section(), seed=21)
    return jm, params


def _pho_lm():
    """The port's qwen2lm_phoneme_src2 over _pho_setup's params."""
    return _port("qwen2lm_phoneme_src2", P.pho_section(), _pho_setup()[1])


@lru_cache(maxsize=None)
def _lora_setup():
    """A JAX overlay (init_lora: a drawn, b = 0) over the train recipe's LM
    and the port's copy of it ({name: {"a", "b"}})."""
    sec, _, params, _ = _lm_setup()
    jcfg = jlora.LoRAConfig(**LORA_CFG)
    jov = jlora.init_lora(params, jcfg, jax.random.PRNGKey(LORA_SEED))
    jov = {p: {k: np.asarray(v) for k, v in ab.items()} for p, ab in jov.items()}
    names = [n for n, _ in _port("qwen2lm", sec, params).named_parameters()]
    return jcfg, jov, convert.lora_overlay_from_jax(jov, names), names


def _pho_batch(seed: int) -> dict:
    """Four ragged phoneme-LM rows; data rank 0's hold more targets."""
    rng = np.random.default_rng(seed)
    sl = np.array([8, 7, 3, 2], np.int32)
    return {"text_token": rng.integers(0, 300, (4, 6)).astype(np.int32),
            "text_token_len": np.array([5, 3, 6, 2], np.int32),
            "pho_token": P._pho_tokens(rng, 4, 9),
            "pho_token_len": np.array([7, 4, 9, 3], np.int32),
            "speech_token": rng.integers(0, 24, (4, 8)).astype(np.int32),
            "speech_token_len": sl,
            "embedding": rng.standard_normal((4, 16)).astype(np.float32)}


PHO_BATCHES = (31, 32)


def _cli_extra_argv(tmp, argv: list) -> tuple:
    """The train CLI's LoRA run (argv's corpus, --lora) and a phoneme LM's
    run over tests/test_torch_pho_train.py's speaker-JSON corpus."""
    lora = list(argv)
    lora[lora.index("--model_dir") + 1] = str(tmp / "cli_lora")
    pho_dir = tmp / "pho"
    pho_dir.mkdir()
    lst, dict_path = P.write_spk_json_corpus(pho_dir)
    pho = ["--config", P._pho_conf(pho_dir, dict_path), "--model", "llm", "--train_data", lst,
           "--model_dir", str(tmp / "cli_pho"), "--data_format", "spk_json", "--epochs", "1",
           "--device", "cpu"]
    return lora + ["--lora"], pho


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """Both clusters, started together before any JAX reference runs: DP(2)
    x TP(2) on four ranks and DP(2) on two."""
    sec, _, params, batches = _lm_setup()
    port_lm = lambda: _port("qwen2lm", sec, params)  # noqa: E731
    _, gparams, arrays = _gen_setup()
    gen_lm = tllm.Qwen2LM(tllm.LMConfig(**GEN_LM, qwen=TQwen2Config(**GEN_QWEN,
                                                                    fused_cache_update=True),
                                        sampling=tllm.SamplingConfig(method="greedy")))
    gen_lm.load_state_dict(convert.lm_state_from_jax(gparams), strict=True)
    tmp4 = tmp_path_factory.mktemp("dp_tp")
    four = Cluster("dp_tp", 4, tmp4, {
        "gen_lm": gen_lm.eval(), "gen_args": {"arrays": arrays, "max_steps": 24,
                                              "cache_len": 64},
        "stack": _stack()[1], "requests": _requests(TS.TTSRequest, np.random.default_rng(4)),
        "train_lm": port_lm(), "train_batches": batches, "fresh_lm": port_lm(), "opt": OPT,
        "quant_lms": {f"{q}_g{g}": _quant_lm(q, g) for q, g in QUANT_LMS},
        "pho_lm": _pho_lm(), "pho_batches": [_pho_batch(s) for s in PHO_BATCHES],
        "lora_lm": port_lm(), "lora_scale": (LORA_CFG["r"], LORA_CFG["alpha"]),
        "lora_pairs": _lora_setup()[2]})
    fsec, _, fparams, fbatches, draws = _flow_setup()
    tmp2 = tmp_path_factory.mktemp("dp")
    argv = _cli_argv(tmp2)
    lora_argv, pho_argv = _cli_extra_argv(tmp2, argv)
    two = Cluster("dp", 2, tmp2, {
        "train_lm": port_lm(), "train_batches": batches, "opt": OPT,
        "flow": _port("flow", fsec, fparams), "flow2": _port("flow", fsec, fparams),
        "flow_batches": fbatches, "flow_draws": draws,
        "exec_batches": [_lm_batch(s) for s in EXEC_BATCHES], "exec_lm_0": port_lm(),
        "exec_lm_1": port_lm(), "cli_argv": argv, "cli_lora_argv": lora_argv,
        "cli_pho_argv": pho_argv})
    return {"dp_tp": four, "dp": two, "argv": argv, "tmp4": tmp4, "tmp2": tmp2}


@pytest.fixture(scope="module")
def lm_train(clusters):
    """The JAX package's three global-batch LM steps -> (metrics, params)."""
    sec, jm, params, batches = _lm_setup()
    return _jax_steps("qwen2lm", sec, params, batches, jstep.llm_loss_fn(jm))


@pytest.fixture(scope="module")
def gen_ref(clusters):
    """Greedy single-device JAX lm_generate of the 4-row batch (fp32)."""
    jm, params, arrays = _gen_setup()
    out, count = jllm.lm_generate(jm, params, *(jnp.asarray(a) for a in arrays), KEY,
                                  max_steps=24, cache_len=64)
    return np.asarray(out), np.asarray(count)


@pytest.fixture(scope="module")
def dp_tp(clusters):
    """The DP(2) x TP(2) cluster's results, the single-device JAX
    BatchedSynthesizer's wavs and the cluster's directory."""
    jmodel = _stack()[0]
    wavs = JS.BatchedSynthesizer(jmodel, text_bucket=8, speech_bucket=8).synthesize_batch(
        _requests(JS.TTSRequest, np.random.default_rng(4)), rng=jax.random.PRNGKey(2))
    return clusters["dp_tp"].result(), wavs, clusters["tmp4"]


@pytest.fixture(scope="module")
def dp(clusters):
    """The DP(2) cluster's results, and the JAX flow's loss and gradient norm
    at the first step's parameters, batch and draws."""
    fsec, jm, fparams, fbatches, draws = _flow_setup()
    names = ("speech_token", "speech_token_len", "speech_feat", "speech_feat_len", "embedding")
    args = tuple(jnp.asarray(fbatches[0][k]) for k in names)
    vg = jax.value_and_grad(lambda p, *a: jm.apply(p, *a, jax.random.PRNGKey(0),
                                                   deterministic=True)["loss"])
    loss, grads = quick_jit(vg, fparams, *args)(fparams, *args)
    gnorm = float(jnp.sqrt(sum(jnp.sum(g * g) for g in jax.tree_util.tree_leaves(grads))))
    return (clusters["dp"].result(),
            dict(fsec=fsec, fparams=fparams, jax_first=(float(loss), gnorm), draws=draws,
                 fbatches=fbatches, exec_batches=[_lm_batch(s) for s in EXEC_BATCHES],
                 argv=clusters["argv"], tmp=clusters["tmp2"]))


@pytest.fixture(scope="module")
def quant_ref(clusters):
    """Single-device JAX greedy lm_generate of the 4-row batch over each of
    QUANT_LMS's quantized weights, and its prefix logits (fp32)."""
    _, _, arrays = _gen_setup()
    a = [jnp.asarray(x) for x in arrays]
    out = {}
    for quant, group in QUANT_LMS:
        jm = jllm.Qwen2LM(jllm.LMConfig(**GEN_LM, qwen=JQwen2Config(
            **GEN_QWEN, quant=quant, quant_group=group),
            sampling=jllm.SamplingConfig(method="greedy")))
        params = _quant_params(quant, group)
        tokens, count = jllm.lm_generate(jm, params, *a, KEY, max_steps=24, cache_len=64)

        def logits(p, text, tl, psp, pl, jm=jm):
            emb, seq_len = jm.apply(p, text, tl, psp, pl, method=jllm.Qwen2LM.prefill_embeds)
            B, T = emb.shape[:2]
            pos = jnp.broadcast_to(jnp.arange(T)[None], (B, T))
            h, _ = jm.apply(p, emb, pos, causal_prefill_bias(T, T, seq_len, B),
                            method=jllm.Qwen2LM.forward_hidden)
            return jm.apply(p, h, method=jllm.Qwen2LM.decode_logits)

        out[(quant, group)] = (np.asarray(tokens), np.asarray(count),
                               np.asarray(jax.jit(logits)(params, *a[:4])))
    return out


def _jax_pho_loss(jm):
    def loss_fn(p, batch, rng):
        out = jm.apply(p, *(batch[k] for k in P.ARGS), rng, deterministic=False,
                       rngs={"dropout": rng})
        return out["loss"], {"acc": out["acc"]}
    return loss_fn


@pytest.fixture(scope="module")
def pho_train(clusters):
    """The JAX package's phoneme-LM steps over the global batches ->
    (metrics, params)."""
    jm, params = _pho_setup()
    return _jax_steps("qwen2lm_phoneme_src2", P.pho_section(), params,
                      [_pho_batch(s) for s in PHO_BATCHES], _jax_pho_loss(jm))


@pytest.fixture(scope="module")
def lora_train(clusters):
    """The JAX package's LoRA steps (its lora_loss_fn over the train
    recipe's LM) over the global batches -> (metrics, the overlay under the
    port's names)."""
    sec, jm, params, batches = _lm_setup()
    jcfg, jov, _, names = _lora_setup()
    return _jax_steps("qwen2lm", sec, jov, batches,
                      jlora.lora_loss_fn(params, jstep.llm_loss_fn(jm), jcfg), lora_names=names)


def _rel(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-12)


def _close_params(got: dict, want: dict, atol: float = 1e-5) -> None:
    assert set(got) >= set(want), sorted(set(want) - set(got))[:6]
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=atol, rtol=0,
                                   err_msg=k)


def test_mesh_layout_and_rules():
    """The rules on the tiny Qwen2LM at data 4 x model 2 (torch [out, in]
    layout: q_proj shards dim 0, o_proj dim 1; norms replicated; a speech
    head of 27 rows stays whole); at model 4 the two KV heads do not divide,
    so attention replicates while the MLP and the vocabularies shard; one
    process is a 1 x 1 mesh and a larger one needs its processes."""
    tm = tllm.Qwen2LM(tllm.LMConfig(**U.LM, qwen=TQwen2Config(**U.QWEN)))
    specs = param_shardings(tm, Mesh(data=4, model=2), LM_RULES)
    layer = "llm.model.model.layers.0."
    assert specs[layer + "self_attn.q_proj.weight"] == ("model", None)
    assert specs[layer + "self_attn.q_proj.bias"] == ("model",)
    assert specs[layer + "self_attn.o_proj.weight"] == (None, "model")
    assert specs[layer + "mlp.down_proj.weight"] == (None, "model")
    assert specs["llm.model.model.embed_tokens.weight"] == ("model", None)
    assert specs["llm.model.model.norm.weight"] == ()
    assert specs["speech_embedding.weight"] == () == specs["llm_decoder.weight"]
    specs4 = param_shardings(tm, Mesh(data=1, model=4), LM_RULES)
    assert specs4[layer + "self_attn.q_proj.weight"] == ()
    assert specs4[layer + "mlp.gate_proj.weight"] == ("model", None)
    assert make_mesh().shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="needs 2 processes"):
        make_mesh(2, 1)


def test_full_size_sharded_bytes_fraction():
    """The full-size Qwen2LM (LMConfig(), on the meta device): at model 2
    every projection and vocabulary shards (>= 0.9999 of the bytes; the
    norms and the 2-row llm_embedding stay whole); at model 4 attention
    replicates (14 / 2 heads: 24 layers x 1.84 M parameters of 505.8 M), so
    0.9127 <= fraction < 0.9128."""
    with torch.device("meta"):
        lm = tllm.Qwen2LM(tllm.LMConfig())
    assert sharded_bytes_fraction(lm, Mesh(data=4, model=2), LM_RULES) >= 0.9999
    frac4 = sharded_bytes_fraction(lm, Mesh(data=2, model=4), LM_RULES)
    assert 0.9127 <= frac4 < 0.9128


def test_dp_tp_mesh_shapes(dp_tp):
    """Four ranks lay out as data 2 x model 2, row-major; a rank of the
    model group holds 2 of the 4 query heads and 1 of the 2 KV heads."""
    ranks = dp_tp[0]
    for r, res in enumerate(ranks):
        assert res["shape"] == {"data": 2, "model": 2}
        assert (res["data_rank"], res["model_rank"]) == (r // 2, r % 2)
        assert res["local_heads"] == (2, 1)


def test_lm_generate_dp_tp_matches_jax(gen_ref, dp_tp):
    """DP(2) x TP(2) greedy lm_generate (fp32, the packed cache at the local
    KV head): every rank's tokens and counts equal, exactly, the JAX
    package's single-device rows of its data rank."""
    out, count = gen_ref
    assert count.min() > 0
    for res in dp_tp[0]:
        got, cnt = res["gen"]
        rows = slice(2 * res["data_rank"], 2 * res["data_rank"] + 2)
        np.testing.assert_array_equal(cnt, count[rows])
        np.testing.assert_array_equal(got, out[rows])


def test_batched_synthesizer_on_mesh_matches_jax(dp_tp):
    """BatchedSynthesizer at DP(2) x TP(2), three requests padded to four
    rows: every rank returns all three wavs, each within the JAX package's
    mesh bar (atol 2e-3, rtol 1e-3) of its single-device wav."""
    ranks, want, _ = dp_tp
    for res in ranks:
        assert len(res["wavs"]) == len(want)
        for i, (got, w) in enumerate(zip(res["wavs"], want)):
            assert got.shape == w.shape and w.size > 0
            np.testing.assert_allclose(got, w, atol=2e-3, rtol=1e-3, err_msg=f"request {i}")


def test_dp_tp_train_steps_match_jax(lm_train, dp_tp):
    """Three DP(2) x TP(2) steps (adam, the clip binding) against the JAX
    package's step over the global batch: loss and grad_norm within 1e-5
    relative on every rank; the parameters, the model group's shards put
    together, within atol 1e-5 (the one-card test's bar); both data ranks
    hold the same shards."""
    metrics, final = lm_train
    ranks = dp_tp[0]
    for res in ranks:
        for i, (m, j) in enumerate(zip(res["train"], metrics)):
            for key in ("loss", "grad_norm"):
                assert _rel(m[key], j[key]) < 1e-5, (i, key, m[key], j[key])
            assert j["grad_norm"] > OPT["grad_clip"]
    for a, b in ((0, 2), (1, 3)):
        for k, v in ranks[a]["train_state"].items():
            assert torch.equal(v, ranks[b]["train_state"][k]), k
    full = W.unshard([ranks[0]["train_state"], ranks[1]["train_state"]],
                     ranks[0]["train_specs"])
    _close_params(full, final)


def test_tp_checkpoint_restores_exactly(dp_tp):
    """The TP(2) checkpoint is in the one-card format: restored in one
    process, each rank's shard is exactly its block of the restored
    parameters; restored onto the mesh, every rank gets its parameters and
    adam moments back exactly."""
    sec, _, params, _ = _lm_setup()
    ranks, _, tmp = dp_tp
    tm = _port("qwen2lm", sec, params)
    tx, _ = toptim.make_optimizer(**OPT)
    state, at = tckpt.restore_checkpoint(str(tmp / "ckpt"), tstep.make_train_state(tm, tx))
    assert at == 3
    full = tm.state_dict()
    for res in ranks:
        for k, v in res["train_state"].items():
            d = sharded_dim(res["train_specs"][k])
            want = full[k] if d is None else full[k].narrow(
                d, res["model_rank"] * v.shape[d], v.shape[d])
            assert torch.equal(want, v), k
    assert all(res["restored_equal"] for res in ranks)


def test_dp_train_steps_match_jax(lm_train, dp):
    """Three DP(2) steps against the JAX package's global-batch step (loss
    and grad_norm within 1e-5 relative, parameters atol 1e-5).  Rank 0's
    rows hold 28 targets and rank 1's 7, so the mean of the two ranks' mean
    losses misses the global loss by more than 1e-3 relative."""
    metrics, final = lm_train
    ranks, _ = dp
    for res in ranks:
        for i, (m, j) in enumerate(zip(res["train"], metrics)):
            for key in ("loss", "grad_norm"):
                assert _rel(m[key], j[key]) < 1e-5, (i, key, m[key], j[key])
        _close_params(res["train_state"], final)
    mean_of_means = np.mean([res["local_loss"] for res in ranks])
    assert _rel(mean_of_means, metrics[0]["loss"]) > 1e-3


def test_dp_flow_steps_with_pinned_draws_match_jax(dp):
    """Two DP(2) flow steps, each rank on its rows of the JAX draws of the
    global batch (the rows' mel lengths differ: 38 and 14 frames a rank):
    the first step's loss and grad_norm within 1e-5 relative of the JAX
    flow's loss and gradient norm on the whole batch and the same draws;
    the parameters after both steps within atol 5e-6 of the one-process
    port step on the same draws (adam's update of a near-zero gradient
    magnifies the order of sums: 1.3e-6 seen)."""
    ranks, ref = dp
    names = ("speech_token", "speech_token_len", "speech_feat", "speech_feat_len", "embedding")

    def pinned(model, batch, gen):
        d = FlowDraws(**{k: torch.from_numpy(np.array(v))
                         for k, v in ref["draws"][gen.initial_seed()].items()})
        out = model(*(batch[k] for k in names), draws=d)
        return out["loss"], {"denom": out["denom"]}

    tm = _port("flow", ref["fsec"], ref["fparams"])
    tx, _ = toptim.make_optimizer(**OPT)
    state, step = tstep.make_train_state(tm, tx), tstep.make_train_step(pinned, tx)
    for i, b in enumerate(ref["fbatches"]):
        state = step(state, tstep.to_device(b, "cpu"), torch.Generator().manual_seed(i))[0]
    one = tm.state_dict()
    loss, gnorm = ref["jax_first"]
    for res in ranks:
        assert _rel(res["flow"][0]["loss"], loss) < 1e-5
        assert _rel(res["flow"][0]["grad_norm"], gnorm) < 1e-5
        _close_params(res["flow_state"], one, atol=5e-6)


def test_dp_flow_draws_are_rows_of_the_global_draws(dp):
    """The built-in flow loss on a mesh: each rank's generator draws the
    global batch's noise and keeps its rows, so a DP(2) step equals the
    one-process step on the same generator (loss and grad_norm 1e-5)."""
    ranks, ref = dp
    tm = _port("flow", ref["fsec"], ref["fparams"])
    tx, _ = toptim.make_optimizer(**OPT)
    step = tstep.make_train_step(tstep.flow_loss_fn, tx)
    _, m = step(tstep.make_train_state(tm, tx), tstep.to_device(_flow_batch(4), "cpu"),
                torch.Generator().manual_seed(0))
    for res in ranks:
        for key in ("loss", "grad_norm"):
            assert _rel(res["flow_rows"][0][key], float(m[key])) < 1e-5, key


def _single_process_losses(batches: list) -> list:
    sec, _, params, _ = _lm_setup()
    tm = _port("qwen2lm", sec, params)
    tx, _ = toptim.make_optimizer(**OPT)
    state = tstep.make_train_state(tm, tx)
    step = tstep.make_train_step(tstep.llm_loss_fn, tx)
    out = []
    for i, b in enumerate(batches):
        state, m = step(state, tstep.to_device(b, "cpu"), torch.Generator().manual_seed(i))
        out.append(float(m["loss"]))
    return out


def test_executor_two_ranks_match_one_process(dp):
    """The train CLI's Executor on two ranks, each on its rows of three
    global batches: both ranks see the same losses, within 1e-5 relative of
    one process over the global batches."""
    ranks, ref = dp
    want = _single_process_losses(ref["exec_batches"])
    assert ranks[0]["exec_0"] == ranks[1]["exec_0"]
    np.testing.assert_allclose(ranks[0]["exec_0"], want, rtol=1e-5)


def test_uneven_shards_stop_together(dp):
    """Rank 1 runs out one batch early: the vote ends the epoch for both
    ranks after two steps, with the one-process losses of those steps; one
    rank without a batch is a "no" for all."""
    ranks, ref = dp
    want = _single_process_losses(ref["exec_batches"][:2])
    for res in ranks:
        assert len(res["exec_1"]) == 2
        np.testing.assert_allclose(res["exec_1"], want, rtol=1e-5)
        assert res["vote"] == [False, True]


def test_train_cli_tensor_parallel_then_one_card_resume(dp):
    """The train CLI on two ranks with --mesh_model 2 (the LM's projections,
    embeddings and head sharded) trains one epoch; rank 0 alone writes the
    metrics and the checkpoint, in the one-card format; one process then
    resumes from it and trains the next steps."""
    import json

    from cosyvoice_tpu_torch.bin import train as train_cli

    _, ref = dp
    model_dir = ref["tmp"] / "cli"
    recs = [json.loads(line) for line in open(model_dir / "metrics.jsonl")]
    n = len(recs)
    assert n == 2 and [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite(v) for r in recs for k, v in r.items() if k != "tag")
    assert tckpt.latest_step(str(model_dir)) == n
    train_cli.main(ref["argv"])
    recs = [json.loads(line) for line in open(model_dir / "metrics.jsonl")]
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    assert tckpt.latest_step(str(model_dir)) == 4


def test_continuous_flow_device_matches_one_device():
    """ContinuousSynthesizer with flow_device (the flow and vocoder there,
    chunks on a worker thread beside the next decode segment): the audio
    equals the one-device run within the JAX test's atol 1e-5."""
    _, tmodel = _stack()
    rng = np.random.default_rng(6)
    reqs = [TS.TTSRequest(text_tokens=rng.integers(0, 300, 8).astype(np.int32),
                          prompt_text_len=0,
                          prompt_speech_tokens=rng.integers(0, U.SPEECH_VOCAB, 4)
                          .astype(np.int32),
                          prompt_feat=(rng.standard_normal((8, U.N_MEL)) * 0.3)
                          .astype(np.float32),
                          embedding=rng.standard_normal(24).astype(np.float32))
            for _ in range(2)]
    kw = dict(num_slots=2, cache_len=256, text_bucket=16, speech_bucket=8)
    want = TS.ContinuousSynthesizer(tmodel, **kw).synthesize_batch(
        reqs, gen=torch.Generator().manual_seed(3))
    got = TS.ContinuousSynthesizer(copy.copy(tmodel), flow_device="cpu", **kw).synthesize_batch(
        reqs, gen=torch.Generator().manual_seed(3))
    for g, w in zip(got, want):
        assert g.shape == w.shape and w.size > 0
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)


def test_tensor_parallel_refuses_int4_and_the_fused_step():
    """Tensor parallelism over int4 / int4xla weights shards them (a model =
    2 layout: q_proj's packed [in/2, out] weight and [in/g, out] scale on
    dim 1, o_proj's on dim 0); the whole-step decode kernel (K6) on a
    sharded LM raises, saying that the JAX package has no such route (the
    refusal comes before any collective)."""
    for quant in ("int4", "int4xla"):
        lm = tllm.Qwen2LM(tllm.LMConfig(**U.LM, qwen=TQwen2Config(**U.QWEN, quant=quant,
                                                                  quant_group=16)))
        _, specs = shard_params(lm, Mesh(data=1, model=2), LM_RULES)
        layer = "llm.model.model.layers.0."
        for name, spec in (("q_proj.weight", (None, "model")), ("q_proj.scale", (None, "model")),
                           ("q_proj.bias", ("model",)), ("o_proj.weight", ("model", None)),
                           ("o_proj.scale", ("model", None))):
            assert specs[layer + "self_attn." + name] == spec, name
        assert (lm.cfg.qwen.num_heads, lm.cfg.qwen.intermediate_size) == (2, 32)
        o = lm.body.layers[0].self_attn["o_proj"]
        assert o.weight.shape == ((8 if quant == "int4" else 16), 32) and o.scale.shape == (1, 32)
    lm = tllm.Qwen2LM(tllm.LMConfig(**U.LM, qwen=TQwen2Config(**U.QWEN, quant="int8")))
    shard_params(lm, Mesh(data=1, model=2), LM_RULES)
    assert (lm.cfg.qwen.num_heads, lm.cfg.qwen.intermediate_size) == (2, 32)
    z = torch.zeros((1, 4), dtype=torch.long)
    n = torch.tensor([4])
    with pytest.raises(NotImplementedError, match="JAX package has no such route"):
        tllm.lm_generate_fused_step(lm, None, z, n, z, n, n, n, None, max_steps=4,
                                    cache_len=16)


@pytest.mark.parametrize("quant", ["int4", "int4xla"])
def test_full_size_int4_sharded_bytes_fraction(quant):
    """The full-size Qwen2LM in int4 / int4xla (group 128, meta device): at
    model 2 the MLP shards (2432 local rows, 19 groups) and attention stays
    whole (448 local rows, 3.5 groups); at model 4 neither (1216 rows, 9.5
    groups): only the vocabularies shard."""
    fracs = {}
    for model in (2, 4):
        with torch.device("meta"):
            lm = tllm.Qwen2LM(tllm.LMConfig(qwen=TQwen2Config(quant=quant)))
        fracs[model] = sharded_bytes_fraction(lm, Mesh(data=1, model=model), LM_RULES)
        specs = param_shardings(lm, Mesh(data=1, model=model), LM_RULES)
        layer = "llm.model.model.layers.0."
        assert specs[layer + "self_attn.q_proj.weight"] == ()
        assert specs[layer + "mlp.down_proj.weight"] == (("model", None) if model == 2 else ())
    assert fracs[2] > fracs[4] > 0
    assert FULL_INT4_FRACTIONS[quant] == pytest.approx((fracs[2], fracs[4]), abs=5e-5)


@pytest.mark.parametrize("quant,group", QUANT_LMS, ids=[f"{q}_g{g}" for q, g in QUANT_LMS])
def test_tensor_parallel_int4_matches_one_process(dp_tp, quant, group):
    """DP(2) x TP(2) greedy lm_generate over int4 / int4xla weights (fp32,
    K5's plain version on the CPU): every rank's tokens and counts equal one
    process's rows exactly, and the prefix logits within fp32 rounding
    (1e-5); attention shards at group 16 and stays whole at group 32."""
    lm = _quant_lm(quant, group)
    _, _, arrays = _gen_setup()
    a = [torch.from_numpy(np.asarray(x).astype(np.int64)) for x in arrays]
    out, count = tllm.lm_generate(lm, *a, torch.Generator().manual_seed(0), max_steps=24,
                                  cache_len=64)
    logits = W.prefix_logits(lm, a)
    assert count.min() > 0
    for res in dp_tp[0]:
        got = res[f"quant_{quant}_g{group}"]
        rows = slice(2 * res["data_rank"], 2 * res["data_rank"] + 2)
        assert got["sharded"] == (group == 16, True)
        np.testing.assert_array_equal(got["gen"][1], count[rows].numpy())
        np.testing.assert_array_equal(got["gen"][0], out[rows].numpy())
        np.testing.assert_allclose(got["logits"], logits[rows].numpy(), atol=1e-5, rtol=1e-5)


def _one_process_steps(model, loss_fn, batches: list) -> tuple:
    tx, _ = toptim.make_optimizer(**OPT)
    state, step = tstep.make_train_state(model, tx), tstep.make_train_step(loss_fn, tx)
    metrics = []
    for i, b in enumerate(batches):
        state, m = step(state, tstep.to_device(b, "cpu"), torch.Generator().manual_seed(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


def test_phoneme_lm_dp_tp_steps_match_one_process(dp_tp):
    """Two DP(2) x TP(2) steps of qwen2lm_phoneme_src2 (its Qwen2 body and
    speech head sharded by the LM rules; each data rank its rows, which
    hold 15 and 5 targets): loss and grad_norm within 1e-5 relative of one
    process on the global batches, the parameters within atol 1e-5."""
    tm = _pho_lm()
    metrics, _ = _one_process_steps(tm, tstep.phoneme_llm_loss_fn,
                                    [_pho_batch(s) for s in PHO_BATCHES])
    ranks = dp_tp[0]
    for res in ranks:
        for i, (m, j) in enumerate(zip(res["pho_train"], metrics)):
            for key in ("loss", "grad_norm", "acc"):
                assert _rel(m[key], j[key]) < 1e-5, (i, key, m[key], j[key])
    assert any(sharded_dim(s) is not None for s in ranks[0]["pho_specs"].values())
    full = W.unshard([ranks[0]["pho_state"], ranks[1]["pho_state"]], ranks[0]["pho_specs"])
    _close_params(full, tm.state_dict())


def test_lora_dp_tp_steps_match_one_process(dp_tp):
    """Three DP(2) x TP(2) LoRA steps over the sharded train recipe's LM
    (adapters on q / gate, column-parallel: b's rows a rank; on o / down,
    row-parallel: a's columns a rank): loss and grad_norm within 1e-5
    relative of one process, and the gathered overlay within atol 1e-5 of
    one process's on every rank."""
    sec, _, params, batches = _lm_setup()
    base, cfg = _port("qwen2lm", sec, params), LoRAConfig(r=LORA_CFG["r"], alpha=LORA_CFG["alpha"])
    overlay = LoRAOverlay(_lora_setup()[2])
    metrics, _ = _one_process_steps(overlay, lora_loss_fn(base, tstep.llm_loss_fn, cfg),
                                    batches)
    want = overlay.pairs()
    ranks = dp_tp[0]
    assert set(ranks[0]["lora_split"].values()) == {"a", "b"}
    for res in ranks:
        for i, (m, j) in enumerate(zip(res["lora_train"], metrics)):
            for key in ("loss", "grad_norm"):
                assert _rel(m[key], j[key]) < 1e-5, (i, key, m[key], j[key])
        assert set(res["lora_whole"]) == set(want)
        for name, ab in want.items():
            for f in ("a", "b"):
                np.testing.assert_allclose(res["lora_whole"][name][f].numpy(),
                                           ab[f].detach().numpy(), atol=1e-5, rtol=0,
                                           err_msg=f"{name}.{f}")


@pytest.mark.parametrize("quant,group", QUANT_LMS, ids=[f"{q}_g{g}" for q, g in QUANT_LMS])
def test_tensor_parallel_int4_matches_jax(quant_ref, dp_tp, quant, group):
    """DP(2) x TP(2) greedy lm_generate over the JAX package's int4 / int4xla
    weights (fp32): every rank's tokens and counts equal, exactly, the JAX
    package's single-device lm_generate on the same weights (its rows of
    the data rank), and the prefix logits within 2e-5 (the fp32 Qwen2
    body's bar against JAX, tests/test_torch_quant_decode.py)."""
    tokens, count, logits = quant_ref[(quant, group)]
    assert count.min() > 0
    for res in dp_tp[0]:
        got = res[f"quant_{quant}_g{group}"]
        rows = slice(2 * res["data_rank"], 2 * res["data_rank"] + 2)
        np.testing.assert_array_equal(got["gen"][1], count[rows])
        np.testing.assert_array_equal(got["gen"][0], tokens[rows])
        np.testing.assert_allclose(got["logits"], logits[rows], atol=2e-5, rtol=2e-5)


def test_phoneme_lm_dp_tp_steps_match_jax(pho_train, dp_tp):
    """Two DP(2) x TP(2) steps of qwen2lm_phoneme_src2 against the JAX
    package's step over the global batches from the same params: loss,
    grad_norm and acc within 1e-5 relative on every rank; the parameters,
    the model group's shards put together, within atol 1e-5."""
    metrics, final = pho_train
    ranks = dp_tp[0]
    for res in ranks:
        for i, (m, j) in enumerate(zip(res["pho_train"], metrics)):
            for key in ("loss", "grad_norm", "acc"):
                assert _rel(m[key], j[key]) < 1e-5, (i, key, m[key], j[key])
    full = W.unshard([ranks[0]["pho_state"], ranks[1]["pho_state"]], ranks[0]["pho_specs"])
    _close_params(full, final)


def test_lora_dp_tp_steps_match_jax(lora_train, dp_tp):
    """Three DP(2) x TP(2) LoRA steps over the sharded LM against the JAX
    package's LoRA step (its lora_loss_fn, the same overlay) over the global
    batches: loss and grad_norm within 1e-5 relative on every rank, and the
    gathered overlay within atol 1e-5 of the JAX package's on every rank."""
    metrics, final = lora_train
    for res in dp_tp[0]:
        for i, (m, j) in enumerate(zip(res["lora_train"], metrics)):
            for key in ("loss", "grad_norm"):
                assert _rel(m[key], j[key]) < 1e-5, (i, key, m[key], j[key])
        got = {f"{f}.{name.replace('.', '/')}": ab[f]
               for name, ab in res["lora_whole"].items() for f in ("a", "b")}
        _close_params(got, final)


@pytest.mark.parametrize("run", ["lora", "phoneme"])
def test_train_cli_lora_and_phoneme_on_mesh(dp, run):
    """The train CLI with --mesh_model 2 on two ranks: --lora over the
    sharded LM (lora.npz holds the whole factors, in the one-card shapes)
    and qwen2lm_phoneme_src2 over a speaker-JSON corpus labelled online:
    rank 0 writes two steps of finite metrics and the checkpoint."""
    import json

    _, ref = dp
    model_dir = ref["tmp"] / ("cli_lora" if run == "lora" else "cli_pho")
    recs = [json.loads(line) for line in open(model_dir / "metrics.jsonl")]
    assert [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite(v) for r in recs for k, v in r.items() if k != "tag")
    assert tckpt.latest_step(str(model_dir)) == 2
    if run == "lora":
        sec = yaml.safe_load(open(ref["argv"][1]))["llm"]
        base = tconfig.build_model("qwen2lm", {k: v for k, v in sec.items() if k != "kind"})[0]
        saved = read_lora_npz(str(model_dir / "lora.npz"))
        names = [n for n, _ in base.named_parameters()
                 if any(p in n for p in ("q_proj.", "k_proj.", "v_proj.", "o_proj."))
                 and n.endswith(".weight")]
        assert sorted(saved) == sorted(names)
        for n in names:
            w = base.get_parameter(n)
            assert saved[n]["b"].shape[0] == w.shape[0] and saved[n]["a"].shape[1] == w.shape[1]
