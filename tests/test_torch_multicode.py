"""The multi-codebook phoneme LM and its delay pattern: the port against the
JAX package on the tiny stack of tests/test_multicode.py, weights carried
across by convert.py, inputs drawn with numpy from fixed seeds.  Bars: the
delay pattern and its revert exact; the decode prefix (the phoneme
conformer and the fusion layer with flax LayerNorms) within 2e-4, its
lengths exact; the ARDecoder logits within 1e-5 in fp32; greedy delayed
codes, steps and done flags of multicode_generate exact for two ragged rows
(free-running, and with the head biased towards EOS so a row finishes
early); the converter's tensors exactly the JAX tree's values; a nucleus
decode's codes inside the vocab."""
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_util as U
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)
from cosyvoice_tpu.models import conformer as jconf
from cosyvoice_tpu.models import llm as jllm
from cosyvoice_tpu.models import llm_multicode as jmc
from cosyvoice_tpu.models import llm_phoneme as jpho
from cosyvoice_tpu.models.qwen2 import Qwen2Config as JQwen2Config
from cosyvoice_tpu.ops import delay as jdelay
from cosyvoice_tpu_torch import convert
from cosyvoice_tpu_torch.models import conformer as tconf
from cosyvoice_tpu_torch.models import llm as tllm
from cosyvoice_tpu_torch.models import llm_multicode as tmc
from cosyvoice_tpu_torch.models import llm_phoneme as tpho
from cosyvoice_tpu_torch.models.qwen2 import Qwen2Config as TQwen2Config
from cosyvoice_tpu_torch.ops import delay as tdelay
from cosyvoice_tpu_torch.ops import sampling as tsamp

# tests/test_multicode.py's tiny stack
QWEN = dict(vocab_size=100, hidden_size=32, num_layers=1, num_heads=4, num_kv_heads=2,
            head_dim=8, intermediate_size=64)
PHO = dict(text_token_size=20, text_token_dim=12, text_tone_size=16, text_tone_dim=8,
           text_lang_size=2, text_lang_dim=2, text_prsd_size=6, text_prsd_dim=2)
ENC = dict(dim=32, heads=4, linear_units=48, num_blocks=1, input_size=24)
CFG = dict(llm_input_size=32, llm_output_size=32, speech_token_size=16, spk_embed_dim=8,
           codebooknum=3, src_attn_layers=1, fusion_heads=4, fusion_ffn=48)
B, TT, TP, TC = 2, 5, 6, 4
TEXT_LEN, PHO_LEN, CODES_LEN = [5, 4], [6, 5], [4, 2]


@pytest.mark.parametrize("T,N", [(9, 4), (1, 6), (5, 1), (3, 3)])
def test_delay_pattern_matches_jax(T, N):
    """get / revert exactly equal to the JAX package's; revert undoes get."""
    codec = np.random.default_rng(T * 10 + N).integers(0, 50, (2, T, N))
    want = np.asarray(jdelay.get_delay_pattern(jnp.asarray(codec), 51, 50))
    got = tdelay.get_delay_pattern(torch.from_numpy(codec), 51, 50)
    np.testing.assert_array_equal(got.numpy(), want)
    back = tdelay.revert_delay_pattern(got)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jdelay.revert_delay_pattern(jnp.asarray(want))))
    np.testing.assert_array_equal(back.numpy(), codec)


def test_nucleus_sample_takes_leading_dims():
    """[B, C, V] logits draw one id a (row, codebook), in the [B * C, V]
    order on one generator, each inside its row's top-k."""
    logits = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 3, 40))
                              .astype(np.float32))
    got = tsamp.nucleus_sample(torch.Generator().manual_seed(7), logits, 0.9, 5)
    flat = tsamp.nucleus_sample(torch.Generator().manual_seed(7), logits.reshape(6, 40), 0.9, 5)
    assert got.shape == (2, 3)
    np.testing.assert_array_equal(got.reshape(6).numpy(), flat.numpy())
    top5 = torch.topk(logits, 5, dim=-1).indices
    assert bool((top5 == got[..., None]).any(-1).all())


def _cfgs(method: str = "greedy"):
    return (jmc.MultiCodeLMConfig(
                **CFG, sampling=jllm.SamplingConfig(method=method),
                phoneme=jpho.PhonemeEmbedConfig(**PHO),
                encoder=jconf.ConformerConfig(**ENC, dropout_rate=0.0,
                                              attention_dropout_rate=0.0),
                qwen=JQwen2Config(**QWEN)),
            tmc.MultiCodeLMConfig(
                **CFG, sampling=tllm.SamplingConfig(method=method),
                phoneme=tpho.PhonemeEmbedConfig(**PHO), encoder=tconf.ConformerConfig(**ENC),
                qwen=TQwen2Config(**QWEN)))


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    hi = [PHO["text_token_size"], PHO["text_tone_size"], PHO["text_lang_size"],
          PHO["text_prsd_size"]]
    return dict(text=rng.integers(0, 100, (B, TT)), text_len=np.array(TEXT_LEN),
                pho=np.stack([rng.integers(0, hi, (TP, 4)) for _ in range(B)]),
                pho_len=np.array(PHO_LEN), codes=rng.integers(0, 16, (B, TC, 3)),
                codes_len=np.array(CODES_LEN),
                emb=rng.standard_normal((B, 8)).astype(np.float32))


@lru_cache(maxsize=None)
def _params():
    """Seeded params of the shapes model.init draws through the training
    forward (as tests/test_multicode.py inits it)."""
    jm = jmc.Qwen2LMPhonemeMultiCode(_cfgs()[0])
    x = {k: jnp.asarray(v) for k, v in _inputs().items()}
    return U.random_params(jm.init, jax.random.PRNGKey(0), x["text"], x["text_len"],
                           x["pho"], x["pho_len"], x["codes"], x["codes_len"], x["emb"])


def _models(method: str = "greedy", eos_bias: float = 0.0):
    """(JAX model, its params, port model); eos_bias added to every
    codebook's EOS logit."""
    jcfg, tcfg = _cfgs(method)
    params = _params()
    if eos_bias:
        params = jax.tree_util.tree_map(np.asarray, params)
        head = params["params"]["ar_decoder"]["model"]
        C, eos = tcfg.codebooknum, tcfg.eos_id
        head["bias"] = head["bias"].copy()
        head["bias"][eos * C:(eos + 1) * C] += eos_bias
    tm = tmc.Qwen2LMPhonemeMultiCode(tcfg)
    tm.load_state_dict(convert.multicode_lm_state_from_jax(params), strict=True)
    return jmc.Qwen2LMPhonemeMultiCode(jcfg), params, tm.eval()


def _prefix_args(x: dict, lib):
    t = (lambda a: jnp.asarray(a)) if lib == "jax" else (lambda a: torch.as_tensor(a))
    return tuple(t(x[k]) for k in ("text", "text_len", "pho", "pho_len", "codes", "codes_len",
                                   "emb"))


def test_converter_carries_every_value_exactly():
    """Every JAX leaf lands, exactly, in one port tensor (the multiset of
    their values is equal, leaf for tensor), and the port module loads the
    result strictly."""
    params = _params()
    sd = convert.multicode_lm_state_from_jax(params)
    tm = tmc.Qwen2LMPhonemeMultiCode(_cfgs()[1])
    tm.load_state_dict(sd, strict=True)
    key = lambda a: (a.size, np.sort(np.asarray(a, np.float32).ravel()).tobytes())
    want = sorted(key(np.asarray(v)) for v in jax.tree_util.tree_leaves(params))
    got = sorted(key(v.numpy()) for v in sd.values())
    assert got == want
    assert not hasattr(tm, "llm_decoder") or tm.llm_decoder is None


def test_prefix_and_logits_match_jax():
    """prefix_for_decode (fusion's flax LayerNorms: 2e-4) with lengths
    exact; the ARDecoder's [B, T, max_id, C] logits within 1e-5."""
    jm, params, tm = _models()
    x = _inputs(1)
    emb_j, len_j = jm.apply(params, *_prefix_args(x, "jax"),
                            method=jmc.Qwen2LMPhonemeMultiCode.prefix_for_decode)
    with torch.no_grad():
        emb_t, len_t = tm.prefix_for_decode(*_prefix_args(x, "torch"))
    np.testing.assert_array_equal(len_t.numpy(), np.asarray(len_j))
    assert emb_t.shape == emb_j.shape
    np.testing.assert_allclose(emb_t.numpy(), np.asarray(emb_j), atol=2e-4, rtol=0)

    h = np.random.default_rng(2).standard_normal((B, 3, 32)).astype(np.float32)
    want = jm.apply(params, jnp.asarray(h), method=jmc.Qwen2LMPhonemeMultiCode.decode_logits)
    with torch.no_grad():
        got = tm.decode_logits(torch.from_numpy(h))
    assert got.shape == (B, 3, 18, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("eos_bias", [0.0, 2.0], ids=["free", "eos_biased"])
def test_greedy_generate_matches_jax(eos_bias):
    """multicode_generate, greedy, two ragged rows: the delayed codes (with
    their leading BOS row), the steps taken and the done flags exact."""
    jm, params, tm = _models(eos_bias=eos_bias)
    x = _inputs(4)
    steps, cache_len = 12, 64
    out_j, n_j, done_j = jmc.multicode_generate(
        jm, params, *_prefix_args(x, "jax"), jnp.asarray([12, 12]), jax.random.PRNGKey(1),
        max_steps=steps, cache_len=cache_len)
    out_t, n_t, done_t = tmc.multicode_generate(
        tm, *_prefix_args(x, "torch"), torch.tensor([12, 12]), None, steps, cache_len)
    assert n_t == int(n_j)
    np.testing.assert_array_equal(done_t.numpy(), np.asarray(done_j))
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    assert (out_t[:, 0] == tm.cfg.bos_id).all()
    if eos_bias:        # one row ends at once, the other runs on alone, then ends
        assert done_t.all() and 1 < n_t < steps
    else:
        assert n_t == steps and not done_t.any()


def test_nucleus_generate_stays_in_vocab():
    """A nucleus decode runs; every code is an id of its table, and the
    reverted matrix of a row has N - 1 fewer rows than its delayed one."""
    _, _, tm = _models(method="nucleus")
    x = _inputs(5)
    out, n, done = tmc.multicode_generate(tm, *_prefix_args(x, "torch"), torch.tensor([10, 10]),
                                          torch.Generator().manual_seed(0), 10, 64)
    assert out.shape == (B, 11, 3) and n <= 10
    assert bool(((out >= 0) & (out < tm.cfg.max_id)).all())
    rev = tdelay.revert_delay_pattern(out[:, 1:n + 1])
    assert rev.shape == (B, n - 2, 3)
