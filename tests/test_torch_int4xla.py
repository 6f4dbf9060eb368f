"""int4xla weight-only quantization with AWQ calibration: the port against
the JAX package on the tiny LM of torch_port_util.  Bars: the quantized
nibble values exactly and the group scales within 1e-7; collect_act_stats
within 1e-5; awq_equalize within 2e-5 in fp32; an int4xla LM's teacher-
forced logits within 2e-5 and its greedy tokens exactly equal, with and
without AWQ (the port's own quantizer giving the JAX quantizer's tensors
on the same weights)."""
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_util as U
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)
from cosyvoice_tpu.models import llm as jllm
from cosyvoice_tpu.models.qwen2 import Qwen2Config as JQwen2Config
from cosyvoice_tpu.models.qwen2 import causal_prefill_bias as j_causal_bias
from cosyvoice_tpu.utils import quant as jquant
from cosyvoice_tpu_torch import convert
from cosyvoice_tpu_torch.models import llm as tllm
from cosyvoice_tpu_torch.models.qwen2 import Qwen2Config as TQwen2Config
from cosyvoice_tpu_torch.models.qwen2 import QDense
from cosyvoice_tpu_torch.models.qwen2 import causal_prefill_bias as t_causal_bias
from cosyvoice_tpu_torch.utils import quant as tquant

GROUP = 8


@pytest.mark.parametrize("group", [16, 128], ids=["g16", "g_clamped_to_in"])
def test_quantize_kernel_int4xla_matches_jax(group):
    """Nibble values [in, out] exactly, scales [in/g, out] within 1e-7."""
    w = np.random.default_rng(20).standard_normal((64, 40)).astype(np.float32)  # [in, out]
    want = jquant.quantize_kernel_int4xla(w, group_size=group)
    q, scale = tquant.quantize_kernel_int4xla(torch.from_numpy(w.T.copy()), group)
    assert q.dtype == torch.int8 and int(q.abs().max()) <= 7
    np.testing.assert_array_equal(q.numpy(), np.asarray(want["kernel"]))
    np.testing.assert_allclose(scale.numpy(), np.asarray(want["scale"]), atol=1e-7, rtol=0)


def _calib():
    rng = np.random.default_rng(21)
    return (rng.integers(0, 300, (2, 7)), np.array([7, 4]),
            rng.integers(0, U.SPEECH_VOCAB, (2, 9)), np.array([9, 5]))


@lru_cache(maxsize=None)
def _jax_stats():
    jm, params, _ = U.build_lm()
    return jllm.collect_act_stats(jm, params, *map(jnp.asarray, _calib()))


def test_collect_act_stats_matches_jax():
    """Per-layer, per-channel max |activation| at q_proj, gate_proj and
    down_proj inputs over every row of two ragged rows (pad rows included),
    within 1e-5; the hooks are gone afterwards."""
    _, _, tm = U.build_lm()
    got = tllm.collect_act_stats(tm, *(torch.as_tensor(a) for a in _calib()))
    want = _jax_stats()
    assert sorted(got) == sorted(want) == list(range(U.QWEN["num_layers"]))
    for i in want:
        for key in ("attn_in", "mlp_in", "down_in"):
            np.testing.assert_allclose(got[i][key].numpy(), want[i][key], atol=1e-5, rtol=0,
                                       err_msg=f"layer {i} {key}")
    assert all(not m._forward_pre_hooks for m in tm.modules())


def test_awq_equalize_matches_jax():
    """The fold of the equalization scales into the fp32 weights (norms,
    q/k/v, gate/up, up's rows, down) within 2e-5; untouched tensors equal."""
    params = U._lm_params()
    stats = _jax_stats()
    want = convert.lm_state_from_jax(jquant.awq_equalize(params, stats))
    got = tquant.awq_equalize(convert.lm_state_from_jax(params), stats)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=2e-5, rtol=0,
                                   err_msg=k)


def _int4xla_lms(awq: bool):
    """The tiny LM quantized to int4xla at group 8 by the JAX quantizer
    (after AWQ from _jax_stats with `awq`), in both packages; greedy
    sampling, packed decode cache.  Also the port quantizer's state from
    the same weights."""
    params = U._lm_params()
    stats = _jax_stats() if awq else None
    qparams = jquant.quantize_qwen_int4xla(params, group_size=GROUP, act_amax=stats)
    own = tquant.quantize_qwen_int4xla(convert.lm_state_from_jax(params), group_size=GROUP,
                                       act_amax=stats)
    qwen = dict(U.QWEN, quant="int4xla", quant_group=GROUP, fused_cache_update=True)
    jm = jllm.Qwen2LM(jllm.LMConfig(**U.LM, qwen=JQwen2Config(**qwen),
                                    sampling=jllm.SamplingConfig(method="greedy")))
    tm = tllm.Qwen2LM(tllm.LMConfig(**U.LM, qwen=TQwen2Config(**qwen),
                                    sampling=tllm.SamplingConfig(method="greedy")))
    state = convert.lm_state_from_jax(qparams)
    tm.load_state_dict(state, strict=True)
    return jm, qparams, tm.eval(), state, own


@pytest.mark.parametrize("awq", [False, True], ids=["plain", "awq"])
def test_int4xla_lm_matches_jax(awq):
    """QDense(quant="int4xla") carried over by convert.py: its buffers the
    JAX layout, the port quantizer's tensors those of the JAX quantizer,
    teacher-forced logits within 2e-5 (fp32) and greedy tokens exactly
    equal to the JAX lm_generate."""
    jm, params, tm, state, own = _int4xla_lms(awq)
    q = tm.body.layers[0].mlp["down_proj"]
    assert q.weight.dtype == torch.int8 and q.weight.shape == (64, 32)
    assert q.scale.shape == (64 // GROUP, 32)
    assert sorted(own) == sorted(state)
    for k in state:
        if state[k].dtype == torch.int8:
            np.testing.assert_array_equal(own[k].numpy(), state[k].numpy(), err_msg=k)
        else:
            np.testing.assert_allclose(own[k].numpy(), state[k].numpy(), atol=1e-7, rtol=0,
                                       err_msg=k)

    rng = np.random.default_rng(22)
    text = rng.integers(0, 300, (1, 9))
    psp = rng.integers(0, U.SPEECH_VOCAB, (1, 20))
    T = 2 + 9 + 20

    @jax.jit
    def logits(p, text, psp):
        emb, seq_len = jm.apply(p, text, jnp.asarray([9]), psp, jnp.asarray([20]),
                                method=jllm.Qwen2LM.prefill_embeds)
        pos = jnp.broadcast_to(jnp.arange(T)[None], (1, T))
        h, _ = jm.apply(p, emb, pos, j_causal_bias(T, T, seq_len, 1),
                        method=jllm.Qwen2LM.forward_hidden)
        return jm.apply(p, h, method=jllm.Qwen2LM.decode_logits)

    want = np.asarray(logits(params, jnp.asarray(text), jnp.asarray(psp)))
    with torch.no_grad():
        temb, tlen = tm.prefill_embeds(torch.from_numpy(text), torch.tensor([9]),
                                       torch.from_numpy(psp), torch.tensor([20]))
        th, _ = tm.forward_hidden(temb, torch.arange(T)[None], t_causal_bias(T, T, tlen, 1))
        got = tm.decode_logits(th).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)

    inputs = (text, [9], psp[:, :5], [5], [6], [40])
    out_j, cnt_j = jllm.lm_generate(jm, params, *map(jnp.asarray, inputs),
                                    jax.random.PRNGKey(0), max_steps=40, cache_len=128)
    out_t, cnt_t = tllm.lm_generate(tm, *(torch.as_tensor(np.asarray(a)) for a in inputs),
                                    None, max_steps=40, cache_len=128)
    n = int(cnt_j[0])
    assert int(cnt_t[0]) == n and n >= 6
    np.testing.assert_array_equal(out_t[0, :n].numpy(), np.asarray(out_j)[0, :n])


def test_int4xla_qdense_rejects_unknown_quant():
    with pytest.raises(ValueError):
        QDense(32, 16, quant="int3")
    q = QDense(32, 16, quant="int4xla", group=128)      # g clamps to the input width
    assert q.weight.shape == (32, 16) and q.scale.shape == (1, 16)
