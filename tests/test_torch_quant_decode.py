"""The port's quantized B=1 decode paths on the CPU against the JAX package:
packed int4 (quantizer, the int4_matmul kernel's plain version, the int4 LM)
and the whole-step decode (step weights, the lm_step kernel's plain version,
lm_generate_fused_step).  The JAX side runs as its own tests run it: the
Pallas kernels in interpret mode and their XLA twins.  The CUDA kernels are
held against these plain versions on the card (tests/test_torch_gpu.py,
chip_smoke.py)."""
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
from cosyvoice_tpu.models.qwen2 import rope_cos_sin as j_rope_cos_sin
from cosyvoice_tpu.ops.pallas import int4_matmul as jax_i4
from cosyvoice_tpu.ops.pallas import lm_step as jax_step
from cosyvoice_tpu.utils import quant as jquant
from cosyvoice_tpu_torch import convert
from cosyvoice_tpu_torch.models import llm as tllm
from cosyvoice_tpu_torch.models.qwen2 import Qwen2Config as TQwen2Config
from cosyvoice_tpu_torch.models.qwen2 import causal_prefill_bias as t_causal_bias
from cosyvoice_tpu_torch.ops.kernels import int4_matmul as K5
from cosyvoice_tpu_torch.ops.kernels import lm_step as K6
from cosyvoice_tpu_torch.utils import quant as tquant


@pytest.mark.parametrize("group", [16, 128], ids=["g16", "g_clamped_to_in"])
def test_int4_pack_and_quantize_bit_equal(group):
    """pack_int4 and quantize_kernel_int4 give the JAX package's bytes and
    scales exactly (g = min(group, in))."""
    rng = np.random.default_rng(10)
    w_int = rng.integers(-8, 8, (64, 40)).astype(np.int8)
    np.testing.assert_array_equal(K5.pack_int4(torch.from_numpy(w_int)).numpy(),
                                  jax_i4.pack_int4(w_int))
    w = rng.standard_normal((64, 40)).astype(np.float32)        # [in, out]
    want = jquant.quantize_kernel_int4(w, group_size=group)
    packed, scale = tquant.quantize_kernel_int4(torch.from_numpy(w.T.copy()), group)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(want["kernel"]))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(want["scale"]))
    assert packed.is_contiguous() and scale.is_contiguous()     # as the kernel takes them


def test_int4_matmul_plain_matches_jax():
    """fp32, atol = rtol = 1e-4 (the JAX package's own bar): the plain version
    against the Pallas kernel in interpret mode and its XLA twin."""
    rng = np.random.default_rng(11)
    IN, OUT, G = 64, 256, 16
    w_int = rng.integers(-7, 8, (IN, OUT)).astype(np.int8)
    scale = (np.abs(rng.standard_normal((IN // G, OUT))) * 0.02 + 1e-3).astype(np.float32)
    packed = jax_i4.pack_int4(w_int)
    x = rng.standard_normal((3, IN)).astype(np.float32)
    args = (jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scale))
    got = K5.int4_matmul(torch.from_numpy(x), torch.from_numpy(packed),
                         torch.from_numpy(scale)).numpy()
    for want in (jax_i4.int4_matmul(*args, interpret=True), jax_i4.int4_matmul_xla(*args)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-4)


def _int4_lms():
    """The tiny LM of torch_port_util quantized to int4 at group 8 by the JAX
    quantizer, in both packages; greedy sampling, packed decode cache."""
    params = jquant.quantize_qwen_int4(U._lm_params(), group_size=8)
    qwen = dict(U.QWEN, quant="int4", quant_group=8, fused_cache_update=True)
    jm = jllm.Qwen2LM(jllm.LMConfig(**U.LM, qwen=JQwen2Config(**qwen),
                                    sampling=jllm.SamplingConfig(method="greedy")))
    tm = tllm.Qwen2LM(tllm.LMConfig(**U.LM, qwen=TQwen2Config(**qwen),
                                    sampling=tllm.SamplingConfig(method="greedy")))
    tm.load_state_dict(convert.lm_state_from_jax(params), strict=True)
    return jm, params, tm.eval()


def test_int4_lm_matches_jax():
    """QDense(quant="int4") carried over by convert.py: teacher-forced logits
    within 2e-5 (fp32, the Qwen2 body bar) and greedy tokens exactly equal to
    the JAX lm_generate."""
    jm, params, tm = _int4_lms()
    rng = np.random.default_rng(12)
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


# the JAX package's whole-step test shape (tests/test_pallas.py)
STEP_QWEN = dict(vocab_size=64, hidden_size=32, num_layers=3, num_heads=4, num_kv_heads=2,
                 head_dim=8, intermediate_size=64)


@lru_cache(maxsize=None)
def _step_models():
    """-> (JAX int8 params, JAX StepWeights, port StepWeights) for STEP_QWEN."""
    cfg = dict(llm_input_size=32, llm_output_size=32, speech_token_size=16)
    jfp = jllm.Qwen2LM(jllm.LMConfig(**cfg, qwen=JQwen2Config(**STEP_QWEN)))
    t = jnp.zeros((1, 5), jnp.int32)
    params = jquant.quantize_qwen_int8(jax.jit(lambda k: jfp.init(
        k, t, jnp.asarray([5]), t, jnp.asarray([5])))(jax.random.PRNGKey(1)))
    tm = tllm.Qwen2LM(tllm.LMConfig(**cfg, qwen=TQwen2Config(**STEP_QWEN, quant="int8")))
    tm.load_state_dict(convert.lm_state_from_jax(params), strict=True)
    L = STEP_QWEN["num_layers"]
    return (params, jax_step.pack_step_weights(params, L),
            K6.pack_step_weights(tm.body.state_dict(), L))


def test_pack_step_weights_and_cache_layout_bit_equal():
    """The port's StepWeights (from its own int8 state_dict) and stacked cache
    equal the JAX package's bit for bit; a packed [1, T, KH*D] cache stacks
    to the same layout as the head-major one."""
    _, jw, tw = _step_models()
    for name in jax_step.StepWeights._fields:
        want, got = np.asarray(getattr(jw, name)), getattr(tw, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    rng = np.random.default_rng(13)
    heads = [rng.standard_normal((1, 2, 20, 8)).astype(np.float32) for _ in range(6)]
    jk, jv = jax_step.cache_to_step_layout(tuple(map(jnp.asarray, heads[:3])),
                                           tuple(map(jnp.asarray, heads[3:])), 32)
    tk, tv = K6.cache_to_step_layout([torch.from_numpy(c) for c in heads[:3]],
                                     [torch.from_numpy(c) for c in heads[3:]], 32)
    packed = [torch.from_numpy(c).permute(0, 2, 1, 3).reshape(1, 20, 16) for c in heads]
    pk, pv = K6.cache_to_step_layout(packed[:3], packed[3:], 32)
    for got in (tk, pk):
        np.testing.assert_array_equal(got.numpy(), np.asarray(jk))
    for got in (tv, pv):
        np.testing.assert_array_equal(got.numpy(), np.asarray(jv))


def test_lm_step_plain_matches_jax():
    """Three decode steps, fp32, 2e-5: the plain version against lm_step_xla
    and the Pallas kernel in interpret mode; the k/v it writes at row pos
    equal the new k/v the JAX step returns."""
    _, jw, tw = _step_models()
    rng = np.random.default_rng(14)
    L, C, KHD = STEP_QWEN["num_layers"], 32, 16
    kc, vc = (rng.standard_normal((L, C, KHD)).astype(np.float32) * 0.5 for _ in range(2))
    tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    jkc, jvc = jnp.asarray(kc), jnp.asarray(vc)
    kw = dict(nq=4, nkv=2, hd=8)
    step_xla = jax.jit(jax_step.lm_step_xla, static_argnames=("nq", "nkv", "hd"))
    for step in range(3):
        pos = 6 + step
        x = (rng.standard_normal((1, 32)) * 0.3).astype(np.float32)
        cos, sin = (np.array(a)[0] for a in j_rope_cos_sin(jnp.asarray([[pos]]), 8, 1e6))
        jargs = (jnp.asarray(np.pad(x, ((0, 7), (0, 0)))), jkc, jvc, jnp.asarray(pos),
                 jnp.asarray(cos), jnp.asarray(sin))
        y_x, nk, nv = step_xla(jw, *jargs, **kw)
        y_p, nk_p, _ = jax_step.lm_step_fused(jw, *jargs, **kw, interpret=True)
        got = K6.lm_step(tw, torch.from_numpy(x), tkc, tvc, pos, torch.from_numpy(cos),
                         torch.from_numpy(sin), **kw)
        for want in (y_x, y_p):
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want)[0], atol=2e-5,
                                       rtol=2e-5, err_msg=f"step {step}")
        np.testing.assert_allclose(tkc[:, pos].numpy(), np.asarray(nk), atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(tvc[:, pos].numpy(), np.asarray(nv), atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(np.asarray(nk_p), np.asarray(nk), atol=2e-5)
        jkc = jkc.at[:, pos].set(nk)
        jvc = jvc.at[:, pos].set(nv)


@pytest.mark.parametrize("pos", [0, 31], ids=["first_row", "last_row"])
def test_lm_step_plain_matches_jax_at_cache_frontiers(pos):
    """One fp32 decode step at the cache's frontiers, 2e-5: at pos 0 the new
    token attends to itself alone, at pos C - 1 to every cached row.  The
    plain version against lm_step_xla and the Pallas kernel in interpret
    mode; the k/v it writes at row pos equal the new k/v the JAX step
    returns, and no other row moves."""
    _, jw, tw = _step_models()
    rng = np.random.default_rng(15 + pos)
    L, C, KHD = STEP_QWEN["num_layers"], 32, 16
    kc, vc = (rng.standard_normal((L, C, KHD)).astype(np.float32) * 0.5 for _ in range(2))
    tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    kw = dict(nq=4, nkv=2, hd=8)
    x = (rng.standard_normal((1, 32)) * 0.3).astype(np.float32)
    cos, sin = (np.array(a)[0] for a in j_rope_cos_sin(jnp.asarray([[pos]]), 8, 1e6))
    jargs = (jnp.asarray(np.pad(x, ((0, 7), (0, 0)))), jnp.asarray(kc), jnp.asarray(vc),
             jnp.asarray(pos), jnp.asarray(cos), jnp.asarray(sin))
    y_x, nk, nv = jax.jit(jax_step.lm_step_xla, static_argnames=("nq", "nkv", "hd"))(
        jw, *jargs, **kw)
    y_p, nk_p, nv_p = jax_step.lm_step_fused(jw, *jargs, **kw, interpret=True)
    got = K6.lm_step(tw, torch.from_numpy(x), tkc, tvc, pos, torch.from_numpy(cos),
                     torch.from_numpy(sin), **kw)
    for want in (y_x, y_p):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want)[0], atol=2e-5, rtol=2e-5)
    for new in (nk, nk_p):
        np.testing.assert_allclose(tkc[:, pos].numpy(), np.asarray(new), atol=2e-5, rtol=2e-5)
    for new in (nv, nv_p):
        np.testing.assert_allclose(tvc[:, pos].numpy(), np.asarray(new), atol=2e-5, rtol=2e-5)
    rest = np.arange(C) != pos
    np.testing.assert_array_equal(tkc.numpy()[:, rest], kc[:, rest])
    np.testing.assert_array_equal(tvc.numpy()[:, rest], vc[:, rest])


def test_lm_generate_fused_step_greedy_matches_jax():
    """At the JAX package's fused-step test shape: the port's
    lm_generate_fused_step (plain lm_step on the CPU) emits exactly the
    tokens of the JAX lm_generate_fused_step (Pallas interpret) and of the
    port's own lm_generate."""
    qwen = dict(vocab_size=80, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
                head_dim=8, intermediate_size=64)
    cfg = dict(llm_input_size=32, llm_output_size=32, speech_token_size=24)
    rng = np.random.default_rng(5)
    t = jnp.asarray(rng.integers(0, 80, (1, 6)))
    jfp = jllm.Qwen2LM(jllm.LMConfig(**cfg, qwen=JQwen2Config(**qwen)))
    params = jquant.quantize_qwen_int8(jax.jit(lambda k: jfp.init(
        k, t, jnp.asarray([6]), t % 24, jnp.asarray([6])))(jax.random.PRNGKey(0)))
    greedy = dict(method="greedy")
    jm = jllm.Qwen2LM(jllm.LMConfig(**cfg, qwen=JQwen2Config(**qwen, quant="int8"),
                                    sampling=jllm.SamplingConfig(**greedy)))
    tm = tllm.Qwen2LM(tllm.LMConfig(**cfg, qwen=TQwen2Config(**qwen, quant="int8"),
                                    sampling=tllm.SamplingConfig(**greedy)))
    tm.load_state_dict(convert.lm_state_from_jax(params), strict=True)
    tm.eval()

    inputs = (rng.integers(0, 80, (1, 7)), [7], rng.integers(0, 24, (1, 5)), [5], [2], [40])
    out_j, cnt_j = jllm.lm_generate_fused_step(
        jm, params, jax_step.pack_step_weights(params, 2), *map(jnp.asarray, inputs),
        jax.random.PRNGKey(2), max_steps=48, cache_len=128, interpret=True)
    targs = [torch.as_tensor(np.asarray(a)) for a in inputs]
    out_t, cnt_t = tllm.lm_generate_fused_step(
        tm, K6.pack_step_weights(tm.body.state_dict(), 2), *targs, None, max_steps=48,
        cache_len=128)
    out_r, cnt_r = tllm.lm_generate(tm, *targs, None, max_steps=48, cache_len=128)
    n = int(cnt_j[0])
    assert int(cnt_t[0]) == int(cnt_r[0]) == n and n > 0
    np.testing.assert_array_equal(out_t[0, :n].numpy(), np.asarray(out_j)[0, :n])
    np.testing.assert_array_equal(out_r[0, :n].numpy(), np.asarray(out_j)[0, :n])


def test_quant_decode_wrappers_reject_bad_input():
    z = lambda *s, dt=torch.float32: torch.zeros(*s, dtype=dt)
    with pytest.raises(ValueError):       # x's in != 2 * packed rows
        K5.int4_matmul(z(2, 64), z(16, 8, dt=torch.int8), z(2, 8))
    with pytest.raises(ValueError):       # groups do not tile the packed rows
        K5.int4_matmul(z(2, 64), z(32, 8, dt=torch.int8), z(3, 8))
    with pytest.raises(ValueError):
        tquant.quantize_kernel_int4(z(8, 12), group_size=8)
    _, _, tw = _step_models()
    kc = z(3, 32, 16)
    with pytest.raises(ValueError):       # pos outside the cache
        K6.lm_step(tw, z(1, 32), kc, kc.clone(), 32, z(8), z(8), nq=4, nkv=2, hd=8)
    with pytest.raises(ValueError):       # cache of the wrong width
        K6.lm_step(tw, z(1, 32), z(3, 32, 8), z(3, 32, 8), 3, z(8), z(8), nq=4, nkv=2, hd=8)
    assert not tllm.lm_step_supported(TQwen2Config(**STEP_QWEN, quant="int8"))
    assert tllm.lm_step_supported(TQwen2Config(quant="int8"))
    assert not tllm.lm_step_supported(TQwen2Config(quant="int4"))
    # int4xla builds, its projections holding nibble values [in, out] and
    # group scales [in/g, out] (tests/test_torch_int4xla.py holds it to JAX)
    xla = tllm.Qwen2LM(tllm.LMConfig(**U.LM, qwen=TQwen2Config(**U.QWEN, quant="int4xla",
                                                                quant_group=16)))
    q = xla.body.layers[0].self_attn["q_proj"]
    assert q.quant == "int4xla" and q.weight.dtype == torch.int8
    assert q.weight.shape == (32, 32) and q.scale.shape == (2, 32)
    assert not tllm.lm_step_supported(TQwen2Config(quant="int4xla"))
