"""K4 (the whole DiT block) in the port against the JAX package on the CPU:
`dit_block_plain` against the Pallas kernel in interpret mode, and the
estimator and the ragged flow with `fused_block` against the JAX package
taking its fused route.  Inputs come from seeded numpy generators."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_util as U
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)
from cosyvoice_tpu.models import flow as jflow
from cosyvoice_tpu.ops.pallas import dit_block as JDB
from cosyvoice_tpu_torch import convert
from cosyvoice_tpu_torch.models import flow as tflow
from cosyvoice_tpu_torch.ops.kernels import dit_block as TDB


def _block_inputs(rng, B, T, dim, heads, head_dim):
    inner, ff = heads * head_dim, 4 * dim
    f = lambda *s, scale=0.1: (rng.standard_normal(s) * scale).astype(np.float32)
    x = f(B, T, dim, scale=0.5)
    params = dict(g1=1.0 + f(dim), b1=f(dim), wqkv=f(dim, 3 * inner), wo=f(inner, dim),
                  bo=f(dim), g3=1.0 + f(dim), b3=f(dim), wi=f(dim, ff), bi=f(ff),
                  wo2=f(ff, dim), bo2=f(dim))
    return x, params


def test_dit_block_plain_matches_pallas_kernel():
    """dit_block_plain == the JAX kernel (interpret mode) on every row, fp32,
    2e-5: the same rounding points in fp32 (a no-op), and the two softmaxes
    (max-subtracted here, exp2 clamped at 108 there) agree where the clamp
    does not bind; only the order of fp32 sums differs.  The length-0 row
    must give the same finite values (attention output 0) in both."""
    rng = np.random.default_rng(40)
    B, T, dim, H, D = 4, 256, 128, 2, 64
    x, p = _block_inputs(rng, B, T, dim, H, D)
    lens = np.asarray([200, 256, 100, 0], np.int32)
    want = JDB.dit_block_fused(jnp.asarray(x), jnp.asarray(lens),
                               *(jnp.asarray(v) for v in p.values()),
                               sm_scale=1.0 / np.sqrt(D), heads=H, head_dim=D,
                               interpret=True)
    got = TDB.dit_block_fused(torch.from_numpy(x), torch.from_numpy(lens),
                              *(torch.from_numpy(v) for v in p.values()),
                              sm_scale=1.0 / np.sqrt(D), heads=H, head_dim=D)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_dit_block_wrapper_rejects_bad_shapes():
    x = torch.zeros(1, 128, 128)
    _, p = _block_inputs(np.random.default_rng(0), 1, 128, 128, 2, 64)
    p = {k: torch.from_numpy(v) for k, v in p.items()}
    p["wo"] = p["wo"][:64]
    with pytest.raises(ValueError, match="does not take"):
        TDB.dit_block_fused(x, torch.tensor([128]), *p.values(), sm_scale=0.125, heads=2,
                            head_dim=64)


def _count_calls(monkeypatch, module, name) -> list:
    calls, orig = [], getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or orig(*a, **k))
    return calls


def _fused_jax_route(monkeypatch) -> list:
    """Make the JAX estimator take its fused-block route on the CPU: it does
    so only where jax.default_backend() is "tpu", and its Pallas kernels run
    in interpret mode here.  Returns the list its kernel calls append to."""
    U.interpret_pallas(monkeypatch)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    return _count_calls(monkeypatch, JDB, "dit_block_fused")


def _est_kwargs(fused_block: bool) -> dict:
    # 128 channels and 2 x 64 heads: the widths the fused block takes
    return dict(U.est_kwargs(True), fused_block=fused_block)


@pytest.fixture(scope="module")
def flow128():
    """(JAX flow, its params, the port's config) at the widths the fused block
    takes.  The params are made by tracing inference with one Euler step:
    flax draws each parameter from its module path, so they equal those of a
    ten-step trace, which takes longer to compile."""
    jcfg, tcfg = U.flow_configs(True)
    jcfg = dataclasses.replace(jcfg, estimator=jflow.EstimatorConfig(
        **_est_kwargs(True), causal=True, channels=(128,)))
    tcfg = dataclasses.replace(tcfg, estimator=tflow.EstimatorConfig(
        **_est_kwargs(True), causal=True, channels=(128,)))
    jm = jflow.CausalMaskedDiffWithXvec(jcfg)
    params = jax.jit(lambda k: jm.init(
        k, jnp.zeros((1, 8), jnp.int32), jnp.asarray([8]), jnp.zeros((1, 4, U.N_MEL)),
        jnp.zeros((1, 24)), n_timesteps=1,
        method=jflow.CausalMaskedDiffWithXvec.inference))(U.KEY)
    return jm, params, tcfg


def test_estimator_fused_block_matches(flow128, monkeypatch):
    """ConditionalDecoder with fused_block (every DiT block through K4) against
    the JAX estimator with the same flag, fp32, 2e-4 (the bar of
    test_estimator_matches).  T=100 pads to 128; row 1 is ragged."""
    jm, flow_params, tcfg = flow128
    jax_calls = _fused_jax_route(monkeypatch)
    rng = np.random.default_rng(41)
    B, T, C = 2, 100, U.N_MEL
    x, mu, cond = (rng.standard_normal((B, T, C)).astype(np.float32) for _ in range(3))
    spks = rng.standard_normal((B, C)).astype(np.float32)
    mask = (np.arange(T)[None] < np.asarray([100, 61])[:, None]).astype(np.float32)
    t = np.asarray([0.3, 0.8], np.float32)
    inputs = (x, mask, mu, t, spks, cond)
    params = {"params": flow_params["params"]["decoder"]["estimator"]}
    want = jax.jit(jflow.ConditionalDecoder(jm.cfg.estimator).apply)(
        params, *map(jnp.asarray, inputs))
    tm = tflow.ConditionalDecoder(tcfg.estimator)
    tm.load_state_dict(convert.estimator_state_from_jax(params), strict=True)
    calls = _count_calls(monkeypatch, TDB, "dit_block_plain")
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, inputs))
    assert jax_calls and len(calls) == 3            # one per DiT block: down, mid, up
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)


def test_ragged_flow_inference_matches(flow128, monkeypatch):
    """CausalMaskedDiffWithXvec.inference with per-row prompt_feat_len (ragged
    batched serving: conditioning zeroed past each row's prompt, the whole mel
    returned), B=3, fp32, 2e-3 (the test_token_to_mel_matches bar), with the
    fused-block estimator on both sides."""
    jm, params, tcfg = flow128
    jax_calls = _fused_jax_route(monkeypatch)
    calls = _count_calls(monkeypatch, TDB, "dit_block_plain")
    rng = np.random.default_rng(42)
    B, Ttok, P = 3, 24, 12
    token = rng.integers(0, U.SPEECH_VOCAB, (B, Ttok))
    tlen = np.asarray([24, 17, 9])
    pfl = np.asarray([12, 6, 0])
    pf = rng.standard_normal((B, P, U.N_MEL)).astype(np.float32)
    emb = rng.standard_normal((B, 24)).astype(np.float32)
    noise = rng.standard_normal((1, 2 * Ttok, U.N_MEL)).astype(np.float32)
    want = jax.jit(lambda *a: jm.apply(params, *a[:4], noise=a[5], prompt_feat_len=a[4],
                                       method=jflow.CausalMaskedDiffWithXvec.inference))(
        *map(jnp.asarray, (token, tlen, pf, emb, pfl, noise)))
    tm = tflow.CausalMaskedDiffWithXvec(tcfg)
    tm.load_state_dict(convert.flow_state_from_jax(params), strict=True)
    got = tm.inference(*map(torch.from_numpy, (token, tlen, pf, emb)),
                       noise=torch.from_numpy(noise), prompt_feat_len=torch.from_numpy(pfl))
    assert got.shape == want.shape == (B, 2 * Ttok, U.N_MEL)
    assert jax_calls and len(calls) == 3 * 10       # 3 DiT blocks x 10 Euler steps
    for b in range(B):          # the rows the caller keeps: [0, ratio * token_len)
        n = 2 * int(tlen[b])
        np.testing.assert_allclose(got[b, :n].numpy(), np.asarray(want)[b, :n], atol=2e-3,
                                   rtol=2e-3)
