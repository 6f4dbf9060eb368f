"""The port's BigVGAN token->wav vocoder against the JAX package on the CPU:
the fused anti-aliased snake's plain version (the CPU route of K7) against
the Pallas kernel in interpret mode on every sample, edges included (2e-5);
the composite resamplers (1e-5, PARITY.md's bar); the whole forward, wav and
aux mel, with the JAX params carried over by convert.bigvgan_state_from_jax
(2e-4, PARITY.md's bar); and the recipe constant against the yaml."""
import dataclasses
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_util as U
from cosyvoice_tpu.config import build_from_yaml
from cosyvoice_tpu.models import bigvgan as jb
from cosyvoice_tpu.models.conformer import ConformerConfig as JConformerConfig
from cosyvoice_tpu.ops.pallas.snake_aa import snake_aa_pallas
from cosyvoice_tpu_torch import convert
from cosyvoice_tpu_torch.models import bigvgan as tb
from cosyvoice_tpu_torch.models.conformer import ConformerConfig as TConformerConfig
from cosyvoice_tpu_torch.ops import resample
from cosyvoice_tpu_torch.ops.kernels import snake_aa as K7

RECIPE_YAML = (Path(__file__).resolve().parents[1]
               / "examples/tts_vc/cosyvoice2/conf/cosyvoice2_bigvgan_tts.yaml")
# tests/test_bigvgan.py's SMALL, and a variant with one 1-block 32-d conformer
# (as encoder2, so the aux mel head reads the encoder: without encoder2 it
# reads conv_pre + cond_layer, the SMALL variants' route)
SMALL = dict(vocab_size=30, input_size=16, output_size=16, mel_bin=8, upsample_rates=(4, 2),
             upsample_kernel_sizes=(8, 4), upsample_initial_channel=32,
             resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
             speaker_embedding_dim=8)
ENCODER = dict(dim=32, heads=2, linear_units=32, num_blocks=1, input_size=16)
VARIANTS = {"resblock1": dict(resblock="1"), "resblock2": dict(resblock="2"),
            "encoder": dict(resblock="1", encoder2=ENCODER)}


def _inputs(seed: int, shape, beta: bool, logscale: bool):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    C = shape[-1]
    alpha, b = (rng.standard_normal(C).astype(np.float32) * 0.3 for _ in range(2))
    if not logscale:        # raw alpha/beta near the init of ones
        alpha, b = alpha + 1.0, b + 1.0
    return x, alpha, (b if beta else None)


@pytest.mark.parametrize("shape,beta,logscale", [
    ((2, 700, 24), True, True),
    ((1, 5, 3), False, True),       # T < 6: both edges clamp; beta absent
    ((1, 130, 96), True, False),
], ids=["snakebeta", "short_snake", "linear_scale"])
def test_snake_aa_plain_matches_pallas_kernel(shape, beta, logscale, monkeypatch):
    U.interpret_pallas(monkeypatch)
    x, alpha, b = _inputs(1, shape, beta, logscale)
    want = np.asarray(snake_aa_pallas(jnp.asarray(x), jnp.asarray(alpha),
                                      None if b is None else jnp.asarray(b), logscale))
    got = K7.snake_aa(torch.from_numpy(x), torch.from_numpy(alpha),
                      None if b is None else torch.from_numpy(b), logscale)
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_snake_aa_plain_channels_first_matches_pallas_kernel(monkeypatch):
    """The plain version (K7's CPU route) on a channels-first x, the memory
    BigVGAN's convolutions give, against the Pallas kernel on the same
    values (the shape and inputs of the snakebeta case above); y comes back
    channels-first."""
    U.interpret_pallas(monkeypatch)
    x, alpha, b = _inputs(1, (2, 700, 24), True, True)
    want = np.asarray(snake_aa_pallas(jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(b), True))
    xcf = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1))).transpose(1, 2)
    for fn in (K7.snake_aa_plain, K7.snake_aa):
        got = fn(xcf, torch.from_numpy(alpha), torch.from_numpy(b), True)
        assert got.transpose(1, 2).is_contiguous()
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_resample_matches_jax():
    x, alpha, beta = _inputs(2, (2, 50, 4), True, True)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    np.testing.assert_array_equal(resample.kaiser_sinc_filter1d(0.25, 0.3, 12),
                                  jb.kaiser_sinc_filter1d(0.25, 0.3, 12))
    for fj, ft in ((jb.upsample2, resample.upsample2), (jb.downsample2, resample.downsample2)):
        np.testing.assert_allclose(ft(xt).numpy(), np.asarray(fj(xj)), atol=1e-5, rtol=0)
    for b in (beta, None):
        want = jb.anti_alias_activation(xj, jnp.asarray(alpha),
                                        None if b is None else jnp.asarray(b), True)
        got = resample.anti_alias_activation(xt, torch.from_numpy(alpha),
                                             None if b is None else torch.from_numpy(b), True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def _configs(variant: str, kernel: bool):
    kw = dict(SMALL, **VARIANTS[variant], use_pallas_act=kernel)
    jkw = {k: (JConformerConfig(**v) if k.startswith("encoder") else v) for k, v in kw.items()}
    tkw = {k: (TConformerConfig(**v) if k.startswith("encoder") else v) for k, v in kw.items()}
    return jb.BigVGANConfig(**jkw), tb.BigVGANConfig(**tkw)


def _batch():
    """Ragged rows (12 and 7 tokens) with a negative pad id."""
    rng = np.random.default_rng(3)
    token = rng.integers(0, SMALL["vocab_size"], (2, 12)).astype(np.int32)
    token[1, 7:] = -1
    tlen = np.array([12, 7], np.int32)
    spk = rng.standard_normal((2, SMALL["speaker_embedding_dim"])).astype(np.float32)
    return token, tlen, spk


@lru_cache(maxsize=None)
def _params(variant: str):
    """Random JAX params (they do not depend on use_pallas_act)."""
    jcfg, _ = _configs(variant, False)
    return U.random_params(jb.BigVGAN(jcfg).init, U.KEY, *map(jnp.asarray, _batch()))


@pytest.mark.parametrize("variant,kernel", [
    ("resblock1", False), ("resblock1", True), ("resblock2", True), ("encoder", False)])
def test_bigvgan_matches_jax(variant, kernel, monkeypatch):
    U.interpret_pallas(monkeypatch)
    jcfg, tcfg = _configs(variant, kernel)
    params = _params(variant)
    token, tlen, spk = _batch()
    wav_j, mel_j = jax.jit(jb.BigVGAN(jcfg).apply)(params, jnp.asarray(token),
                                                   jnp.asarray(tlen), jnp.asarray(spk))
    model = tb.BigVGAN(tcfg)
    model.load_state_dict(convert.bigvgan_state_from_jax(params, tcfg), strict=True)
    K7.launches = 0
    wav_t, mel_t = model.eval()(torch.from_numpy(token).long(), torch.from_numpy(tlen).long(),
                                torch.from_numpy(spk))
    n_enc = 1 if variant == "encoder" else 0
    assert wav_t.shape == wav_j.shape == (2, 12 * 8 * 2 ** n_enc)
    assert mel_t.shape == mel_j.shape
    np.testing.assert_allclose(wav_t.numpy(), np.asarray(wav_j), atol=2e-4, rtol=0)
    np.testing.assert_allclose(mel_t.numpy(), np.asarray(mel_j), atol=2e-4, rtol=0)
    assert K7.launches == 0         # the kernel counts launches on the card only


def test_recipe_constant_matches_yaml():
    """The full-width config that chip_smoke.py drives equals, field by field,
    the one the JAX package builds from the recipe's yaml."""
    _, jcfg = build_from_yaml(str(RECIPE_YAML), "bigvgan")
    rcfg = tb.RECIPE
    for f in dataclasses.fields(rcfg):
        if f.name == "use_pallas_act":
            continue
        got, want = getattr(rcfg, f.name), getattr(jcfg, f.name)
        if f.name.startswith("encoder"):
            assert (got is None) == (want is None), f.name
            for g in dataclasses.fields(got):
                assert getattr(got, g.name) == getattr(want, g.name), f"{f.name}.{g.name}"
        else:
            assert got == want, f.name
    assert {f.name for f in dataclasses.fields(rcfg)} == {
        f.name for f in dataclasses.fields(jcfg)}
