"""The port's VITS decoder and spline flows against the JAX package on the
CPU (tests/test_vits.py's SMALL shapes).  One seeded reference-named state
dict goes into the port (strictly) and through the JAX package's
import_vits_torch, so every module below runs on the same weights.  Bars
(fp32): linear_spectrogram 1e-5 + 1e-5 relative; WindowRelAttention on ragged masks, WN with
and without g, the coupling block both ways and the generator 2e-5; the
inference wav on the JAX noise draw, with and without the upsample
conformers, 3e-4 (the JAX package's own bar against the reference); the
spline transform and ConvFlow both ways 1e-5 (log-determinants 1e-4,
tests/test_vits.py's bar); the state dict back from
convert.vits_state_from_jax / conv_flow_state_from_jax exact."""
import dataclasses
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_util as U
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)
from cosyvoice_tpu.config import build_from_yaml
from cosyvoice_tpu.models import vits as jv
from cosyvoice_tpu.models.conformer import ConformerConfig as JConformerConfig
from cosyvoice_tpu.ops import splines as jsp
from cosyvoice_tpu_torch import convert
from cosyvoice_tpu_torch.models import vits as tv
from cosyvoice_tpu_torch.models.conformer import ConformerConfig as TConformerConfig
from cosyvoice_tpu_torch.ops import splines as tsp
from cosyvoice_tpu_torch.utils.checkpoint import load_by_name

RECIPE_YAML = (Path(__file__).resolve().parents[1]
               / "examples/tts_vc/cosyvoice2/conf/cosyvoice2_vits_tts.yaml")
SMALL = dict(n_vocab=30, spec_channels=33, inter_channels=16, hidden_channels=16,
             filter_channels=24, n_heads=2, n_layers=2, kernel_size=3,
             resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3, 5),),
             upsample_rates=(4, 3), upsample_initial_channel=32, upsample_kernel_sizes=(8, 7),
             segment_size=96, gin_channels=8, sample_rate=1200, frame_rate=25,
             token_upsample_ratio=4)
# the two 2x upsample conformers of the recipe, one block each at 16 wide
UP = dict(dim=16, heads=2, linear_units=16, num_blocks=1, input_size=16)


def _cfgs(conformers: bool):
    up = lambda C, **kw: C(**UP, **kw) if conformers else None
    return (jv.VitsConfig(**SMALL, up_enc1=up(JConformerConfig, dropout_rate=0.0,
                                              attention_dropout_rate=0.0),
                          up_enc2=up(JConformerConfig, dropout_rate=0.0,
                                     attention_dropout_rate=0.0)),
            tv.VitsConfig(**SMALL, up_enc1=up(TConformerConfig), up_enc2=up(TConformerConfig)))


@lru_cache(maxsize=None)
def _vits(conformers: bool):
    """-> (JAX config, JAX params, port model, the reference-named state)."""
    jcfg, tcfg = _cfgs(conformers)
    tm = tv.VitsDecoder(tcfg)
    ref = U.seeded_state(tm, 20 + conformers)
    tm.load_state_dict(ref, strict=True)
    params = jv.import_vits_torch({k: v.numpy() for k, v in ref.items()}, jcfg)
    return jcfg, params, tm.eval(), ref


def _close(got, want, tol, msg="", rtol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=rtol,
                               err_msg=msg)


def _ragged(rng, B, T, C, lens):
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    mask = np.arange(T)[None] < np.asarray(lens)[:, None]
    return x, mask


def test_linear_spectrogram_matches_jax():
    y = (np.random.default_rng(0).standard_normal((2, 2400)) * 0.3).astype(np.float32)
    for n_fft, hop in ((256, 64), (1024, 300)):
        want = jv.linear_spectrogram(jnp.asarray(y), n_fft, hop, n_fft)
        got = tv.linear_spectrogram(torch.from_numpy(y), n_fft, hop, n_fft)
        assert got.shape == want.shape
        _close(got, want, 1e-5, f"n_fft {n_fft}", rtol=1e-5)


def test_window_rel_attention_ragged():
    """Both layers of the prior encoder's attention, rows of 11, 5 and 1 of
    11 (the -1e4 fill and the pad/reshape tricks at T above and below the
    window), and T = 3 (under the window)."""
    _, params, tm, _ = _vits(False)
    rng = np.random.default_rng(1)
    for T, lens in ((11, (11, 5, 1)), (3, (3, 2, 1))):
        x, mask = _ragged(rng, 3, T, 16, lens)
        attn_mask = mask[:, :, None] & mask[:, None, :]
        for i in range(2):
            want = jv.WindowRelAttention(16, 2).apply(
                {"params": params["params"]["encoder"][f"attn_{i}"]}, jnp.asarray(x),
                jnp.asarray(attn_mask))
            got = tm.enc_p.encoder.attn_layers[i](torch.from_numpy(x),
                                                  torch.from_numpy(attn_mask))
            _close(got, want, 2e-5, f"layer {i} T {T}")


@pytest.mark.parametrize("with_g", [False, True])
def test_wn(with_g):
    """The posterior encoder's 16-layer WN (its last layer's skip only), its
    cond_layer sliced a layer with g."""
    _, params, tm, _ = _vits(False)
    rng = np.random.default_rng(2)
    x, mask = _ragged(rng, 2, 13, 16, (13, 6))
    g = rng.standard_normal((2, 1, 8)).astype(np.float32) if with_g else None
    want = jv.WN(16, 5, 1, 16, 8).apply(
        {"params": params["params"]["enc_q_wn"]}, jnp.asarray(x), jnp.asarray(mask),
        None if g is None else jnp.asarray(g))
    got = tm.enc_q.enc(torch.from_numpy(x), torch.from_numpy(mask),
                       None if g is None else torch.from_numpy(g))
    _close(got, want, 2e-5)


def test_coupling_block_both_ways():
    _, params, tm, _ = _vits(False)
    rng = np.random.default_rng(3)
    x, mask = _ragged(rng, 2, 10, 16, (10, 7))
    g = rng.standard_normal((2, 1, 8)).astype(np.float32)
    jm = jv.ResidualCouplingBlock(16, 16, gin_channels=8)
    for reverse in (False, True):
        want = jm.apply({"params": params["params"]["flow"]}, jnp.asarray(x),
                        jnp.asarray(mask), jnp.asarray(g), reverse=reverse)
        got = tm.flow(torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(g),
                      reverse=reverse)
        _close(got, want, 2e-5, f"reverse={reverse}")
    # reverse undoes forward on the valid rows
    y = tm.flow(torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(g))
    back = tm.flow(y, torch.from_numpy(mask), torch.from_numpy(g), reverse=True)
    np.testing.assert_allclose(back.detach().numpy()[mask], x[mask], atol=1e-5)


def test_generator():
    jcfg, params, tm, _ = _vits(False)
    rng = np.random.default_rng(4)
    z = rng.standard_normal((2, 7, 16)).astype(np.float32)
    g = rng.standard_normal((2, 1, 8)).astype(np.float32)
    jm = jv.VitsGenerator(jcfg.upsample_initial_channel, jcfg.upsample_rates,
                          jcfg.upsample_kernel_sizes, jcfg.resblock_kernel_sizes,
                          jcfg.resblock_dilation_sizes, jcfg.gin_channels)
    want = jm.apply({"params": params["params"]["dec"]}, jnp.asarray(z), jnp.asarray(g))
    got = tm.dec(torch.from_numpy(z), torch.from_numpy(g))
    assert got.shape == want.shape == (2, 7 * 12)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("conformers", [False, True], ids=["plain", "upsample_conformers"])
def test_inference_pinned_noise(conformers):
    """tokens -> wav on two ragged rows at noise_scale 0.5, the port given the
    JAX package's own draw (jax.random.normal of m_p's shape, [B, T', inter])."""
    jcfg, params, tm, _ = _vits(conformers)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, SMALL["n_vocab"], (2, 12))
    tlen = np.array([12, 8])
    g = rng.standard_normal((2, 8)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = jax.jit(lambda *a: jv.VitsDecoder(jcfg).apply(
        *a, noise_scale=0.5, method=jv.VitsDecoder.inference))(
        params, jnp.asarray(tokens), jnp.asarray(tlen), jnp.asarray(g), key)
    up = 4 if conformers else 1
    noise = np.array(jax.random.normal(key, (2, 12 * up, 16)))
    got = tm.inference(torch.from_numpy(tokens), torch.from_numpy(tlen), torch.from_numpy(g),
                       noise=torch.from_numpy(noise), noise_scale=0.5)
    assert got.shape == want.shape == (2, 12 * up * 12)
    _close(got, want, 3e-4)
    assert np.abs(np.asarray(want)).max() > 1e-3
    # a generator's draw on the CPU gives the same wav on any device: here,
    # equal to the same draw passed as noise
    gen_wav = tm.inference(torch.from_numpy(tokens), torch.from_numpy(tlen),
                           torch.from_numpy(g), gen=torch.Generator().manual_seed(3))
    drawn = torch.randn((2, 12 * up, 16), generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(
        gen_wav.numpy(), tm.inference(torch.from_numpy(tokens), torch.from_numpy(tlen),
                                      torch.from_numpy(g), noise=drawn).numpy())


@pytest.mark.parametrize("tails", [None, "linear"])
def test_spline_transform(tails):
    """The spline both ways against the JAX package's, inputs inside and (with
    linear tails) outside the bound; the inverse undoes the forward."""
    rng = np.random.default_rng(6)
    N, bins = 64, 10
    bound = 5.0 if tails else 1.0
    x = (rng.standard_normal(N) * 3.0).astype(np.float32) if tails else \
        rng.random(N).astype(np.float32)
    uw, uh = (rng.standard_normal((N, bins)).astype(np.float32) for _ in range(2))
    ud = rng.standard_normal((N, bins - 1 if tails else bins + 1)).astype(np.float32)
    kw = dict(tails=tails, tail_bound=bound) if tails else {}
    for inverse in (False, True):
        want, want_lad = jsp.piecewise_rational_quadratic_transform(
            *(jnp.asarray(a) for a in (x, uw, uh, ud)), inverse=inverse, **kw)
        got, got_lad = tsp.piecewise_rational_quadratic_transform(
            *(torch.from_numpy(a) for a in (x, uw, uh, ud)), inverse=inverse, **kw)
        _close(got, want, 1e-5, f"inverse={inverse}")
        _close(got_lad, want_lad, 1e-4, f"inverse={inverse}")
    y, _ = tsp.piecewise_rational_quadratic_transform(
        *(torch.from_numpy(a) for a in (x, uw, uh, ud)), **kw)
    back, _ = tsp.piecewise_rational_quadratic_transform(
        y, *(torch.from_numpy(a) for a in (uw, uh, ud)), inverse=True, **kw)
    np.testing.assert_allclose(back.numpy(), x, atol=1e-4)


def test_searchsorted_rule_matches_torch_searchsorted():
    """The JAX bin rule (count of knots <= x, last knot raised by eps, - 1)
    is torch.searchsorted(right=True) - 1 on the raised knots."""
    rng = np.random.default_rng(7)
    knots = np.sort(rng.standard_normal((40, 11)), axis=-1).astype(np.float32)
    x = rng.standard_normal(40).astype(np.float32)
    x[30:35] = knots[30:35, 3]                 # exactly on an inner knot
    x[35:] = knots[35:, -1]                    # and on the last one
    ours = tsp._searchsorted(torch.from_numpy(knots), torch.from_numpy(x))
    raised = torch.from_numpy(knots).clone()
    raised[:, -1] += 1e-6
    ref = torch.searchsorted(raised, torch.from_numpy(x)[:, None], right=True)[:, 0] - 1
    np.testing.assert_array_equal(ours.numpy(), ref.numpy())
    np.testing.assert_array_equal(
        ours.numpy(), np.asarray(jsp._searchsorted(jnp.asarray(knots), jnp.asarray(x))))


def _conv_flow():
    C, F, K, L = 4, 12, 3, 2
    tm = tv.ConvFlow(C, F, K, L)
    ref = U.seeded_state(tm, 30)
    tm.load_state_dict(ref, strict=True)
    return jv.ConvFlow(C, F, K, L), tm.eval(), ref


def test_conv_flow_both_ways():
    jm, tm, ref = _conv_flow()
    params = jv.import_conv_flow_torch({k: v.numpy() for k, v in ref.items()}, 2)
    rng = np.random.default_rng(8)
    x, mask = _ragged(rng, 2, 9, 4, (9, 6))
    x[..., 2:] *= 3.0                     # the transformed half: some values past the tails
    fwd = jax.jit(jm.apply, static_argnames="reverse")
    want, want_logdet = fwd(params, jnp.asarray(x), jnp.asarray(mask))
    got, got_logdet = tm(torch.from_numpy(x), torch.from_numpy(mask))
    _close(got, want, 1e-5)
    _close(got_logdet, want_logdet, 1e-4)
    # reverse, both on the JAX forward's output
    want_rev = fwd(params, want, jnp.asarray(mask), reverse=True)
    got_rev = tm(torch.from_numpy(np.asarray(want)), torch.from_numpy(mask), reverse=True)
    _close(got_rev, want_rev, 1e-5)
    back = tm(got, torch.from_numpy(mask), reverse=True)
    np.testing.assert_allclose(back.detach().numpy(), x * mask[..., None], atol=1e-4)


def test_small_flows():
    """ElementwiseAffine, flip_flow and log_flow against the JAX package's."""
    rng = np.random.default_rng(9)
    x, mask = _ragged(rng, 2, 6, 4, (6, 3))
    m, logs = (rng.standard_normal(4).astype(np.float32) for _ in range(2))
    aff = tv.ElementwiseAffine(4)
    with torch.no_grad():
        aff.m.copy_(torch.from_numpy(m))
        aff.logs.copy_(torch.from_numpy(logs))
    p = {"params": {"m": jnp.asarray(m), "logs": jnp.asarray(logs)}}
    jx, jm_ = jnp.asarray(x), jnp.asarray(mask)
    tx, tm_ = torch.from_numpy(x), torch.from_numpy(mask)
    for got, want in zip(aff(tx, tm_), jv.ElementwiseAffine(4).apply(p, jx, jm_)):
        _close(got, want, 1e-5)
    _close(aff(tx, tm_, reverse=True), jv.ElementwiseAffine(4).apply(p, jx, jm_, reverse=True),
           1e-5)
    for got, want in zip(tv.flip_flow(tx), jv.flip_flow(jx)):
        _close(got, want, 0)
    pos = np.abs(x) + 0.1
    for got, want in zip(tv.log_flow(torch.from_numpy(pos), tm_),
                         jv.log_flow(jnp.asarray(pos), jm_)):
        _close(got, want, 1e-5)
    _close(tv.log_flow(tx, tm_, reverse=True), jv.log_flow(jx, jm_, reverse=True), 1e-5)


@pytest.mark.parametrize("conformers", [False, True], ids=["plain", "upsample_conformers"])
def test_reference_state_dict_both_ways(conformers):
    """A seeded state dict under the reference checkpoint's names: the JAX
    package's import_vits_torch, then convert.vits_state_from_jax, gives it
    back exactly, and load_by_name reads it into the port."""
    _, params, _, ref = _vits(conformers)
    back = convert.vits_state_from_jax(params)
    assert sorted(back) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(back[k].numpy(), ref[k].numpy(), err_msg=k)
    model = tv.VitsDecoder(_cfgs(conformers)[1])
    load_by_name(model, ref, "vits.pt")
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref[k].numpy(), err_msg=k)


def test_conv_flow_state_dict_both_ways():
    _, _, ref = _conv_flow()
    params = jv.import_conv_flow_torch({k: v.numpy() for k, v in ref.items()}, 2)
    back = convert.conv_flow_state_from_jax(params)
    assert sorted(back) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(back[k].numpy(), ref[k].numpy(), err_msg=k)


def test_recipe_constant_matches_yaml():
    """The full-width config that chip_smoke.py drives equals, field by field,
    the one the JAX package builds from the recipe's `vits:` section."""
    _, jcfg = build_from_yaml(str(RECIPE_YAML), "vits")
    rcfg = tv.RECIPE
    for f in dataclasses.fields(rcfg):
        got, want = getattr(rcfg, f.name), getattr(jcfg, f.name)
        if f.name.startswith("up_enc"):
            assert (got is None) == (want is None), f.name
            for g in dataclasses.fields(got):
                assert getattr(got, g.name) == getattr(want, g.name), f"{f.name}.{g.name}"
        else:
            assert got == want, f.name
    assert {f.name for f in dataclasses.fields(rcfg)} == {
        f.name for f in dataclasses.fields(jcfg)}
    assert rcfg.hop_length * 4 == 960 == np.prod(rcfg.upsample_rates) * 4
