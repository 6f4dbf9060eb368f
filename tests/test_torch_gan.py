"""The GAN training slice of the port against the JAX package on the CPU,
at small widths, from seeded numpy inputs; JAX parameter trees (drawn from
their shapes alone) carried into the port by convert.py:
- ops/f0.py: autocorr_f0 on sines and harmonic stacks at 80-380 Hz and on
  silence, every frame equal; on noise (near-tied lags) every frame equal
  or one lag apart; interp_to_len 1e-6;
- the discriminators (MPD + MRD, the recipes' `multiple`; MSD with
  spectral norm and 2 power iterations) on an odd length: scores and
  feature maps 1e-5; the spectral norm's sigma after sn_iters 1e-5
  relative;
- one D + G step pair of HiFT, BigVGAN and VITS (no upsample conformers:
  the conformer's training forward is tests/test_torch_train.py's) against
  an MPD, the JAX package's make_gan_steps against the port's (the port's G
  step on the JAX package's updated discriminator), each net with its own
  adam (the JAX CLI's constantlr, clip 5): every loss term of both steps
  1e-4 relative, then both nets' parameters (1e-4 but for 0.1% of the
  elements, see test_gan_step_pair_params_match_jax); noise pinned: a
  deterministic HiFT, no dropout in BigVGAN, and VITS's posterior noise and
  segment starts drawn by the JAX package's own keys and handed to the
  port;
- the draws: both steps' generators of one (seed, step) give the same
  noise, dropout masks and VITS segment; the VITS segment clamps a start
  past the end as jax.lax.dynamic_slice_in_dim does;
- GanExecutor writes both nets' checkpoints, and a run resumed from them
  ends where an unbroken run does."""
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_util as U
from torch_port_util import one_torch_thread, quick_jit  # noqa: F401 (autouse)
from cosyvoice_tpu.models import bigvgan as jb
from cosyvoice_tpu.models import discriminator as jd
from cosyvoice_tpu.models import hift as jhift
from cosyvoice_tpu.models import vits as jv
from cosyvoice_tpu.models.conformer import ConformerConfig as JConformerConfig
from cosyvoice_tpu.nn.conv import Conv1d as JConv1d
from cosyvoice_tpu.ops import f0 as jf0
from cosyvoice_tpu.ops.mel import log_mel_spectrogram as jmel
from cosyvoice_tpu.train import gan as jgan
from cosyvoice_tpu.train import optim as joptim
from cosyvoice_tpu.train import step as jstep
from cosyvoice_tpu_torch import convert
from cosyvoice_tpu_torch.models import bigvgan as tb
from cosyvoice_tpu_torch.models import discriminator as td
from cosyvoice_tpu_torch.models import hift as thift
from cosyvoice_tpu_torch.models import vits as tv
from cosyvoice_tpu_torch.models.conformer import ConformerConfig as TConformerConfig
from cosyvoice_tpu_torch.nn.conv import Conv1d as TConv1d
from cosyvoice_tpu_torch.nn.conv import _spectral
from cosyvoice_tpu_torch.nn.dropout import dropout_generator
from cosyvoice_tpu_torch.ops import f0 as tf0
from cosyvoice_tpu_torch.ops.mel import log_mel_spectrogram as tmel
from cosyvoice_tpu_torch.train import gan as tgan
from cosyvoice_tpu_torch.train import optim as toptim
from cosyvoice_tpu_torch.train import step as tstep
from cosyvoice_tpu_torch.train.checkpoint import latest_step, restore_checkpoint
from cosyvoice_tpu_torch.train.executor import GanExecutor

KEY = jax.random.PRNGKey(0)
TOL = 1e-4


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---- f0 -------------------------------------------------------------------

SR = 24000
_T = np.arange(int(SR * 0.5)) / SR
F0_SIGNALS = {f"sine_{f}": 0.3 * np.sin(2 * np.pi * f * _T) for f in (80, 147, 223, 311, 380)}
F0_SIGNALS.update({f"stack_{f}": sum(0.3 / k * np.sin(2 * np.pi * f * k * _T + k)
                                     for k in (1, 2, 3)) for f in (83, 200, 250, 377)})
F0_SIGNALS["silence"] = np.zeros_like(_T)


@lru_cache(maxsize=None)
def _jax_f0_program():
    return quick_jit(jf0.autocorr_f0, jnp.zeros(len(_T), jnp.float32))


@pytest.fixture(scope="module")
def jax_programs():
    """The module's costly JAX programs, built together on first use: XLA
    compiles them in parallel threads (the f0 tracker's unrolled lags and
    the three step pairs: 35 s together, ~50 s one after another, alone
    on an 8-core CPU)."""
    with ThreadPoolExecutor(4) as ex:
        jobs = [ex.submit(_jax_f0_program)] + [ex.submit(_step_pair, n) for n in VOCODERS]
        for job in jobs:
            job.result()


def _jax_f0(name: str):
    return np.asarray(_jax_f0_program()(jnp.asarray(_f0_signal(name))))


def _f0_signal(name: str) -> np.ndarray:
    if name == "noise":
        return (np.random.default_rng(0).standard_normal(len(_T)) * 0.1).astype(np.float32)
    return F0_SIGNALS[name].astype(np.float32)


@pytest.mark.parametrize("name", list(F0_SIGNALS))
def test_autocorr_f0_matches_jax(name, jax_programs):
    got = tf0.autocorr_f0(torch.from_numpy(_f0_signal(name))).numpy()
    want = _jax_f0(name)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert (want > 0).all() if name != "silence" else (want == 0).all()


def test_autocorr_f0_on_noise_within_one_lag(jax_programs):
    """Noise has near-equal correlations over many lags, so an argmax may
    land on another lag: each frame equal, or both unvoiced, or one lag
    apart in sr / lag (here every frame is unvoiced or equal)."""
    got = tf0.autocorr_f0(torch.from_numpy(_f0_signal("noise"))).numpy()
    want = _jax_f0("noise")
    lag = lambda f: np.where(f > 0, np.round(SR / np.maximum(f, 1e-9)), 0)  # noqa: E731
    assert (np.abs(lag(got) - lag(want)) <= 1).all()
    assert ((got > 0) == (want > 0)).all()


@pytest.mark.parametrize("T,new", [(13, 40), (40, 13), (1, 5), (25, 25)])
def test_interp_to_len_matches_jax(T, new):
    x = np.random.default_rng(T).random(T).astype(np.float32) * 300
    np.testing.assert_allclose(tf0.interp_to_len(torch.from_numpy(x), new).numpy(),
                               np.asarray(jf0.interp_to_len(jnp.asarray(x), new)),
                               atol=1e-6, rtol=1e-6)


# ---- discriminators --------------------------------------------------------

DISCS = {
    "multiple": lambda m: m.MultipleDiscriminator((2, 5), (128, 64)),
    "msd": lambda m: m.MultiScaleDiscriminator(sn_iters=2),
}


def _disc_pair(name: str, y, seed: int):
    jm = DISCS[name](jd)
    params = U.random_params(jm.init, KEY, y, y, seed=seed)
    tm = DISCS[name](td)
    tm.load_state_dict(convert.discriminator_state_from_jax(params), strict=True)
    return jm, params, tm


def _channels_last(f: torch.Tensor) -> np.ndarray:
    return _np(f.permute(0, 2, 3, 1) if f.dim() == 4 else f)


@pytest.mark.parametrize("name", list(DISCS))
def test_discriminator_matches_jax(name):
    rng = np.random.default_rng(3)
    y, y_hat = (rng.standard_normal((2, 301)).astype(np.float32) * 0.3 for _ in range(2))
    jm, params, tm = _disc_pair(name, jnp.asarray(y), 30)
    want = quick_jit(jm.apply, params, jnp.asarray(y), jnp.asarray(y_hat))(
        params, jnp.asarray(y), jnp.asarray(y_hat))
    with torch.no_grad():
        got = tm(torch.from_numpy(y), torch.from_numpy(y_hat))
    for side in (0, 1):                        # scores
        assert len(got[side]) == len(want[side])
        for g, w in zip(got[side], want[side]):
            w = np.asarray(w)
            np.testing.assert_allclose(_np(g).reshape(w.shape[0], -1), w.reshape(w.shape[0], -1),
                                       atol=1e-5, rtol=1e-5)
    for side in (2, 3):                        # feature maps
        for gd, wd in zip(got[side], want[side]):
            assert len(gd) == len(wd)
            for g, w in zip(gd, wd):
                np.testing.assert_allclose(_channels_last(g), np.asarray(w), atol=1e-5,
                                           rtol=1e-5)


@pytest.mark.parametrize("sn_iters", [0, 1, 3])
def test_spectral_norm_sigma_matches_jax(sn_iters):
    """sigma = u^T W v after sn_iters power iterations: a conv over an input
    equal to its own first output's kernel gives sum(W[0]^2) / sigma."""
    C_in, C_out, k = 6, 5, 7
    jm = JConv1d(C_out, k, use_bias=False, spectral_norm=True, sn_iters=sn_iters)
    x0 = jnp.zeros((1, k, C_in))
    params = U.random_params(jm.init, KEY, x0, seed=31)
    kern = np.asarray(params["params"]["kernel"])              # [k, in, out]
    x = jnp.asarray(kern[None, :, :, 0])
    y_jax = float(jm.apply(params, x)[0, 0, 0])
    sigma_jax = float((kern[..., 0] ** 2).sum()) / y_jax
    tm = TConv1d(C_in, C_out, k, bias=False, spectral_norm=True, sn_iters=sn_iters)
    sd = {"weight_orig": torch.from_numpy(kern.transpose(2, 1, 0).copy()),
          "weight_u": torch.from_numpy(np.asarray(params["params"]["sn_u"])),
          "weight_v": torch.from_numpy(np.asarray(params["params"]["sn_v"]))}
    tm.load_state_dict(sd, strict=True)
    sigma_port = float(tm.weight_orig.flatten()[0] / _spectral(tm).flatten()[0])
    np.testing.assert_allclose(sigma_port, sigma_jax, rtol=1e-5)
    # the buffers are not moved by a forward (the JAX package keeps no state)
    assert torch.equal(tm.weight_u, sd["weight_u"])


def test_import_msd_torch_loads_the_reference_names():
    tm = td.MultiScaleDiscriminator()
    ref = {k: v.clone() + 0.5 for k, v in tm.state_dict().items()}
    other = td.MultiScaleDiscriminator()
    other.load_state_dict(td.import_msd_torch(ref), strict=True)
    assert all(torch.equal(other.state_dict()[k], ref[k]) for k in ref)
    jp = jd.import_msd_torch({k: v.numpy() for k, v in ref.items()})
    back = convert.discriminator_state_from_jax(jp)
    assert set(back) == set(ref)
    assert all(torch.equal(back[k], ref[k]) for k in ref)


# ---- the vocoders' D + G step pair -----------------------------------------

B = 2
HIFT = dict(U.HIFT, nb_harmonics=2)
BIGVGAN = dict(vocab_size=30, input_size=16, output_size=16, mel_bin=8, upsample_rates=(4, 2),
               upsample_kernel_sizes=(8, 4), upsample_initial_channel=32,
               resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
               speaker_embedding_dim=8)
BIGVGAN_ENC = dict(dim=16, heads=2, linear_units=16, num_blocks=1, input_size=16)
VITS = dict(n_vocab=30, spec_channels=33, inter_channels=8, hidden_channels=16,
            filter_channels=16, n_heads=2, n_layers=1, kernel_size=3,
            resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
            upsample_rates=(4, 3), upsample_initial_channel=16, upsample_kernel_sizes=(8, 7),
            segment_size=96, gin_channels=8, sample_rate=1200, frame_rate=25,
            token_upsample_ratio=4)
# (sample rate, n_fft, hop, n_mels, fmax) of each vocoder's mel L1 (two resolutions)
MELS = {"hift": (2304, ((64, 16, 10), (32, 8, 6))), "bigvgan": (1200, ((64, 16, 10),)),
        "vits": (1200, ((64, 16, 10), (32, 8, 6)))}
WEIGHTS = dict(mel=45.0, feat_match=2.0, tpr=1.0, tpr_tau=0.04)


def _mel_tfs(name: str, mel):
    sr, specs = MELS[name]
    return [lambda w, n=n, h=h, m=m: mel(w, n_fft=n, hop=h, win=n, n_mels=m, sr=sr,
                                         fmax=sr / 2) for n, h, m in specs]


def _vocoder_batch(name: str, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    if name == "hift":
        T = 8
        return {"speech_feat": rng.standard_normal((B, T, U.N_MEL)).astype(np.float32),
                "speech": (rng.standard_normal((B, T * 48)) * 0.3).astype(np.float32),
                "pitch_feat": (rng.random((B, T)) * 200).astype(np.float32)}
    if name == "bigvgan":
        return {"speech_token": rng.integers(0, 30, (B, 24)).astype(np.int32),
                "speech_token_len": np.asarray([24, 18], np.int32),
                "embedding": rng.standard_normal((B, 8)).astype(np.float32),
                "speech": (rng.standard_normal((B, 192)) * 0.3).astype(np.float32),
                "speech_feat": rng.standard_normal((B, 20, 8)).astype(np.float32)}
    return {"speech_token": rng.integers(0, 30, (B, 24)).astype(np.int32),
            "speech_token_len": np.asarray([24, 20], np.int32),
            "embedding": rng.standard_normal((B, 8)).astype(np.float32),
            "speech": (rng.standard_normal((B, 288)) * 0.3).astype(np.float32),
            "speech_len": np.asarray([288, 240], np.int32)}


def _jax_vocoder(name: str):
    """-> (jax model, jax generator params, generator_apply)."""
    if name == "hift":
        jm = jhift.HiFTGenerator(jhift.HiFTConfig(**HIFT), deterministic=True)
        p = U.random_params(jm.init, {"params": KEY, "noise": KEY}, jnp.zeros((1, 4, U.N_MEL)),
                            seed=40)
        return jm, p, lambda q, b, r: jm.apply(q, b["speech_feat"], rngs={"noise": r})
    if name == "bigvgan":
        jm = jb.BigVGAN(jb.BigVGANConfig(**BIGVGAN))
        p = U.random_params(jm.init, KEY, jnp.zeros((1, 4), jnp.int32), jnp.asarray([4]),
                            jnp.zeros((1, 8)), seed=41)
        return jm, p, lambda q, b, r: jm.apply(
            q, b["speech_token"], b["speech_token_len"], b["embedding"], deterministic=False,
            rngs={"dropout": r})
    cfg = jv.VitsConfig(**VITS)
    jm = jv.VitsDecoder(cfg)
    p = U.random_params(jm.init, KEY, jnp.zeros((1, 24), jnp.int32), jnp.asarray([24]),
                        jnp.zeros((1, 24, 33)), jnp.asarray([24]), jnp.zeros((1, 8)), KEY,
                        seed=42)

    def apply(q, b, r):
        spec = jv.linear_spectrogram(b["speech"], n_fft=64, hop=cfg.hop_length, win=64)
        return jm.apply(q, b["speech_token"], b["speech_token_len"], spec,
                        b["speech_len"] // cfg.hop_length, b["embedding"], r,
                        deterministic=False, rngs={"dropout": r})
    return jm, p, apply


def _vits_draws(rng, batch: dict):
    """The posterior noise and segment starts VitsDecoder.__call__ draws
    from `rng` (its two split keys), for the port to take pinned."""
    k_q, k_slice = jax.random.split(rng)
    hop, frames = 12, VITS["segment_size"] // 12
    spec_len = batch["speech_len"] // hop
    T = batch["speech"].shape[1] // hop
    noise = jax.random.normal(k_q, (B, T, VITS["inter_channels"]))
    ids = (jax.random.uniform(k_slice, (B,)) * jnp.maximum(spec_len - frames, 1)).astype(
        jnp.int32)
    return torch.from_numpy(np.asarray(noise)), torch.from_numpy(np.asarray(ids))


def _port_vocoder(name: str, params, pinned=None):
    """-> (port model with the JAX weights, generator_apply)."""
    if name == "hift":
        tm = thift.HiFTGenerator(thift.HiFTConfig(**HIFT), deterministic=True)
        tm.load_state_dict(convert.hift_state_from_jax(params), strict=True)
        return tm, lambda m, b, g: m(b["speech_feat"], g)
    if name == "bigvgan":
        cfg = tb.BigVGANConfig(**BIGVGAN)
        tm = tb.BigVGAN(cfg)
        tm.load_state_dict(convert.bigvgan_state_from_jax(params, cfg), strict=True)
        return tm, lambda m, b, g: m(b["speech_token"], b["speech_token_len"], b["embedding"],
                                     deterministic=False)
    cfg = tv.VitsConfig(**VITS)
    tm = tv.VitsDecoder(cfg)
    tm.load_state_dict(convert.vits_state_from_jax(params), strict=True)

    def apply(m, b, g):
        spec = tv.linear_spectrogram(b["speech"], n_fft=64, hop=cfg.hop_length, win=64)
        noise, ids = pinned if pinned is not None else (None, None)
        return m(b["speech_token"], b["speech_token_len"], spec,
                 b["speech_len"] // cfg.hop_length, b["embedding"], gen=g, noise=noise, ids=ids)
    return tm, apply


def _loss_fns(pkg, name, gen_apply, disc_apply, mel_tfs):
    weights = pkg.GanLossWeights(**WEIGHTS)
    if name == "vits":
        return pkg.make_vits_loss_fns(gen_apply, disc_apply, mel_tfs, 12,
                                      VITS["segment_size"], weights, kl_weight=1.0)
    return pkg.make_gan_loss_fns(gen_apply, disc_apply, mel_tfs, weights)


OPT = ("adam", 1e-3, "constantlr", {})


def _flat(tx):
    """The JAX optimizer over one raveled vector of the tree: the same
    elementwise adam and global-norm clip, but one program of a few ops
    rather than a few ops for each of hundreds of leaves (XLA takes ~12 s to
    compile the latter for VITS)."""
    import optax
    from jax.flatten_util import ravel_pytree

    def update(g, s, p=None):
        flat, unravel = ravel_pytree(g)
        u, s = tx.update(flat, s, None if p is None else ravel_pytree(p)[0])
        return unravel(u), s
    return optax.GradientTransformation(lambda p: tx.init(ravel_pytree(p)[0]), update)


@lru_cache(maxsize=None)
def _step_pair(name: str):
    """One D + G step pair in each package from the same weights ->
    {"jax"/"port": (d metrics, g metrics, g params, d params)}."""
    batch = _vocoder_batch(name, 50)
    jm, gp, japply = _jax_vocoder(name)
    jdisc = jd.MultiPeriodDiscriminator((3,))
    wav0 = jnp.zeros((1, 96))
    dp = U.random_params(jdisc.init, KEY, wav0, wav0, seed=43)
    jg_lf, jd_lf = _loss_fns(jgan, name, japply, jdisc.apply, _mel_tfs(name, jmel))
    jtx_g, jtx_d = (_flat(joptim.make_optimizer(*OPT, grad_clip=5.0)[0]) for _ in range(2))
    g_step, d_step = jgan.make_gan_steps(jg_lf, jd_lf, jtx_g, jtx_d)

    def pair(gs, ds, b, r):            # one program: the D step, then the G step
        ds, dm = d_step(ds, gs.params, b, r)
        gs, gm = g_step(gs, (ds.params, b), r)
        return gs, ds, dm, gm

    gs, ds = jstep.make_train_state(gp, jtx_g), jstep.make_train_state(dp, jtx_d)
    jb_ = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.fold_in(KEY, 7)
    gs, ds, jdm, jgm = quick_jit(pair, gs, ds, jb_, rng)(gs, ds, jb_, rng)

    pinned = _vits_draws(rng, batch) if name == "vits" else None
    tm, tapply = _port_vocoder(name, gp, pinned)
    tdisc = td.MultiPeriodDiscriminator((3,))
    tdisc.load_state_dict(convert.discriminator_state_from_jax(dp), strict=True)
    tg_lf, td_lf = _loss_fns(tgan, name, tapply, lambda d, r, f: d(r, f), _mel_tfs(name, tmel))
    ttx_g, _ = toptim.make_optimizer(*OPT, grad_clip=5.0)
    ttx_d, _ = toptim.make_optimizer(*OPT, grad_clip=5.0)
    tg_step, td_step = tgan.make_gan_steps(tg_lf, td_lf, ttx_g, ttx_d)
    tgs, tds = tstep.make_train_state(tm, ttx_g), tstep.make_train_state(tdisc, ttx_d)
    tb_ = tstep.to_device(batch, "cpu")
    tds, tdm = td_step(tds, tgs.model, tb_, torch.Generator().manual_seed(0))
    # the G step against the JAX package's updated discriminator, so each
    # step is held to its JAX twin from the same inputs
    d_after = td.MultiPeriodDiscriminator((3,))
    d_after.load_state_dict(convert.discriminator_state_from_jax(ds.params), strict=True)
    tgs, tgm = tg_step(tgs, (d_after, tb_), torch.Generator().manual_seed(0))
    to_port = {"hift": convert.hift_state_from_jax, "vits": convert.vits_state_from_jax,
               "bigvgan": lambda p: convert.bigvgan_state_from_jax(p, tm.cfg)}[name]
    return {"jax": (jdm, jgm, to_port(gs.params), convert.discriminator_state_from_jax(ds.params)),
            "port": (tdm, tgm, tstep.trainable_params(tgs.model),
                     tstep.trainable_params(tds.model))}


VOCODERS = ("hift", "bigvgan", "vits")


@pytest.mark.parametrize("name", VOCODERS)
def test_gan_loss_terms_match_jax(name, jax_programs):
    r = _step_pair(name)
    for side in (0, 1):                 # the D step's terms, then the G step's
        want, got = r["jax"][side], r["port"][side]
        keys = set(want) - {"grad_norm"}
        assert keys <= set(got), sorted(keys - set(got))
        for k in sorted(keys):
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=TOL, atol=1e-6,
                                       err_msg=f"{name} {k}")
    terms = r["port"][1]
    assert float(terms["loss_f0" if name == "hift" else "loss_mel_recon" if name == "bigvgan"
                       else "loss_kl"]) > 0
    np.testing.assert_allclose(float(r["port"][1]["grad_norm"]),
                               float(r["jax"][1]["grad_norm"]), rtol=TOL)


@pytest.mark.parametrize("name", VOCODERS)
def test_gan_step_pair_params_match_jax(name, jax_programs):
    """After the D step and the G step, each net's parameters against the
    JAX package's: all but 0.1% of each net's elements within 1e-4, and
    every element within 2 lr + 1e-4.  Adam's first update is lr times the
    gradient's sign wherever |g| >> eps, so an element whose gradient is
    near zero (an attention key bias's, zero analytically; or one past a
    leaky-ReLU kink that a pre-activation within rounding of 0 straddles,
    3.7e-8 in the VITS discriminator here) moves by +-lr in either package
    as its rounding falls."""
    r = _step_pair(name)
    lr = OPT[1]
    for net in (2, 3):
        want, got = r["jax"][net], r["port"][net]
        assert set(got) <= set(want)
        far = total = 0
        for k, v in got.items():
            d = np.abs(_np(v) - _np(want[k]))
            assert d.max() <= 2 * lr + TOL, (name, k, float(d.max()))
            far, total = far + int((d > TOL).sum()), total + d.size
        assert far <= 1e-3 * total, (name, net, far, total)


def test_hift_magnitude_clip_keeps_gradients_finite():
    """A log-magnitude past exp's fp32 range (~88.7; a full-width HiFT's
    climbs ~10 a D + G pair from its init at the recipe's lr): the clipped
    magnitude is the JAX package's min(exp(x), 1e2)
    (cosyvoice_tpu/models/hift.py:281) and every gradient is finite, where
    that formula's gradient is the clip's 0 times exp's inf, NaN, in
    either package."""
    torch.manual_seed(0)
    m = thift.HiFTGenerator(thift.HiFTConfig(**HIFT), deterministic=True)
    nb = m.cfg.istft_n_fft // 2 + 1
    with torch.no_grad():
        m.conv_post.bias[:nb] += torch.linspace(-10.0, 120.0, nb)
    seen = {}
    m.conv_post.register_forward_hook(lambda mod, i, o: seen.__setitem__("x", o[..., :nb]))
    mel = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 8, U.N_MEL))
                           .astype(np.float32))
    wav, _ = m(mel, torch.Generator().manual_seed(0))
    x = seen["x"].detach()
    assert x.max() > 89 and x.min() < np.log(1e2)
    assert torch.equal(torch.exp(x.clamp_max(thift.MAG_LOG_CAP)).clamp_max(1e2),
                       torch.exp(x).clamp_max(1e2))
    grads = torch.autograd.grad(wav.square().sum(), list(m.parameters()))
    assert all(torch.isfinite(g).all() for g in grads)
    xg = x.clone().requires_grad_()
    assert torch.isnan(torch.autograd.grad(torch.exp(xg).clamp_max(1e2).sum(), xg)[0]).any()
    jg = jax.grad(lambda v: jnp.minimum(jnp.exp(v), 1e2).sum())(jnp.asarray(x.numpy()))
    assert np.isnan(np.asarray(jg)).any()


def _tiny_hift_gan(seed: int = 0):
    torch.manual_seed(seed)
    g = thift.HiFTGenerator(thift.HiFTConfig(**HIFT))
    d = td.MultiResolutionDiscriminator((64,))
    lf = tgan.make_gan_loss_fns(lambda m, b, gen: m(b["speech_feat"], gen),
                                lambda dd, r, f: dd(r, f), _mel_tfs("hift", tmel))
    tx = [toptim.make_optimizer(*OPT, grad_clip=5.0)[0] for _ in range(2)]
    return g, d, tgan.make_gan_steps(*lf, *tx), tx


def test_both_steps_draw_alike():
    """Generators of one (seed, step) give the two steps the same draws:
    HiFT's source noise, BigVGAN's dropout masks, VITS's posterior noise and
    segment; another step's generator gives other draws."""
    b = tstep.to_device(_vocoder_batch("hift", 51), "cpu")
    torch.manual_seed(1)
    hift = thift.HiFTGenerator(thift.HiFTConfig(**HIFT))
    draws = [hift(b["speech_feat"], tstep.step_generator(5, s, "cpu"))[0] for s in (3, 3, 4)]
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])

    cfg = tb.BigVGANConfig(**BIGVGAN, encoder2=TConformerConfig(
        **BIGVGAN_ENC, dropout_rate=0.3, attention_dropout_rate=0.3))
    big = tb.BigVGAN(cfg).train()
    bb = tstep.to_device(_vocoder_batch("bigvgan", 52), "cpu")
    outs = []
    for s in (3, 3, 4):
        with dropout_generator(tstep.step_generator(5, s, "cpu")):
            outs.append(big(bb["speech_token"], bb["speech_token_len"], bb["embedding"],
                            deterministic=False)[0])
    plain = big(bb["speech_token"], bb["speech_token_len"], bb["embedding"])[0]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    assert not torch.equal(outs[0], plain) and not plain.requires_grad and outs[0].requires_grad

    vits = tv.VitsDecoder(tv.VitsConfig(**VITS))
    vb = tstep.to_device(_vocoder_batch("vits", 53), "cpu")
    spec = tv.linear_spectrogram(vb["speech"], n_fft=64, hop=12, win=64)
    runs = [vits(vb["speech_token"], vb["speech_token_len"], spec,
                 vb["speech_len"] // 12, vb["embedding"], gen=tstep.step_generator(5, s, "cpu"))
            for s in (3, 3)]
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1][0], runs[1][1][0])


@pytest.mark.parametrize("starts", [(0, 5), (30, 100), (22, 23)])
def test_vits_segments_clamp_like_dynamic_slice(starts):
    x = np.random.default_rng(4).standard_normal((2, 30, 3)).astype(np.float32)
    got = tv.segments(torch.from_numpy(x), torch.tensor(starts), 8).numpy()
    want = jax.vmap(lambda r, s: jax.lax.dynamic_slice_in_dim(r, s, 8, axis=0))(
        jnp.asarray(x), jnp.asarray(starts, jnp.int32))
    np.testing.assert_array_equal(got, np.asarray(want))
    wav = np.arange(2 * 50, dtype=np.float32).reshape(2, 50)
    got = tv.segments(torch.from_numpy(wav), torch.tensor(starts) * 4, 12).numpy()
    want = jax.vmap(lambda r, s: jax.lax.dynamic_slice_in_dim(r, s * 4, 12, axis=0))(
        jnp.asarray(wav), jnp.asarray(starts, jnp.int32))
    np.testing.assert_array_equal(got, np.asarray(want))


def test_gan_executor_saves_both_nets_and_resumes(tmp_path):
    """Three batches in one run, against two batches, a restart from the
    checkpoints of both nets, and the third: the same parameters; both
    directories hold a step-2 checkpoint after the broken run's first
    epoch."""
    batches = [_vocoder_batch("hift", 60 + i) for i in range(3)]
    move = lambda b: tstep.to_device(b, "cpu")  # noqa: E731

    def run(model_dir, data, resume=False):
        g, d, (g_step, d_step), (tx_g, tx_d) = _tiny_hift_gan()
        gs, ds = tstep.make_train_state(g, tx_g), tstep.make_train_state(d, tx_d)
        if resume:
            gs, _ = restore_checkpoint(model_dir, gs)
            ds, _ = restore_checkpoint(model_dir + "_disc", ds)
        ex = GanExecutor(train_step=g_step, disc_step=d_step, model_dir=model_dir,
                         device="cpu", log_interval=1, rng_seed=9)
        ex.step = gs.step
        return ex.train_one_epoch_gan(gs, ds, data, to_device=move)

    whole = run(str(tmp_path / "whole"), batches)
    broken = str(tmp_path / "broken")
    run(broken, batches[:2])
    assert latest_step(broken) == latest_step(broken + "_disc") == 2
    resumed = run(broken, batches[2:], resume=True)
    for a, b in zip(whole, resumed):
        assert a.step == b.step == 3
        for k, v in a.params.items():
            torch.testing.assert_close(b.params[k], v, atol=0, rtol=0)
