"""The rest of the conformer and the wenet attention decoders: the port
against the JAX package (models/conformer.py, models/decoder.py) on small
shapes, weights carried across by convert.py, inputs drawn with numpy from
fixed seeds.  One parametrised test a module family: the positional
encodings, the mixture-of-experts FFN, the subsampling front ends, the
conv module over {batch_norm, layer_norm} x {causal, centred}, an encoder
with the macaron FFN, the conv module and the MoE FFN (its full forward,
and the cached prefill + decode steps, which keep the macaron FFN and skip
the conv module on both sides), and TransformerDecoder /
BiTransformerDecoder.  Every comparison is fp32 within 1e-5 over the valid
rows, masks applied."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_util as U
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)
from cosyvoice_tpu.models import conformer as jconf
from cosyvoice_tpu.models import decoder as jdec
from cosyvoice_tpu_torch import convert
from cosyvoice_tpu_torch.models import conformer as tconf
from cosyvoice_tpu_torch.models import decoder as tdec

TOL = dict(atol=1e-5, rtol=0)
KEY = jax.random.PRNGKey(0)


def _rng(seed):
    return np.random.default_rng(seed)


def _with_stats(variables, seed: int):
    """Seeded BatchNorm running statistics (var in [1, ~2]) in place of the
    drawn ones, so eval-mode batch norm is no identity."""
    rng = _rng(seed)

    def fix(path, leaf):
        name = path[-1].key
        if name == "mean":
            return 0.3 * rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "var":
            return (1.0 + 0.5 * np.abs(rng.standard_normal(leaf.shape))).astype(np.float32)
        return leaf

    if "batch_stats" not in variables:
        return variables
    return dict(variables, batch_stats=jax.tree_util.tree_map_with_path(
        fix, variables["batch_stats"]))


@pytest.mark.parametrize("kind", ["sinusoidal", "sinusoidal_offset", "whisper", "none",
                                  "learnable"])
def test_positional_encodings_match_jax(kind):
    T, d = 17, 32
    x = _rng(1).standard_normal((2, T, d)).astype(np.float32)
    if kind == "learnable":
        jm = jconf.LearnablePositionalEncoding(max_len=24)
        params = U.random_params(jm.init, KEY, jnp.asarray(x))
        tm = tconf.LearnablePositionalEncoding(d, max_len=24)
        tm.load_state_dict({"pe": torch.from_numpy(np.asarray(params["params"]["pe"]))})
        for off in (0, 5):
            yj, ej = jm.apply(params, jnp.asarray(x), offset=off)
            with torch.no_grad():
                yt, et = tm(torch.from_numpy(x), offset=off)
            np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), **TOL)
            np.testing.assert_array_equal(et.detach().numpy(), np.asarray(ej))
        return
    want, got = {
        "sinusoidal": (lambda: jconf.sinusoidal_pos_emb(T, d), lambda: tconf.sinusoidal_pos_emb(T, d)),
        "sinusoidal_offset": (lambda: jconf.sinusoidal_pos_emb(T, d, 5),
                              lambda: tconf.sinusoidal_pos_emb(T, d, 5)),
        "whisper": (lambda: jconf.whisper_pos_emb(T, d), lambda: tconf.whisper_pos_emb(T, d)),
        "none": (lambda: jconf.no_pos_emb(T, d), lambda: tconf.no_pos_emb(T, d)),
    }[kind]
    w, g = np.asarray(want()), got()
    assert g.shape == w.shape == (1, T, d)
    np.testing.assert_allclose(g.numpy(), w, **TOL)


@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_moe_ffn_matches_jax(act):
    """Top-2 of 4 experts, softmax over the selected router logits."""
    E, K, D, H = 4, 2, 16, 24
    x = _rng(2).standard_normal((2, 5, D)).astype(np.float32)
    jm = jconf.MoEFFNLayer(E, K, H, D, act)
    params = U.random_params(jm.init, KEY, jnp.asarray(x), seed=2)
    tm = tconf.MoEFFNLayer(D, H, E, K, act)
    tm.load_state_dict(convert.moe_state_from_jax(params), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(params, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("rate", [1, 2, 4, 6, 8])
def test_subsampling_matches_jax(rate):
    """EmbedNoSubsampling (rate 1), Conv1dSubsampling2, Conv2dSubsampling4/
    6/8: outputs within 1e-5 and the subsampled masks equal."""
    idim, odim, T = 40, 24, 37
    rng = _rng(3)
    mask = np.ones((2, 1, T), bool)
    mask[1, :, 30:] = False
    if rate == 1:
        x = rng.integers(0, 50, (2, T))
        jm, tm = jconf.EmbedNoSubsampling(50, odim), tconf.EmbedNoSubsampling(50, odim)
    else:
        x = rng.standard_normal((2, T, idim)).astype(np.float32)
        jm = {2: lambda: jconf.Conv1dSubsampling2(odim), 4: lambda: jconf.Conv2dSubsampling4(odim),
              6: lambda: jconf.Conv2dSubsampling6(odim),
              8: lambda: jconf.Conv2dSubsampling8(odim)}[rate]()
        tm = (tconf.Conv1dSubsampling2(idim, odim) if rate == 2
              else tconf.Conv2dSubsampling(idim, odim, rate))
    params = U.random_params(jm.init, KEY, jnp.asarray(x), jnp.asarray(mask), seed=rate)
    if rate == 1:
        state = {"embed.weight": torch.from_numpy(np.asarray(params["params"]["embed"]["embedding"]))}
    else:
        state = convert.subsampling_state_from_jax(params, rate)
    tm.load_state_dict(state, strict=True)
    want, want_mask = jm.apply(params, jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        got, got_mask = tm(torch.from_numpy(x), torch.from_numpy(mask))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "centred"])
@pytest.mark.parametrize("norm", ["batch_norm", "layer_norm"])
def test_conv_module_matches_jax(norm, causal):
    """GLU -> depthwise (k 7) -> norm (batch norm from running statistics)
    -> swish -> pointwise, pad rows zeroed, on two ragged rows."""
    C, T = 16, 11
    rng = _rng(4)
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    pad = np.arange(T)[None] < np.array([[T], [7]])
    jm = jconf.ConvolutionModule(C, 7, causal, norm)
    variables = _with_stats(U.random_params(jm.init, KEY, jnp.asarray(x), jnp.asarray(pad),
                                            seed=5), 6)
    tm = tconf.ConvolutionModule(C, 7, causal, norm)
    tm.load_state_dict(convert.conv_module_state_from_jax(variables, norm == "batch_norm"),
                       strict=True)
    want = jm.apply(variables, jnp.asarray(x), jnp.asarray(pad))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x), torch.from_numpy(pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


ENC_OPTS = dict(dim=32, heads=4, linear_units=40, num_blocks=2, input_size=24,
                macaron_style=True, use_cnn_module=True, cnn_module_kernel=5,
                ffn_type="moe", n_expert=3, n_expert_per_token=2)


@pytest.mark.parametrize("path", ["forward", "prefill_decode"])
def test_encoder_with_macaron_conv_and_moe_matches_jax(path):
    """ConformerEncoder with every option: the masked full forward (valid
    rows), or a 6-row prefill then 3 one-row decode steps over the KV
    cache (B = 1, the JAX package's decode: macaron FFN kept, conv module
    skipped)."""
    jcfg = jconf.ConformerConfig(**ENC_OPTS, dropout_rate=0.0, attention_dropout_rate=0.0)
    tcfg = tconf.ConformerConfig(**ENC_OPTS)
    rng = _rng(7)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    lens = np.array([9, 6])
    jm = jconf.ConformerEncoder(jcfg)
    variables = _with_stats(U.random_params(jm.init, KEY, jnp.asarray(x), jnp.asarray(lens),
                                            seed=8), 9)
    tm = tconf.ConformerEncoder(tcfg)
    tm.load_state_dict(convert.conformer_encoder_state_from_jax(variables, batch_norm=True),
                       strict=True)
    tm.eval()
    if path == "forward":
        want, _ = jm.apply(variables, jnp.asarray(x), jnp.asarray(lens))
        with torch.no_grad():
            got, valid = tm(torch.from_numpy(x), torch.from_numpy(lens))
        v = valid.numpy()
        np.testing.assert_allclose(got.numpy()[v], np.asarray(want)[v], **TOL)
        return
    xs = x[:1]
    jcache = jconf.ConformerKVCache.create(jcfg, 1, 16)
    wants, (jh, jcache) = [], jm.apply(variables, jnp.asarray(xs[:, :6]), jcache,
                                       method=jconf.ConformerEncoder.prefill)
    wants.append(np.asarray(jh))
    tcache = tconf.ConformerKVCache.create(tcfg, 1, 16)
    with torch.no_grad():
        th, tcache = tm.prefill(torch.from_numpy(xs[:, :6]), tcache)
        gots = [th.numpy()]
        for t in range(6, 9):
            jh, jcache = jm.apply(variables, jnp.asarray(xs[:, t:t + 1]), jcache,
                                  method=jconf.ConformerEncoder.decode_step)
            wants.append(np.asarray(jh))
            th, tcache = tm.decode_step(torch.from_numpy(xs[:, t:t + 1]), tcache)
            gots.append(th.numpy())
    for g, w in zip(gots, wants):
        np.testing.assert_allclose(g, w, **TOL)


def test_chunk_refuses_macaron_and_conv():
    layer = tconf.ConformerEncoderLayer(tconf.ConformerConfig(**ENC_OPTS))
    z = torch.zeros(1, 2, 32)
    with pytest.raises(AssertionError):
        layer.chunk(z, torch.zeros(1, 4, 4, 8), torch.zeros(1, 4, 4, 8), torch.tensor([0]),
                    torch.zeros(1, 2, 4))


@pytest.mark.parametrize("kind", ["uni", "uni_no_src", "bi"])
def test_transformer_decoders_match_jax(kind):
    """TransformerDecoder (with and without cross-attention) and the
    bidirectional decoder (both directions), ragged target and memory
    lengths: logits within 1e-5 over the valid target rows; a reference-
    named state dict reads back by name."""
    V, D, H, L, U_ = 30, 16, 2, 2, 24
    rng = _rng(10)
    B, Tm, To = 2, 7, 5
    memory = rng.standard_normal((B, Tm, D)).astype(np.float32)
    mlens, ys, ylens = np.array([7, 4]), rng.integers(0, V, (B, To)), np.array([5, 3])
    r_ys = rng.integers(0, V, (B, To))
    args = (memory, mlens, ys, ylens)
    if kind == "bi":
        jm = jdec.BiTransformerDecoder(V, D, H, U_, L, r_num_blocks=1)
        tm = tdec.BiTransformerDecoder(V, D, H, U_, L, r_num_blocks=1)
        params = U.random_params(jm.init, KEY, *map(jnp.asarray, args), jnp.asarray(r_ys),
                                 seed=11, reverse_weight=0.5)
        state = convert.bi_transformer_decoder_state_from_jax(params)
        want = jm.apply(params, *map(jnp.asarray, args), jnp.asarray(r_ys), 0.5)
    else:
        src = kind == "uni"
        jm = jdec.TransformerDecoder(V, D, H, U_, L, src_attention=src)
        tm = tdec.TransformerDecoder(V, D, H, U_, L, src_attention=src)
        params = U.random_params(jm.init, KEY, *map(jnp.asarray, args), seed=12)
        state = convert.transformer_decoder_state_from_jax(params)
        want = (jm.apply(params, *map(jnp.asarray, args)),)
    tm.load_state_dict(state, strict=True)
    fresh = type(tm)(V, D, H, U_, L, r_num_blocks=1) if kind == "bi" else type(tm)(
        V, D, H, U_, L, src_attention=kind == "uni")
    tdec.load_transformer_decoder(fresh, {"decoder." + k: v for k, v in state.items()},
                                  prefix="decoder.")
    with torch.no_grad():
        t_args = tuple(torch.as_tensor(a) for a in args)
        got = (tm(*t_args, torch.as_tensor(r_ys), 0.5) if kind == "bi" else (tm(*t_args),))
        again = (fresh(*t_args, torch.as_tensor(r_ys), 0.5) if kind == "bi"
                 else (fresh(*t_args),))
    for g, a, w in zip(got, again, want):
        for b, n in enumerate(ylens):
            np.testing.assert_allclose(g[b, :n].numpy(), np.asarray(w)[b, :n], **TOL)
        np.testing.assert_array_equal(a.numpy(), g.numpy())
