"""The port's LAM speaker embedding, its speaker-co-trained v1 phoneme LM and
the extract_speaker_vec CLI against the JAX package on the CPU, at a small
size (a 24-d CAMPPlus of tests/torch_port_util.py's CAMP, 16-wide posterior
and style encoders of 2 layers, 32 style tokens a GST layer, a 20-d vector).
One seeded reference-named state dict goes into the port (strictly) and
through the JAX package's import_speaker_embedding_torch.  Bars (fp32): the
style encoder on ragged rows and the GST 2e-5; SpeakerEmbedding and
SpeakerEmbeddingWoPostEnc on ragged spectra, the posterior sample on the
JAX package's own draw, and speaker_embed from a 24 kHz wav, 1e-4;
TransformerLMPhonemeWithSpk's greedy tokens from the features exact; the
state dict back from convert.speaker_embedding_state_from_jax exact; each
.npy of the CLI equal to speaker_embed of its wav."""
import functools
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_util as U
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)
from cosyvoice_tpu.models import campplus as jcamp
from cosyvoice_tpu.models import llm as jllm
from cosyvoice_tpu.models import llm_phoneme as jpho
from cosyvoice_tpu.models import llm_v1_phoneme as jv1
from cosyvoice_tpu.models import speaker as jspk
from cosyvoice_tpu.models import vits as jv
from cosyvoice_tpu.ops import kaldi as jkaldi
from cosyvoice_tpu.runtime import frontend as jfront
from cosyvoice_tpu.models.conformer import ConformerConfig as JConformerConfig
from cosyvoice_tpu_torch import convert
from cosyvoice_tpu_torch.bin import extract_speaker_vec
from cosyvoice_tpu_torch.bin.inference import write_wav
from cosyvoice_tpu_torch.models import campplus as tcamp
from cosyvoice_tpu_torch.models import llm as tllm
from cosyvoice_tpu_torch.models import llm_phoneme as tpho
from cosyvoice_tpu_torch.models import llm_v1_phoneme as tv1
from cosyvoice_tpu_torch.models import speaker as tspk
from cosyvoice_tpu_torch.models.conformer import ConformerConfig as TConformerConfig
from cosyvoice_tpu_torch.utils.checkpoint import load_by_name

# a 64-point, hop-48 spectrum (33 bins) of 24 kHz audio
SMALL = dict(spec_channels=33, inter_channels=16, hidden_channels=16, speaker_emb_dim=20,
             hop_length=48, filter_length=64, style_hidden=16, style_heads=4, style_kernel=5,
             style_layers=2, gst_tokens=32, gst_heads=4, gst_layers=2)


def _cfgs():
    return (jspk.SpeakerEmbeddingConfig(**SMALL, campplus=jcamp.CAMPPlusConfig(**U.CAMP)),
            tspk.SpeakerEmbeddingConfig(**SMALL, campplus=tcamp.CAMPPlusConfig(**U.CAMP)))


def _ref_state(model, seed: int) -> dict:
    """Seeded reference-named weights; CAMPPlus's from U.seeded_campplus (BN
    statistics that keep its eval-mode BatchNorms away from the identity)."""
    ref = U.seeded_state(model, seed)
    camp = U.seeded_campplus(seed).state_dict()
    ref.update((f"speaker_encoder.{k}", v) for k, v in camp.items())
    return ref


def _import(ref: dict):
    return jspk.import_speaker_embedding_torch({k: v.numpy() for k, v in ref.items()},
                                               _cfgs()[0])


@lru_cache(maxsize=None)
def _speaker():
    """-> (JAX variables, port SpeakerEmbedding, the reference-named state)."""
    tm = tspk.SpeakerEmbedding(_cfgs()[1])
    ref = _ref_state(tm, 40)
    tm.load_state_dict(ref, strict=True)
    return _import(ref), tm.eval(), ref


@lru_cache(maxsize=None)
def _speaker_wo_post_enc():
    """The variant's JAX variables come through the importer, which reads the
    posterior encoder's names too: they are given a SpeakerEmbedding's and
    dropped from the tree after."""
    tm = tspk.SpeakerEmbeddingWoPostEnc(_cfgs()[1])
    ref = _ref_state(tm, 41)
    tm.load_state_dict(ref, strict=True)
    full = dict(_speaker()[2], **ref)
    variables = _import(full)
    variables["params"] = {k: v for k, v in variables["params"].items()
                           if not k.startswith("enc_q_")}
    return variables, tm.eval(), ref


def _features(rng, B=2, Tf=60, Ts=23, lens=(23, 15)):
    fb = rng.standard_normal((B, Tf, 80)).astype(np.float32)
    spec = np.abs(rng.standard_normal((B, Ts, SMALL["spec_channels"]))).astype(np.float32)
    return fb, spec, np.asarray(lens)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor)
                                          else got), np.asarray(want), atol=tol, rtol=0,
                               err_msg=msg)


def test_style_encoder_ragged():
    variables, tm, _ = _speaker()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 14, 16)).astype(np.float32)
    valid = np.arange(14)[None] < np.array([14, 10, 1])[:, None]
    jm = jspk.StyleEncoderV2(hidden=16, out_dim=20, kernel_size=5, heads=4, num_layers=2)
    want = jm.apply({"params": variables["params"]["style_encoder"]}, jnp.asarray(x),
                    jnp.asarray(valid))
    got = tm.style_encoder(torch.from_numpy(x), torch.from_numpy(valid))
    _close(got, want, 2e-5)


def test_global_style_tokens():
    variables, tm, _ = _speaker()
    x = np.random.default_rng(2).standard_normal((3, 20)).astype(np.float32)
    jm = jspk.GlobalStyleTokensV2(token_num=32, embed_dim=20, num_heads=4, num_layers=2)
    want = jm.apply({"params": variables["params"]["gst"]}, jnp.asarray(x))
    got = tm.gst(torch.from_numpy(x))
    assert got.shape == want.shape == (3, 1, 20)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("variant", ["post_enc", "wo_post_enc"])
def test_speaker_embedding_pinned_noise(variant):
    """The whole stack on two ragged spectra; with the posterior encoder the
    port is given the JAX package's draw (jax.random.normal of m's shape)."""
    variables, tm, _ = _speaker() if variant == "post_enc" else _speaker_wo_post_enc()
    jm = (jspk.SpeakerEmbedding if variant == "post_enc"
          else jspk.SpeakerEmbeddingWoPostEnc)(_cfgs()[0])
    fb, spec, lens = _features(np.random.default_rng(3))
    key = jax.random.PRNGKey(5)
    want = jax.jit(jm.apply)(variables, jnp.asarray(fb), jnp.asarray(spec), jnp.asarray(lens),
                             key)
    noise = np.array(jax.random.normal(key, (2, spec.shape[1], 16)))
    got = tm(torch.from_numpy(fb), torch.from_numpy(spec), torch.from_numpy(lens),
             noise=torch.from_numpy(noise) if variant == "post_enc" else None)
    assert got.shape == want.shape == (2, 20)
    _close(got, want, 1e-4)
    assert np.abs(np.asarray(want)).max() > 1e-2


def test_speaker_embed_from_wav():
    """24 kHz wav -> resample_poly -> kaldi fbank (mean removed) + the linear
    spectrum -> the vector, against the JAX package's speaker_embed."""
    variables, tm, _ = _speaker()
    wav = U.prompt_wav(0.75, seed=4)                    # read as 24 kHz audio
    key = jax.random.PRNGKey(6)
    # the JAX package's speaker_embed, its model call jitted
    wav16 = jfront.resample_poly(wav, 24000, 16000)
    fb = jkaldi.kaldi_fbank(jnp.asarray(wav16))
    fb = fb - fb.mean(axis=0, keepdims=True)
    spec = jv.linear_spectrogram(jnp.asarray(wav)[None], 64, 48, 64)
    want = jax.jit(jspk.SpeakerEmbedding(_cfgs()[0]).apply)(
        variables, fb[None], spec, jnp.asarray([spec.shape[1]]), key)[0]
    noise = np.array(jax.random.normal(key, (1, spec.shape[1], 16)))
    got = tspk.speaker_embed(tm, wav, noise=torch.from_numpy(noise))
    assert got.shape == want.shape == (20,)
    _close(got, want, 1e-4)


def test_reference_state_dict_both_ways():
    """A seeded state dict under the reference checkpoint's names: the JAX
    package's import_speaker_embedding_torch, then
    convert.speaker_embedding_state_from_jax, gives it back exactly
    (BatchNorm counters 0), and load_by_name reads it into the port."""
    for variables, tm, ref in (_speaker(), _speaker_wo_post_enc()):
        back = convert.speaker_embedding_state_from_jax(variables)
        assert sorted(back) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(back[k].numpy(), ref[k].numpy(), err_msg=k)
        model = type(tm)(_cfgs()[1])
        load_by_name(model, ref, "speaker.pt")
        for k, v in model.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_array_equal(v.numpy(), ref[k].numpy(), err_msg=k)


def test_with_spk_greedy_tokens_match_jax():
    """TransformerLMPhonemeWithSpk: encode_speaker from fbank and spectrum
    features (the JAX draw pinned), then v1_phoneme_generate on its LM
    (spk_adapt on, so the vector also reaches the text encoder): tokens
    exact; the weights through convert.with_spk_state_from_jax."""
    pho = dict(text_token_size=30, text_token_dim=12, text_tone_size=16, text_tone_dim=8,
               text_lang_size=2, text_lang_dim=2, text_prsd_size=6, text_prsd_dim=2)
    te = dict(dim=32, heads=4, linear_units=48, num_blocks=1, input_size=24,
              static_chunk_size=1)
    body = dict(dim=32, heads=4, linear_units=48, num_blocks=1, input_size=32,
                static_chunk_size=1, input_layer="linear_legacy", activation="relu")
    jenc = lambda **kw: JConformerConfig(**kw, dropout_rate=0.0, attention_dropout_rate=0.0)
    common = dict(text_encoder_input_size=24, llm_input_size=32, llm_output_size=32,
                  text_token_size=300, speech_token_size=U.SPEECH_VOCAB, spk_embed_dim=20,
                  spk_adapt=True)
    jlm = jv1.V1PhonemeLMConfig(**common, sampling=jllm.SamplingConfig(method="greedy"),
                                text_encoder=jenc(**te), llm=jenc(**body),
                                phoneme=jpho.PhonemeEmbedConfig(**pho))
    jm = jv1.TransformerLMPhonemeWithSpk(jv1.WithSpkConfig(lm=jlm, spk=_cfgs()[0]))
    lm_params = U.random_params(jv1.TransformerLMPhoneme(jlm).init, U.KEY,
                                jnp.zeros((1, 4, 4), jnp.int32), jnp.asarray([4]),
                                jnp.zeros((1, 3), jnp.int32), jnp.asarray([3]),
                                jnp.zeros((1, 20)), seed=7)
    spk = _speaker()[0]
    variables = {"params": {"lm": lm_params["params"], "speaker_embed": spk["params"]},
                 "batch_stats": {"speaker_embed": spk["batch_stats"]}}
    tm = tv1.TransformerLMPhonemeWithSpk(tv1.WithSpkConfig(
        lm=tv1.V1PhonemeLMConfig(**common, sampling=tllm.SamplingConfig(method="greedy"),
                                 text_encoder=TConformerConfig(**te),
                                 llm=TConformerConfig(**body),
                                 phoneme=tpho.PhonemeEmbedConfig(**pho)),
        spk=_cfgs()[1]))
    tm.load_state_dict(convert.with_spk_state_from_jax(variables), strict=True)
    tm.eval()

    rng = np.random.default_rng(8)
    fb, spec, lens = _features(rng, B=1, lens=(23,))
    pho_tok = np.stack([rng.integers(0, pho[f"text_{t}_size"], 9)
                        for t in ("token", "tone", "lang", "prsd")], axis=-1)[None]
    psp = rng.integers(0, U.SPEECH_VOCAB, (1, 5))
    key = jax.random.PRNGKey(9)
    emb_j = jax.jit(functools.partial(jm.apply, method=jv1.TransformerLMPhonemeWithSpk
                                      .encode_speaker))(
        variables, jnp.asarray(fb), jnp.asarray(spec), jnp.asarray(lens), key)
    noise = np.array(jax.random.normal(key, (1, spec.shape[1], 16)))
    emb_t = tm.encode_speaker(torch.from_numpy(fb), torch.from_numpy(spec),
                              torch.from_numpy(lens), noise=torch.from_numpy(noise))
    _close(emb_t, emb_j, 1e-4)
    max_steps, cache_len = 30, 64
    out, count = jv1.v1_phoneme_generate(
        jv1.TransformerLMPhoneme(jlm), lm_params, jnp.asarray(pho_tok), jnp.asarray([9]),
        jnp.asarray(psp), jnp.asarray([5]), emb_j, jnp.asarray([0]),
        jnp.asarray([max_steps]), U.KEY, max_steps=max_steps, cache_len=cache_len)
    got, n = tv1.v1_phoneme_generate(
        tm.lm, torch.from_numpy(pho_tok), torch.tensor([9]), torch.from_numpy(psp),
        torch.tensor([5]), emb_t, torch.tensor([max_steps]), None, max_steps, cache_len)
    want = np.asarray(out[0, :int(count[0])])
    assert len(want) > 0
    np.testing.assert_array_equal(got[0, :int(n[0])].numpy(), want)


def test_extract_speaker_vec_cli(tmp_path, monkeypatch):
    """A seeded reference-named .pt and a two-line wav.scp: main() writes one
    .npy a line, each equal to speaker_embed of its wav with the generator
    seeded 0 the CLI uses; without --ckpt it refuses to run."""
    _, tm, ref = _speaker()
    ckpt = tmp_path / "speaker.pt"
    torch.save(ref, ckpt)
    wavs = {"utt_a": U.prompt_wav(0.5, seed=1), "utt_b": U.prompt_wav(0.8, seed=2)}
    scp = tmp_path / "wav.scp"
    lines = []
    for utt, wav in wavs.items():
        write_wav(str(tmp_path / f"{utt}.wav"), wav, 24000)
        lines.append(f"{utt} {tmp_path / f'{utt}.wav'}")
    scp.write_text("\n".join(lines) + "\n")
    monkeypatch.setattr(tspk, "load_speaker_embedding",
                        functools.partial(tspk.load_speaker_embedding, _cfgs()[1]))
    out = tmp_path / "vecs"
    extract_speaker_vec.main(["--wav_scp", str(scp), "--out_dir", str(out), "--ckpt",
                              str(ckpt), "--device", "cpu"])
    for utt in wavs:
        from cosyvoice_tpu_torch.bin.inference import read_wav

        wav, _ = read_wav(str(tmp_path / f"{utt}.wav"))
        want = tspk.speaker_embed(tm, wav, gen=torch.Generator().manual_seed(0))
        got = np.load(out / f"{utt}.npy")
        assert got.shape == (20,)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(SystemExit, match="--ckpt required"):
        extract_speaker_vec.main(["--wav_scp", str(scp), "--out_dir", str(out)])
