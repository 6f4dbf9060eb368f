"""The port's model-directory readers and frontend models against the JAX
package's, on the CPU: the ONNX reader and writer, kaldi fbank, the whisper
log-mel, CAMPPlus and the S3 speech tokenizer through their ONNX importers,
the Qwen BPE tokenizer against `transformers` (the JAX QwenTokenizer) in
both `tokenizer.json` forms, and the frontend's `text_normalizer`."""
import random
import struct
import sys
import unicodedata

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_port_util as U
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)
from cosyvoice_tpu.models import campplus as jcamp
from cosyvoice_tpu.models import s3tokenizer as js3
from cosyvoice_tpu.ops.kaldi import kaldi_fbank as j_fbank
from cosyvoice_tpu.utils import onnx_io as jonnx
from cosyvoice_tpu_torch.models import campplus as tcamp
from cosyvoice_tpu_torch.models import s3tokenizer as ts3
from cosyvoice_tpu_torch.ops.kaldi import kaldi_fbank as t_fbank
from cosyvoice_tpu_torch.ops.mel import mel_filterbank
from cosyvoice_tpu_torch.utils import onnx_io as tonnx

# ---- onnx_io ------------------------------------------------------------

def test_onnx_round_trip_every_dtype(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {f"t.{np.dtype(dt).name}": (rng.standard_normal((2, 3)) * 50).astype(dt)
               for dt in tonnx._DTYPE_CODES}
    tensors["scalar"] = np.float32(3.5).reshape(())
    path = str(tmp_path / "rt.onnx")
    tonnx.write_onnx_tensors(path, tensors)
    back = tonnx.read_onnx_tensors(path)
    assert set(back) == set(tensors)
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_onnx_readers_agree_on_every_field(tmp_path):
    """One file holding raw_data, the typed *_data fields (packed and not,
    negative varints, float16 bit patterns in int32_data) and a Constant
    node's tensor: the port's reader and the JAX package's give the same
    arrays; external data raises in both."""
    f, v = tonnx._field, tonnx._varint
    neg = lambda x: v(x & ((1 << 64) - 1))  # noqa: E731

    def tensor(name, dtype, dims, body):
        return (b"".join(f(1, 0, v(d)) for d in dims) + f(2, 0, v(dtype))
                + f(8, 2, name.encode()) + body)
    inits = [
        tonnx._encode_tensor("raw.f32", np.arange(6, dtype=np.float32).reshape(2, 3)),
        tensor("packed.f32", 1, (3,), f(4, 2, struct.pack("<3f", 0.5, -1.0, 2.25))),
        tensor("unpacked.f32", 1, (2,), f(4, 5, struct.pack("<f", 1.5))
               + f(4, 5, struct.pack("<f", -3.0))),
        tensor("i64", 7, (3,), f(7, 2, neg(-7) + v(42) + neg(-1))),
        tensor("i8", 3, (3,), f(5, 2, neg(-3) + v(0) + v(7))),
        tensor("f16", 10, (1,), f(5, 0, v(int(np.float16(1.5).view(np.uint16))))),
        tensor("f64", 11, (2,), f(10, 2, struct.pack("<2d", 0.1, -2.0))),
        tensor("u64", 13, (2,), f(11, 2, v(5) + v(1 << 40))),
    ]
    const = tonnx._encode_tensor("", np.arange(4, dtype=np.int32))
    node = (f(4, 2, b"Constant") + f(6, 2, b"folded.weight")
            + f(5, 2, f(1, 2, b"value") + f(4, 2, const)))
    graph = f(2, 2, b"g") + f(1, 2, node) + b"".join(f(5, 2, t) for t in inits)
    path = tmp_path / "fields.onnx"
    path.write_bytes(f(1, 0, v(8)) + f(7, 2, graph))
    ours, theirs = tonnx.read_onnx_tensors(str(path)), jonnx.read_onnx_tensors(str(path))
    assert set(ours) == set(theirs) and len(ours) == len(inits) + 1
    for k in theirs:
        assert ours[k].dtype == theirs[k].dtype and ours[k].shape == theirs[k].shape, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    np.testing.assert_array_equal(ours["i64"], [-7, 42, -1])
    np.testing.assert_array_equal(ours["folded.weight"], np.arange(4))
    external = tensor("ext", 1, (1,), f(14, 0, v(1)))
    path.write_bytes(f(1, 0, v(8)) + f(7, 2, f(5, 2, external)))
    for reader in (tonnx.read_onnx_tensors, jonnx.read_onnx_tensors):
        with pytest.raises(NotImplementedError, match="external data"):
            reader(str(path))


def test_npz_io_matches_jax(tmp_path):
    """Each package reads the other's .npz parameter trees to equal arrays."""
    from cosyvoice_tpu.utils import npz_io as jnpz
    from cosyvoice_tpu_torch.utils import npz_io as tnpz

    rng = np.random.default_rng(0)
    tree = {"params": {"layers_0": {"kernel": rng.standard_normal((3, 4)).astype(np.float32),
                                    "bias": np.arange(4, dtype=np.float32)},
                       "embed": {"embedding": rng.standard_normal((5, 2))}},
            "spk": {"embedding": np.ones(3, np.int32)}}
    tnpz.save_params_npz(str(tmp_path / "t.npz"), tree)
    jnpz.save_params_npz(str(tmp_path / "j.npz"), tree)
    assert tnpz.flatten_params(tree).keys() == jnpz.flatten_params(tree).keys()
    for a, b in ((tnpz.load_params_npz(str(tmp_path / "j.npz")),
                  jnpz.load_params_npz(str(tmp_path / "t.npz"))),
                 (tnpz.load_params_npz(str(tmp_path / "t.npz")), tree)):
        flat_a, flat_b = tnpz.flatten_params(a), tnpz.flatten_params(b)
        assert flat_a.keys() == flat_b.keys()
        for k in flat_a:
            assert flat_a[k].dtype == flat_b[k].dtype
            np.testing.assert_array_equal(flat_a[k], flat_b[k], err_msg=k)


def test_read_wav_16k_matches_jax(tmp_path):
    """A 24 kHz stereo WAV read, downmixed and resampled to 16 kHz as the
    JAX package does it; a 16 kHz file passes through."""
    import wave

    from cosyvoice_tpu.utils.audio import read_wav_16k as jread
    from cosyvoice_tpu_torch.utils.audio import read_wav_16k as tread

    pcm = (np.random.default_rng(0).standard_normal((2400, 2)) * 3000).astype("<i2")
    for sr, data in ((24000, pcm), (16000, pcm[:, :1])):
        path = str(tmp_path / f"{sr}.wav")
        with wave.open(path, "wb") as w:
            w.setnchannels(data.shape[1])
            w.setsampwidth(2)
            w.setframerate(sr)
            w.writeframes(data.tobytes())
        ours, theirs = tread(path), jread(path)
        assert ours.dtype == theirs.dtype == np.float32 and ours.shape == theirs.shape
        assert len(ours) == len(data) * 16000 // sr
        np.testing.assert_array_equal(ours, theirs)


# ---- kaldi fbank and the whisper mel -------------------------------------

def test_kaldi_fbank_matches_jax_and_golden():
    """Within the bar the JAX package's own fbank is held to against the
    golden (tests/test_speaker.py: atol 2e-4, rtol 1e-5)."""
    import os

    data = np.load(os.path.join(os.path.dirname(__file__), "data", "fbank_golden.npz"))
    for wav, golden in ((data["wav"], data["fbank"]), (U.prompt_wav(2.3), None)):
        ours = t_fbank(torch.from_numpy(wav)).numpy()
        theirs = np.asarray(j_fbank(jnp.asarray(wav)))
        assert ours.shape == theirs.shape == ((len(wav) - 400) // 160 + 1, 80)
        np.testing.assert_allclose(ours, theirs, atol=2e-4, rtol=1e-5)
        if golden is not None:
            np.testing.assert_allclose(ours, golden, atol=2e-4, rtol=1e-5)


def whisper_mel_f64(wav: np.ndarray) -> np.ndarray:
    """whisper_log_mel in float64 numpy (np.fft), written from its definition."""
    y = np.pad(wav.astype(np.float64), 200, mode="reflect")
    win = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(400) / 400)
    frames = np.stack([y[i * 160: i * 160 + 400] for i in range(1 + (len(y) - 400) // 160)])
    power = np.abs(np.fft.rfft(frames * win, axis=-1)[:-1]) ** 2
    mel = power @ mel_filterbank(16000, 400, 128, 0.0, 8000.0).astype(np.float64).T
    logspec = np.log10(np.maximum(mel, 1e-10))
    return (np.maximum(logspec, logspec.max() - 8.0) + 4.0) / 4.0


@pytest.mark.parametrize("signal", ["tones", "noise"])
def test_whisper_log_mel_matches_jax(signal):
    """The port sums the spectrum in float64 and sits within 1e-6 of the
    exact function; the JAX package's float32 DFT sums put its own result up
    to ~2.5e-5 from it on a pure tone, so the port is held to JAX at 1e-5
    plus the JAX result's own distance from the exact one."""
    wav = U.prompt_wav(2.3) if signal == "tones" else \
        (0.1 * np.random.default_rng(1).standard_normal(36800)).astype(np.float32)
    ours = ts3.whisper_log_mel(torch.from_numpy(wav)).numpy()
    theirs = np.asarray(js3.whisper_log_mel(jnp.asarray(wav)))
    exact = whisper_mel_f64(wav)
    assert ours.shape == theirs.shape == (len(wav) // 160, 128)
    np.testing.assert_allclose(ours, exact, atol=1e-6)
    assert np.all(np.abs(ours - theirs) <= 1e-5 + np.abs(theirs - exact))


# ---- CAMPPlus --------------------------------------------------------------

def test_campplus_onnx_matches_jax(tmp_path):
    """The port's and the JAX package's importers read the same file; the
    speaker vectors of a 0.4 s and a 2.3 s prompt (the second ends in a
    partial 100-frame CAM segment) agree within 5e-4 / rtol 1e-3."""
    path = str(tmp_path / "campplus.onnx")
    U.write_campplus_onnx(path, U.seeded_campplus())
    ours = tcamp.import_campplus_onnx(path, tcamp.CAMPPlusConfig(**U.CAMP), device="cpu")
    jcfg = jcamp.CAMPPlusConfig(**U.CAMP)
    theirs = jcamp.make_campplus_frontend_fn(jcamp.CAMPPlus(jcfg),
                                             jcamp.import_campplus_onnx(path, jcfg))
    ours_fn = tcamp.make_campplus_frontend_fn(ours)
    for seconds in (0.4, 2.3):
        wav = U.prompt_wav(seconds)
        a, b = ours_fn(wav), theirs(wav)
        assert a.shape == b.shape == (24,) and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, atol=5e-4, rtol=1e-3)


def test_campplus_import_needs_every_weight(tmp_path):
    model = U.seeded_campplus()
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    del sd["xvector.block2.tdnnd3.cam_layer.linear1.bias"]
    path = str(tmp_path / "partial.onnx")
    tonnx.write_onnx_tensors(path, sd)
    with pytest.raises(KeyError, match="cam_layer.linear1.bias"):
        tcamp.import_campplus_onnx(path, tcamp.CAMPPlusConfig(**U.CAMP), device="cpu")


# ---- S3 speech tokenizer -----------------------------------------------------

def jax_s3_variables():
    model = js3.S3TokenizerV2(js3.S3Config(**U.S3))
    return U.random_params(model.init, U.KEY, jnp.zeros((1, 20, 128)), jnp.asarray([20]),
                           seed=5)


def test_s3_tokens_match_jax(tmp_path):
    """A 2.3 s chirp (padded to a 4 s bucket) through both packages'
    make_s3_frontend_fn, from one speech_tokenizer_v2.onnx: the FSQ inputs
    (tanh(project_in(x)) + 1, before rounding) within 1e-4, and the ids
    equal wherever the FSQ input of every digit lies farther than 1e-4 from
    a rounding boundary (x.5); where one lies closer, the two packages may
    round it apart."""
    variables = jax_s3_variables()
    path = str(tmp_path / "speech_tokenizer_v2.onnx")
    tonnx.write_onnx_tensors(path, js3.s3tokenizer_state_dict(variables, js3.S3Config(**U.S3)))
    ours = ts3.import_s3tokenizer_onnx(path, ts3.S3Config(**U.S3), device="cpu")
    jmodel = js3.S3TokenizerV2(js3.S3Config(**U.S3))
    jvars = js3.import_s3tokenizer_onnx(path, js3.S3Config(**U.S3))
    t = np.arange(36800) / 16000.0               # a 2.3 s chirp, 100 Hz -> 4 kHz
    wav = (0.3 * np.sin(2 * np.pi * (100 * t + 850 * t * t))).astype(np.float32)
    tok_t = ts3.make_s3_frontend_fn(ours)(wav)
    tok_j = js3.make_s3_frontend_fn(jmodel, jvars)(wav)
    assert tok_t.shape == tok_j.shape == (len(wav) // 160 // 4,)
    assert len(np.unique(tok_j)) > 3

    # the FSQ inputs of both, on the frontend's padded and zeroed mel
    pad = np.pad(wav, (0, 64000 - len(wav)))
    mel = js3.whisper_log_mel(jnp.asarray(pad))
    mel = jnp.where(jnp.arange(mel.shape[0])[:, None] < len(wav) // 160, mel, 0.0)
    _, state = jmodel.apply(jvars, mel[None], jnp.asarray([len(wav) // 160]),
                            capture_intermediates=True)
    h_j = np.asarray(state["intermediates"]["quantizer"]["project_in"]["__call__"][0])[0]
    seen = []
    hook = ours.quantizer.project_in.register_forward_hook(lambda m, i, o: seen.append(o))
    ts3.make_s3_frontend_fn(ours)(wav)
    hook.remove()
    n = len(tok_j)
    fsq_j = np.tanh(h_j[:n]) + 1.0
    fsq_t = np.tanh(seen[0][0, :n].numpy()) + 1.0
    np.testing.assert_allclose(fsq_t, fsq_j, atol=1e-4)
    near = np.abs(fsq_j - np.floor(fsq_j) - 0.5) < 1e-4
    differ = tok_t != tok_j
    assert not np.any(differ & ~near.any(axis=-1)), np.nonzero(differ)[0]


def test_s3_importer_takes_the_released_name_variants(tmp_path):
    """Bare (unprefixed) names, the FSQ projection as `project_down` and an
    unread `positional_embedding` load to the same weights; the port's
    s3tokenizer_state_dict writes the whisper names back."""
    model = ts3.S3TokenizerV2(ts3.S3Config(**U.S3))
    sd = ts3.s3tokenizer_state_dict(model)
    assert "encoder.blocks.1.attn.key.weight" in sd and "encoder.blocks.1.attn.key.bias" not in sd
    variant = {k.removeprefix("encoder.").replace("project_in", "project_down"): v
               for k, v in sd.items()}
    variant["positional_embedding"] = np.zeros((10, 64), np.float32)
    path = str(tmp_path / "variant.onnx")
    tonnx.write_onnx_tensors(path, variant)
    back = ts3.s3tokenizer_state_dict(ts3.import_s3tokenizer_onnx(path, model.cfg, "cpu"))
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    del variant["blocks.0.mlp.2.bias"]
    tonnx.write_onnx_tensors(path, variant)
    with pytest.raises(KeyError, match="mlp.2.bias"):
        ts3.import_s3tokenizer_onnx(path, model.cfg, "cpu")


# ---- the Qwen BPE tokenizer ---------------------------------------------------

STRINGS = ["hello world", "Hello World!", "你好，世界 hello", "café naïve", "é (combining)",
           "12345 3.14159 ½ Ⅻ ²", "I'm you're THEY'VE we'll IT'S don't 'ſ", "a  b   c    d",
           "line1\nline2\n\n\nline3\r\n", "\t tab  \t mix \n ", "   ", "", "\n",
           "<|endofprompt|>hello[breath] world<|endoftext|>", "x<|endofprompt|>y[mn]",
           "emoji 😀👍🏽!!", "mixed中文English123混合", "x y z　w", "a\u001cb", "...???!!!",
           " !x", " \n x", "'''s", "end with space ", "a\r\rb", "hello  \n  world"]


def fuzz_strings(n: int = 200) -> list:
    rng = random.Random(0)
    pool = "aAbZ éü中文😀 \t\n\r'.,!?0123456789½Ⅻ　[]<>|-_sS"
    return ["".join(rng.choice(pool) for _ in range(rng.randint(1, 30))) for _ in range(n)]


@pytest.mark.parametrize("form", ["gpt2", "qwen2"])
def test_qwen_tokenizer_ids_equal_transformers(form, tmp_path):
    """Ids exactly those of the JAX QwenTokenizer (transformers.AutoTokenizer
    plus the CosyVoice2 specials), and decode equal to its decode."""
    from cosyvoice_tpu.tokenizer.text import QwenTokenizer as JQwen
    from cosyvoice_tpu_torch.tokenizer.text import QwenTokenizer as TQwen

    d = U.tokenizer_dir(tmp_path / form, form)
    ours, theirs = TQwen(d), JQwen(d)
    specials = ["<|endofprompt|>", "[breath]", "[mn]", "<|im_end|>"]
    assert [ours.encode(s) for s in specials] == [theirs.encode(s) for s in specials]
    for s in STRINGS + fuzz_strings():
        ids = ours.encode(s)
        assert ids == theirs.encode(s), repr(s)
        assert ours.decode(ids) == theirs.decode(ids), repr(s)
    for s in STRINGS + fuzz_strings():               # text without specials round-trips
        if not any(t in s for t in ours.added):
            want = unicodedata.normalize("NFC", s) if form == "qwen2" else s
            assert ours.decode(ours.encode(s)) == want, repr(s)


def test_hand_built_tokenizer_json_matches_transformers(tmp_path):
    """The byte-level tokenizer.json chip_smoke.py writes for its model
    directories (no `tokenizers` on the card) loads in `transformers` and
    gives the port's ids."""
    import chip_smoke
    from cosyvoice_tpu.tokenizer.text import QwenTokenizer as JQwen
    from cosyvoice_tpu_torch.tokenizer.text import QwenTokenizer as TQwen

    d = str(tmp_path / "tok")
    chip_smoke.write_tokenizer_json(d)
    ours, theirs = TQwen(d), JQwen(d)
    for s in STRINGS + ["The quick brown fox jumps over the lazy dog.", "A short prompt."]:
        assert ours.encode(s) == theirs.encode(s), repr(s)
    assert len(ours.encode("the other")) < len("the other")     # the merges apply


def test_qwen_tokenizer_needs_no_hf_packages(tmp_path, monkeypatch):
    """With `transformers` and `tokenizers` unimportable, the port's
    tokenizer loads and encodes (ids computed beforehand with them present)."""
    import importlib

    d = U.tokenizer_dir(tmp_path / "tok", "qwen2")
    from cosyvoice_tpu.tokenizer.text import QwenTokenizer as JQwen

    want = [JQwen(d).encode(s) for s in STRINGS]
    for name in ("transformers", "tokenizers"):
        monkeypatch.setitem(sys.modules, name, None)
    text = importlib.reload(importlib.import_module("cosyvoice_tpu_torch.tokenizer.text"))
    assert [text.QwenTokenizer(d).encode(s) for s in STRINGS] == want


# ---- the frontend's text normalizer ---------------------------------------------

def test_frontend_text_normalizer_override():
    """A text_normalizer replaces the built-in rules, as in the JAX frontend."""
    from cosyvoice_tpu.runtime.frontend import CosyVoiceFrontEnd as JFrontEnd
    from cosyvoice_tpu.tokenizer.text import ByteTokenizer as JByte
    from cosyvoice_tpu_torch.runtime.frontend import CosyVoiceFrontEnd as TFrontEnd
    from cosyvoice_tpu_torch.tokenizer.text import ByteTokenizer as TByte

    def norm(text, split):
        return [p.strip() for p in text.upper().split("|")] if split else text.upper()
    ours = TFrontEnd(tokenizer=TByte(), device="cpu", text_normalizer=norm)
    theirs = JFrontEnd(tokenizer=JByte(), text_normalizer=norm)
    text = "first part | second part"
    assert ours.text_normalize(text) == theirs.text_normalize(text) == ["FIRST PART",
                                                                        "SECOND PART"]
    assert ours.text_normalize(text, split=False) == text.upper()
    plain = TFrontEnd(tokenizer=TByte(), device="cpu")
    assert plain.text_normalize(text) == JFrontEnd(tokenizer=JByte()).text_normalize(text)
