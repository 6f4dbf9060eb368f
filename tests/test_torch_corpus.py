"""The port's corpora against the JAX package on the CPU: the pipeline
stages of the phoneme LMs' and the parquet corpora (kaldi_dir_source,
spk_json_source, truncate, parquet_opener + decode_audio_bytes +
parse_embedding, truncate_phoneme_sequence, tokenize_phoneme and padding's
pho_token / use_spk_embedding) stage for stage on the same inputs, every
array equal; data/parquet_io.py both ways between the two packages (the
writers' bytes equal, each package reading the other's file, snappy
streams with copies); bin/train.py --data_format parquet on transformer_lm;
tokenizer/preprocess.py on fixed strings; data/transcriber.py's gate."""
import io
import json
import os
import random
import wave

import numpy as np
import pytest
import yaml

from torch_port_util import one_torch_thread, train_section  # noqa: F401 (autouse)
from cosyvoice_tpu.data import parquet_io as jpq
from cosyvoice_tpu.data import pipeline as jpp
from cosyvoice_tpu.tokenizer import phoneme as jphoneme
from cosyvoice_tpu.tokenizer import preprocess as jpre
from cosyvoice_tpu_torch.bin import train as train_cli
from cosyvoice_tpu_torch.bin.inference import write_wav
from cosyvoice_tpu_torch.data import parquet_io as tpq
from cosyvoice_tpu_torch.data import pipeline as tpp
from cosyvoice_tpu_torch.data import transcriber
from cosyvoice_tpu_torch.tokenizer import phoneme as tphoneme
from cosyvoice_tpu_torch.tokenizer import preprocess as tpre
from cosyvoice_tpu_torch.train.checkpoint import latest_step

PHO = ["sil", "n", "i3", "#1", "h", "ao3", "#2", "m", "uo2", "#3", "sil"]
DUR = [0.1, 0.12, 0.15, 0.0, 0.12, 0.18, 0.0, 0.12, 0.2, 0.0, 0.1]


def _same(got, want):
    """Two sample streams (or batches) equal key by key, arrays exactly."""
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w), sorted(set(g) ^ set(w))
        for k in w:
            if isinstance(w[k], (np.ndarray, np.generic)):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k
    return got


def _wav_bytes(wav: np.ndarray, sr: int, channels: int = 1) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(wav, -1, 1) * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


def _spk_json(tmp_path) -> list:
    """Two speaker-JSON files: 3 speakers, clips of 1.2 s and one of 1.6 s."""
    rng = np.random.default_rng(1)
    paths = []
    for f in range(2):
        data = {}
        for s in range(2 if f == 0 else 1):
            utts = []
            for i in range(3):
                seconds = 1.6 if i == 2 else sum(DUR)
                p = tmp_path / f"f{f}_s{s}_{i}.wav"
                write_wav(str(p), rng.standard_normal(int(24000 * seconds)) * 0.1, 24000)
                u = {"utt": f"f{f}s{s}u{i}", "wav": str(p), "text": "ni hao",
                     "phoneme": " ".join(PHO), "durations": DUR,
                     "embedding": rng.standard_normal(8).tolist()}
                if i == 1:
                    del u["utt"], u["embedding"]
                utts.append(u)
            data[f"spk{f}{s}"] = utts
        paths.append(str(tmp_path / f"c{f}.json"))
        with open(paths[-1], "w") as fh:
            json.dump(data, fh)
    return paths


def test_spk_json_and_kaldi_sources_match_jax(tmp_path):
    """spk_json_source (shuffled by one seeded random.Random across files,
    short clips doubled) and kaldi_dir_source (a missing text and utt2spk
    entry) give the JAX package's samples, in order."""
    paths = _spk_json(tmp_path)
    for seed, rich in ((3, False), (4, True)):
        _same(tpp.spk_json_source(iter(paths), seed, rich),
              jpp.spk_json_source(iter(paths), seed, rich))
    kd = tmp_path / "kaldi"
    kd.mkdir()
    wavs = sorted(p for p in os.listdir(tmp_path) if p.endswith(".wav"))[:3]
    (kd / "wav.scp").write_text("".join(f"u{i} {tmp_path / w}\n" for i, w in enumerate(wavs)))
    (kd / "text").write_text("u0 hello\nu2 world there\n")
    (kd / "utt2spk").write_text("u0 a\nu1 b\n")
    got = _same(tpp.kaldi_dir_source(str(kd)), jpp.kaldi_dir_source(str(kd)))
    assert [s["spk"] for s in got] == ["a", "b", "u2"] and got[1]["text"] == ""


def test_truncate_and_phoneme_stages_match_jax(tmp_path):
    """truncate (the global `random` module, seeded alike), then
    truncate_phoneme_sequence (prob 0.6, seed 2: crops at #1 / #2 / #3,
    passes, drops for an audio-duration mismatch and for a count mismatch),
    then tokenize_phoneme (an unknown phoneme drops its sample) on the
    speaker-JSON samples, stage by stage as the JAX package's."""
    samples = list(tpp.spk_json_source(iter(_spk_json(tmp_path)), 0))
    samples[1] = dict(samples[1], durations=DUR[:-1])
    samples[4] = dict(samples[4], phoneme=PHO[:5] + ["zz"] + PHO[6:])
    samples.append({"utt": "plain", "speech": samples[0]["speech"], "sample_rate": 24000})
    random.seed(5)
    want = list(jpp.truncate(1.3)(iter([dict(s) for s in samples])))
    random.seed(5)
    got = _same(tpp.truncate(1.3)(iter([dict(s) for s in samples])), want)
    assert sum(len(s["speech"]) < len(t["speech"]) for s, t in zip(got, samples)) >= 1
    want = list(jpp.truncate_phoneme_sequence(prob=0.6, seed=2)(iter(samples * 3)))
    got = _same(tpp.truncate_phoneme_sequence(prob=0.6, seed=2)(iter(samples * 3)), want)
    assert len(samples * 3) > len(got) and any(len(s["phoneme"]) < len(PHO) for s in got
                                                if "phoneme" in s)
    d = tmp_path / "pho.json"
    d.write_text(json.dumps({p: i for i, p in enumerate(["sil", "n", "i", "h", "ao", "m",
                                                          "uo"])}))
    jt, tt = jphoneme.PhonemeTokenizer(str(d)), tphoneme.PhonemeTokenizer(str(d))
    want = list(jpp.tokenize_phoneme(jt)(iter(got)))
    toks = _same(tpp.tokenize_phoneme(tt)(iter(got)), want)
    assert len(toks) < len(got)


def _pho_samples():
    rng = np.random.default_rng(6)
    out = []
    for i, n in enumerate([4, 7, 5]):
        s = {"utt": f"u{i}", "speech_feat": np.zeros((10 + 3 * i, 4), np.float32),
             "speech_token": rng.integers(0, 50, 5 + i), "text_token": rng.integers(0, 9, 3),
             "pho_token": rng.integers(0, 9, n).tolist(),
             "text_tone": rng.integers(0, 6, n).tolist(), "text_lang": [0] * n,
             "text_prsd": rng.integers(0, 4, n).tolist(),
             "embedding": rng.standard_normal(6).astype(np.float32)}
        if i != 1:
            s["spk_embedding"] = rng.standard_normal(6).astype(np.float32)
        out.append(s)
    return out


@pytest.mark.parametrize("use_spk", [False, True])
def test_padding_pho_streams_match_jax(use_spk):
    """padding's pho_token [B, T, 4] and pho_token_len (rounded to 8, longest
    mel first), and the embedding rows (the spk_embedding where a sample has
    one with use_spk_embedding): the JAX package's arrays exactly."""
    want = next(jpp.padding(use_spk_embedding=use_spk)(iter([_pho_samples()])))
    got = _same([next(tpp.padding(use_spk_embedding=use_spk)(iter([_pho_samples()])))],
                [want])[0]
    assert got["pho_token"].shape == (3, 8, 4)


def _parquet_rows(n: int = 4):
    rng = np.random.default_rng(9)
    rows = []
    for i in range(n):
        sr = 16000 if i == 2 else 24000
        wav = rng.standard_normal(int(sr * 0.3)) * 0.1
        rows.append({"utt": f"u{i}", "spk": f"s{i % 2}", "text": f"hello {i}",
                     "audio_data": _wav_bytes(wav, sr, channels=2 if i == 3 else 1),
                     "speech_token": rng.integers(0, 100, 7 + i).tolist(),
                     "utt_embedding": rng.standard_normal(6).tolist(),
                     "spk_embedding": None if i == 1 else rng.standard_normal(6).tolist()})
    rows.append(dict(rows[0], utt="bad", audio_data=b"not a wav"))
    return rows


@pytest.mark.parametrize("codec", ["uncompressed", "snappy"])
def test_parquet_both_ways(tmp_path, codec):
    """Each package's write_parquet of the same rows gives the same bytes;
    each package reads the other's file back to the rows; the parquet
    stages (parquet_opener, decode_audio_bytes with a stereo row and a row
    whose bytes are not a WAV, parse_embedding) give the JAX package's
    samples."""
    rows = _parquet_rows()
    tp, jp = str(tmp_path / "port.parquet"), str(tmp_path / "jax.parquet")
    tpq.write_parquet(tp, rows, codec)
    jpq.write_parquet(jp, rows, codec)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    for got in (tpq.read_parquet(jp), jpq.read_parquet(tp)):
        assert len(got) == len(rows)
        for g, r in zip(got, rows):
            assert g["utt"] == r["utt"] and g["audio_data"] == r["audio_data"]
            assert g["speech_token"] == r["speech_token"]
            assert (g["spk_embedding"] is None) == (r["spk_embedding"] is None)
            np.testing.assert_allclose(g["utt_embedding"], r["utt_embedding"], rtol=1e-6)

    def chain(pp):
        return pp.Pipeline([tp, str(tmp_path / "missing.parquet")], pp.parquet_opener,
                           pp.decode_audio_bytes(), pp.parse_embedding())

    got = _same(chain(tpp), chain(jpp))
    assert len(got) == len(rows) - 1 and got[3]["speech"].ndim == 1


def test_snappy_streams_with_copies_match_jax():
    """snappy_decompress of a stream with a literal, a 1-byte-offset copy
    and a 2-byte-offset copy (the all-literal writer never emits copies)
    equals the JAX package's and the expected bytes; compress/decompress
    round trips in both packages."""
    stream = bytes([15, 0x0C]) + b"abcd" + bytes([0x11, 4, 0x0A, 2, 0])
    assert tpq.snappy_decompress(stream) == jpq.snappy_decompress(stream) == \
        b"abcdabcdabcd" + b"cdc"
    data = bytes(np.random.default_rng(0).integers(0, 256, 3000, dtype=np.uint8)) * 2
    assert tpq.snappy_compress(data) == jpq.snappy_compress(data)
    assert tpq.snappy_decompress(jpq.snappy_compress(data)) == data


def test_train_cli_parquet_transformer_lm(tmp_path):
    """bin/train.py --data_format parquet for the v1 LM: parquet shards of
    WAV bytes, speech tokens and utt / spk embeddings; one epoch, finite
    metrics, a checkpoint."""
    rng = np.random.default_rng(2)
    rows = [{"utt": f"u{i}", "text": "hello world",
             "audio_data": _wav_bytes(rng.standard_normal(15600) * 0.1, 24000),
             "speech_token": rng.integers(0, 100, 30).tolist(),
             "utt_embedding": rng.standard_normal(512).tolist(),
             "spk_embedding": rng.standard_normal(512).tolist()} for i in range(3)]
    shard = str(tmp_path / "shard0.parquet")
    tpq.write_parquet(shard, rows, "snappy")
    (tmp_path / "train.list").write_text(shard + "\n")
    conf = {"llm": dict(train_section("transformer_lm"), kind="transformer_lm"),
            "data": {"filter": {"max_length": 99999, "token_max_length": 300},
                     "fbank": {"n_fft": 192, "hop": 48, "n_mels": 20},
                     "max_frames_in_batch": 1000, "shuffle_buf": 4, "sort_buf": 2},
            "train_conf": {"lr": 1e-4, "log_interval": 1, "scheduler_conf": {"warmup_steps": 10}}}
    (tmp_path / "c.yaml").write_text(yaml.safe_dump(conf, default_flow_style=False))
    model_dir = str(tmp_path / "exp")
    train_cli.main(["--config", str(tmp_path / "c.yaml"), "--model", "llm", "--train_data",
                    str(tmp_path / "train.list"), "--model_dir", model_dir,
                    "--data_format", "parquet", "--epochs", "1", "--device", "cpu"])
    recs = [json.loads(line) for line in open(os.path.join(model_dir, "metrics.jsonl"))]
    assert recs and all(np.isfinite(r["loss"]) and np.isfinite(r["acc"]) for r in recs)
    assert latest_step(model_dir) == len(recs)


TEXTS = ["Hello,  WORLD (ppl) 你好 世界！", "ｈｅｌｌｏ\x07 <unl> <noise> <noise> 测试test",
         "(ppb) 我们 are  中文 english mix", "", "a", "数字 12345 和 3.14 <unk foo>"]


def test_preprocess_matches_jax(tmp_path):
    """Every text function of tokenizer/preprocess.py and both kaldi-text
    writers on fixed code-switched strings: the JAX package's output."""
    for name in ("normalize_text", "remove_control_chars", "remove_redundant_whitespaces",
                 "extract_mandarin_only", "extract_non_mandarin",
                 "remove_space_between_mandarin", "insert_space_between_mandarin",
                 "remove_repeated_noise"):
        for t in TEXTS:
            assert getattr(tpre, name)(t) == getattr(jpre, name)(t), (name, t)
    src = tmp_path / "text"
    src.write_text("".join(f"utt{i} {t}\n" for i, t in enumerate(TEXTS)))
    outs = {}
    for lib in (tpre, jpre):
        d = tmp_path / lib.__name__.split(".")[0]
        d.mkdir()
        n = lib.write_mandarin_only_text(str(src), str(d / "m"), str(d / "c"), str(d / "b"))
        lib.write_bpe_train_text(str(src), str(d / "e"))
        outs[lib] = (n, *[(d / f).read_text() for f in "mcbe"])
    assert outs[tpre] == outs[jpre] and outs[tpre][0] > 0


def test_transcriber_gate_and_stage():
    """Without funasr, available() is False and building the model raises
    RuntimeError naming it; transcribe_stage fills only missing text, with
    an injected transcriber."""
    samples = [{"txt": "", "speech": [0.0], "sample_rate": 16000},
               {"txt": "already", "speech": [0.0], "sample_rate": 16000}]
    out = list(transcriber.transcribe_stage(transcriber=lambda w, sr: "asr text")(
        iter(samples)))
    assert [s["txt"] for s in out] == ["asr text", "already"]
    if transcriber.available():
        pytest.skip("funasr is installed here; the gate is for its absence")
    with pytest.raises(RuntimeError, match="funasr"):
        transcriber.get_transcriber()
    with pytest.raises(RuntimeError, match="funasr"):
        list(transcriber.transcribe_stage()(iter([{"txt": "", "speech": [0.0],
                                                    "sample_rate": 16000}])))
