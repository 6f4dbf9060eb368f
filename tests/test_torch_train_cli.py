"""`python -m cosyvoice_tpu_torch.bin.train` on the CPU (its main() with
--device cpu) at the small widths of tests/test_train_cli.py's recipe:
qwen2lm, transformer_lm and the flow each train one epoch on a seeded
jsonl corpus, write metrics.jsonl with finite values and a checkpoint, and
a second run resumes from that checkpoint; hift, bigvgan and vits each take
two D + G step pairs against MPD + MRD and checkpoint both nets; adamw
takes no weight decay, as the JAX CLI's; more than one card and what the
JAX CLI does not train raise NotImplementedError; the default
device is the card, with no fallback.  Also the recipe reader's block
sequences (the train configs below are written by yaml.safe_dump)."""
import json
import os

import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from torch_port_util import (one_torch_thread, train_section,  # noqa: F401 (autouse)
                             write_train_corpus)
from cosyvoice_tpu_torch.bin import train as train_cli
from cosyvoice_tpu_torch.config import parse_yaml
from cosyvoice_tpu_torch.train.checkpoint import latest_step

DATA = {"filter": {"max_length": 99999, "token_max_length": 300},
        "fbank": {"n_fft": 192, "hop": 48, "n_mels": 20},
        "max_frames_in_batch": 1000, "shuffle_buf": 4, "sort_buf": 2}


def _config(tmp_path, model: str, kind: str, **train_conf) -> str:
    conf = {model: dict(train_section(kind), kind=kind), "data": DATA,
            "train_conf": dict({"lr": 1e-4, "log_interval": 1,
                                "scheduler_conf": {"warmup_steps": 10}}, **train_conf)}
    path = tmp_path / f"{kind}.yaml"
    path.write_text(yaml.safe_dump(conf, default_flow_style=False))
    return str(path)


def _metrics(model_dir: str) -> list:
    return [json.loads(line) for line in open(os.path.join(model_dir, "metrics.jsonl"))]


@pytest.mark.parametrize("model,kind", [("llm", "qwen2lm"), ("llm", "transformer_lm"),
                                        ("flow", "flow")])
def test_train_cli_trains_and_resumes(tmp_path, model, kind):
    """One epoch (6 utterances, two batches), then a second run of one epoch
    that resumes at the saved step: every logged value finite, the TRAIN
    steps 1..4 in order, the newest checkpoint at step 4."""
    lst = write_train_corpus(tmp_path, n=6)
    cfg = _config(tmp_path, model, kind)
    model_dir = str(tmp_path / f"exp_{kind}")
    argv = ["--config", cfg, "--model", model, "--train_data", lst, "--model_dir", model_dir,
            "--epochs", "1", "--device", "cpu"]
    train_cli.main(argv)
    first = _metrics(model_dir)
    assert latest_step(model_dir) == len(first) == 2
    train_cli.main(argv)
    recs = _metrics(model_dir)
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    for r in recs:
        assert all(np.isfinite(v) for k, v in r.items() if k != "tag"), r
    assert "acc" in recs[-1] if model == "llm" else "loss" in recs[-1]
    assert latest_step(model_dir) == 4
    assert os.path.exists(os.path.join(model_dir, "info_4.json"))


@pytest.mark.parametrize("args,conf,item", [
    (["--model", "hift", "--mesh_data", "2"], {}, "takes no mesh"),
    (["--model", "llm"], {"llm": {"kind": "qwen2lm_phoneme_multicode"}}, "JAX CLI fails"),
    (["--model", "hift", "--lora"], {}, "trains every parameter"),
    (["--model", "llm", "--data_format", "parquet"], {"llm": {"kind": "qwen2lm_phoneme"}},
     "as jsonl"),
], ids=["gan", "phoneme_lm", "lora", "parquet"])
def test_train_cli_refuses_waiting_branches(tmp_path, args, conf, item):
    """GAN training under a mesh raises saying that the JAX CLI's GAN branch
    takes no mesh (--lora and the phoneme kinds train on one:
    tests/test_torch_parallel.py); what the JAX CLI does not train (the
    multi-code kind, --lora on a vocoder, parquet shards for a phoneme LM)
    raises naming what the JAX CLI does there."""
    cfg = tmp_path / "c.yaml"
    base = {"llm": dict(train_section("qwen2lm"), kind="qwen2lm"), "hift": {"kind": "hift"}}
    cfg.write_text(yaml.safe_dump(dict(base, **conf), default_flow_style=False))
    with pytest.raises(NotImplementedError, match=item):
        train_cli.main(["--config", str(cfg), "--train_data", "x", "--model_dir",
                        str(tmp_path / "m"), "--device", "cpu", *args])


@pytest.mark.skipif(torch.cuda.is_available(), reason="the CPU-only check of the default")
def test_train_cli_defaults_to_the_card(tmp_path):
    """Without --device the CLI asks for CUDA and raises where there is none."""
    cfg = _config(tmp_path, "llm", "qwen2lm")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--config", cfg, "--model", "llm", "--train_data", "x",
                        "--model_dir", str(tmp_path / "m")])


def test_yaml_reader_block_sequences():
    """The recipe reader takes block sequences of scalars and flow lists (as
    yaml.safe_dump writes lists) equal to yaml.safe_load, and raises on a
    block sequence of sequences or mappings (before this it read either as
    null keys without a word)."""
    conf = {"a": {"b": [16, 32], "c": [[1, 3], [2]], "d": {"e": ["x", 1.5, True]}}}
    txt = yaml.safe_dump(conf, default_flow_style=None)
    assert parse_yaml(txt) == yaml.safe_load(txt) == conf
    txt = "a:\n  b:\n    - 1\n    - [2, 3]\n  c: 2\n"
    assert parse_yaml(txt) == yaml.safe_load(txt)
    for bad in ("a:\n- - 1\n- - 2\n", "a:\n- k: v\n"):
        with pytest.raises(ValueError, match="block sequence"):
            parse_yaml(bad)


def test_train_cli_adamw_takes_no_weight_decay(tmp_path):
    """An adamw recipe with train_conf.weight_decay trains exactly as one
    without it: the JAX CLI passes no weight decay to make_optimizer, so
    its adamw decays by 0 (ROADMAP Queue 3 F2)."""
    lst = write_train_corpus(tmp_path, n=3)
    params = []
    for wd in (None, 0.5):
        extra = {"optim": "adamw"} if wd is None else {"optim": "adamw", "weight_decay": wd}
        cfg = _config(tmp_path, "llm", "qwen2lm", **extra)
        model_dir = str(tmp_path / f"exp_{wd}")
        train_cli.main(["--config", cfg, "--model", "llm", "--train_data", lst, "--model_dir",
                        model_dir, "--epochs", "1", "--device", "cpu"])
        step = latest_step(model_dir)
        params.append(torch.load(os.path.join(model_dir, str(step), "state.pt"),
                                 weights_only=True)["params"])
    assert params[0].keys() == params[1].keys()
    for k in params[0]:
        assert torch.equal(params[0][k], params[1][k]), k


@pytest.mark.parametrize("model", list(chip_smoke.GAN_SMALL))
def test_train_cli_gan_vocoders(tmp_path, model):
    """chip_smoke.py's GAN CLI inputs (the recipes' layout at small widths:
    24 kHz, 480 samples a mel frame, 25 Hz tokens; two utterances of 0.32
    s, one a batch), so one epoch is two D + G step pairs against MPD +
    MRD: every logged value finite (the f0 term only for HiFT), both nets
    checkpointed at step 2."""
    lst, recipes = chip_smoke.write_gan_cli_inputs(str(tmp_path))
    model_dir = str(tmp_path / f"exp_{model}")
    train_cli.main(["--config", recipes[model], "--model", model, "--train_data", lst,
                    "--model_dir", model_dir, "--epochs", "1", "--device", "cpu"])
    recs = _metrics(model_dir)
    assert [r["step"] for r in recs] == [1, 2]
    for r in recs:
        assert all(np.isfinite(v) for k, v in r.items() if k != "tag"), r
        assert {"d_loss_disc", "loss_gen", "loss_fm", "loss_mel", "loss_tpr"} <= set(r)
    assert (recs[-1].get("loss_f0", 0.0) > 0) == (model == "hift")
    assert ("loss_kl" in recs[-1]) == (model == "vits")
    assert latest_step(model_dir) == latest_step(model_dir + "_disc") == 2
