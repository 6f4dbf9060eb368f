"""From trained checkpoints to a served model, with the port's CLIs, on the
CPU against the JAX package:
- bin/average_model.py over the port trainer's checkpoints (parameters
  carried from seeded JAX trees by convert.py) equals the JAX package's
  average_checkpoints of the same trees (orbax), carried across: 1e-6; a
  HiFT's names under `generator.`;
- average_model -> bin/ckpt_resave.py's assemble_dir (with the frontend files
  of a small seeded directory, as tests/test_torch_checkpoint.py builds it,
  and a --ref_audio speaker) -> a directory that the port's
  from_pretrained and the JAX package's both load: zero-shot and sft
  (the registered speaker) give equal greedy tokens and wavs within 1e-2
  (deterministic HiFT on both sides); --lora_npz without --llm_pt raises;
- ckpt_resave --out_prefix's bare <prefix>.{llm,flow,hift}.npz equal the
  JAX CLI's from the same reference-format .pt files, key for key (a
  JAX-written lora.npz merged into the LLM too);
- bin/export_serving_lm.py's model.safetensors (read by the port's own
  reader) and config.json equal the JAX export's (which builds the HF
  model with `transformers`; skipped where that is absent), from a .pt
  and from a trainer's model_dir alike."""
import functools
import json
import os
import wave

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_port_util as U
import test_torch_checkpoint as C
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)
from cosyvoice_tpu.models import hift as jhift
from cosyvoice_tpu.models import llm as jllm
from cosyvoice_tpu.models import s3tokenizer as js3
from cosyvoice_tpu.runtime import api as japi
from cosyvoice_tpu.train import checkpoint as jckpt
from cosyvoice_tpu.train import optim as joptim
from cosyvoice_tpu.train import step as jstep
from cosyvoice_tpu_torch import convert
from cosyvoice_tpu_torch.bin import average_model, ckpt_resave, export_serving_lm
from cosyvoice_tpu_torch.models import campplus as tcamp
from cosyvoice_tpu_torch.models import flow as tflow
from cosyvoice_tpu_torch.models import hift as thift
from cosyvoice_tpu_torch.models import llm as tllm
from cosyvoice_tpu_torch.runtime import api as tapi
from cosyvoice_tpu_torch.train import optim as toptim
from cosyvoice_tpu_torch.train import step as tstep
from cosyvoice_tpu_torch.train.checkpoint import save_checkpoint
from cosyvoice_tpu_torch.utils import onnx_io as tonnx
from cosyvoice_tpu_torch.utils.safetensors_io import load_safetensors

TX = ("adam", 1e-3, "constantlr", {})


def _jax_tree(stem: str, seed: int) -> dict:
    if stem == "llm":
        return U.random_params(jllm.Qwen2LM(C.JCFG["lm_cfg"]).init, U.KEY,
                               jnp.zeros((1, 4), jnp.int32), jnp.asarray([4]),
                               jnp.zeros((1, 3), jnp.int32), jnp.asarray([3]), seed=seed)
    return U.random_params(jhift.HiFTGenerator(C.JCFG["hift_cfg"], deterministic=True).init,
                           {"params": U.KEY, "noise": U.KEY}, jnp.zeros((1, 2, 80)),
                           seed=seed)


KINDS = {"llm": "qwen2lm", "flow": "flow", "hift": "hift"}


def _port_module(stem: str, tree: dict):
    """The port module of `stem` (TCFG's widths) with a JAX tree's weights,
    carried as the trainer's parameters are (convert.train_state_from_jax)."""
    m = {"llm": lambda: tllm.Qwen2LM(C.TCFG["lm_cfg"]),
         "flow": lambda: tflow.CausalMaskedDiffWithXvec(C.TCFG["flow_cfg"]),
         "hift": lambda: thift.HiFTGenerator(C.TCFG["hift_cfg"])}[stem]()
    m.load_state_dict(convert.train_state_from_jax(KINDS[stem], tree), strict=True)
    return m


def _write_port_checkpoints(model_dir: str, stem: str, trees: list) -> None:
    """Port trainer checkpoints at steps 1.. of each tree's weights."""
    tx, _ = toptim.make_optimizer(*TX)
    for step, tree in enumerate(trees, start=1):
        state = tstep.make_train_state(_port_module(stem, tree), tx)
        state.step = step
        save_checkpoint(model_dir, state, step)


@pytest.mark.parametrize("stem", ["llm", "hift"])
def test_average_model_matches_jax(stem, tmp_path):
    """The newest 2 of 3 checkpoints: the port CLI's .pt against the JAX
    package's orbax average of the same trees."""
    trees = [_jax_tree(stem, 70 + i) for i in range(3)]
    jtx, _ = joptim.make_optimizer(*TX)
    jdir = str(tmp_path / "jax")
    for step, tree in enumerate(trees, start=1):
        jckpt.save_checkpoint(jdir, jstep.make_train_state(tree, jtx), step)
    want = jckpt.average_checkpoints(jdir, jstep.make_train_state(trees[0], jtx), last_n=2)
    want = convert.train_state_from_jax(KINDS[stem], want)
    _write_port_checkpoints(str(tmp_path / "port"), stem, trees)
    dst = str(tmp_path / f"{stem}.pt")
    average_model.main(["--src_dir", str(tmp_path / "port"), "--dst_path", dst, "--num", "2"])
    got = torch.load(dst, weights_only=True)
    prefix = "generator." if stem == "hift" else ""
    assert set(got) == {prefix + k for k in want}
    for k, v in want.items():
        assert got[prefix + k].dtype == torch.float32
        np.testing.assert_allclose(got[prefix + k].numpy(), v.numpy(), atol=1e-6, rtol=0,
                                   err_msg=k)


def _write_wav16k(path: str, wav: np.ndarray) -> None:
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes((np.clip(wav, -1, 1) * 32767).astype("<i2").tobytes())


@pytest.fixture(scope="module")
def deployed(tmp_path_factory):
    """Seeded weights -> port trainer checkpoints (the same state at steps
    1 and 2) -> average_model -> ckpt_resave --out_dir with the frontend
    files of a base directory and one --ref_audio speaker."""
    root = tmp_path_factory.mktemp("deploy")
    trees = C.jax_trees()
    base = root / "base"
    base.mkdir()
    U.write_campplus_onnx(str(base / "campplus.onnx"), U.seeded_campplus())
    tonnx.write_onnx_tensors(str(base / "speech_tokenizer_v2.onnx"),
                             js3.s3tokenizer_state_dict(trees["s3"], C.JCFG["s3_cfg"]))
    U.tokenizer_dir(base / "CosyVoice-BlankEN", "gpt2")
    ref = str(root / "spk1.wav")
    _write_wav16k(ref, U.prompt_wav(1.1, seed=3))
    avg = {}
    for stem in ("llm", "flow", "hift"):
        _write_port_checkpoints(str(root / f"exp_{stem}"), stem, [trees[stem]] * 2)
        avg[stem] = str(root / f"{stem}.pt")
        average_model.main(["--src_dir", str(root / f"exp_{stem}"), "--dst_path", avg[stem]])
    out = str(root / "deploy")
    # assemble_dir: main() takes the released CAMPPlus width, this one is small
    ckpt_resave.assemble_dir(out, llm_pt=avg["llm"], flow_pt=avg["flow"], hift_pt=avg["hift"],
                             campplus_onnx=str(base / "campplus.onnx"),
                             s3_onnx=str(base / "speech_tokenizer_v2.onnx"),
                             tokenizer_dir=str(base / "CosyVoice-BlankEN"),
                             ref_audios={"spk1": ref},
                             campplus_cfg=tcamp.CAMPPlusConfig(**U.CAMP), device="cpu")
    return out, trees


def test_resaved_directory_layout(deployed):
    out, trees = deployed
    assert sorted(os.listdir(out)) == sorted(
        ["llm.pt", "flow.pt", "hift.pt", "campplus.onnx", "speech_tokenizer_v2.onnx",
         "CosyVoice-BlankEN", "spk2info.npz"])
    hift = torch.load(os.path.join(out, "hift.pt"), weights_only=True)
    assert all(k.startswith("generator.") for k in hift)
    llm = torch.load(os.path.join(out, "llm.pt"), weights_only=True)
    for k, v in convert.lm_state_from_jax(trees["llm"]).items():
        assert torch.equal(llm[k], v.float()), k       # the mean of equal states is exact
    with np.load(os.path.join(out, "spk2info.npz")) as spk:
        assert spk.files == ["spk1/embedding"] and spk["spk1/embedding"].shape == (C.SPK_DIM,)


@pytest.fixture(scope="module")
def served(deployed):
    """(JAX CosyVoice2, port CosyVoice2) from the resaved directory, each
    with a deterministic HiFT."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jhift, "HiFTGenerator", functools.partial(jhift.HiFTGenerator,
                                                         deterministic=True))
    mp.setattr(tapi, "HiFTGenerator", functools.partial(thift.HiFTGenerator,
                                                        deterministic=True))
    try:
        return (japi.from_pretrained(deployed[0], max_decode_tokens=C.MAX_TOKENS, **C.JCFG),
                tapi.from_pretrained(deployed[0], max_decode_tokens=C.MAX_TOKENS, device="cpu",
                                     **C.TCFG))
    finally:
        mp.undo()


@pytest.mark.parametrize("mode", ["zero_shot", "sft"])
def test_resaved_directory_serves_as_in_jax(served, mode, monkeypatch):
    """Both packages' from_pretrained of the resaved directory: the tokens
    the flow gets equal (greedy), the wav within 1e-2."""
    U.interpret_pallas(monkeypatch)
    jcv, tcv = served
    args = C.MODES[mode] if mode == "zero_shot" else ("hello world", "spk1")
    tokens_j, tokens_t = [], []
    C._recording(monkeypatch, jcv.model, tokens_j)
    C._recording(monkeypatch, tcv.model, tokens_t)
    wj = np.concatenate([o["tts_speech"] for o in getattr(jcv, f"inference_{mode}")(*args)])
    wt = np.concatenate([o["tts_speech"] for o in getattr(tcv, f"inference_{mode}")(*args)])
    assert len(tokens_t) == len(tokens_j) == 1 and len(tokens_t[0]) > 0
    np.testing.assert_array_equal(tokens_t[0], tokens_j[0])
    assert wt.shape == wj.shape and np.isfinite(wt).all()
    np.testing.assert_allclose(wt, wj, atol=1e-2)
    np.testing.assert_array_equal(tcv.frontend.spk2info["spk1"]["embedding"],
                                  jcv.frontend.spk2info["spk1"]["embedding"])


@pytest.mark.parametrize("flag", ["--lora_npz"])
def test_ckpt_resave_refuses_what_is_not_ported(flag, tmp_path):
    """--lora_npz without the --llm_pt it merges into raises, into a
    directory or a prefix (tests/test_torch_lora.py covers the merge
    itself)."""
    for out in ("--out_dir", "--out_prefix"):
        with pytest.raises(ValueError, match="--llm_pt"):
            ckpt_resave.main([out, str(tmp_path / "d"), flag, str(tmp_path / "x")])


@pytest.mark.parametrize("lora", [False, True], ids=["plain", "lora_npz"])
def test_ckpt_resave_out_prefix_matches_jax(tmp_path, monkeypatch, lora):
    """--out_prefix from the same reference-format llm.pt, flow.pt and
    hift.pt (`generator.` names) in both packages' CLIs (the JAX one's
    default configs swapped for the files' widths): the same npz keys, and
    each array equal (the LLM with a JAX-written lora.npz merged: within
    1e-6, the products' order of sums)."""
    import sys

    import test_torch_lora as L
    from cosyvoice_tpu.bin import ckpt_resave as jresave
    from cosyvoice_tpu.models import flow as jflow
    from cosyvoice_tpu.models.qwen2 import Qwen2Config as JQwen2Config

    _, params, tm = U.build_lm()
    flow = tflow.CausalMaskedDiffWithXvec(C.TCFG["flow_cfg"])
    flow.load_state_dict(U.seeded_state(flow, 3))
    hift = thift.HiFTGenerator(C.TCFG["hift_cfg"])
    hift.load_state_dict(U.seeded_state(hift, 4))
    paths = {stem: str(tmp_path / f"{stem}.pt") for stem in ("llm", "flow", "hift")}
    torch.save(tm.state_dict(), paths["llm"])
    torch.save(flow.state_dict(), paths["flow"])
    torch.save({f"generator.{k}": v for k, v in hift.state_dict().items()}, paths["hift"])
    args = [a for stem, p in paths.items() for a in (f"--{stem}_pt", p)]
    if lora:
        _, jov = L._jax_overlay(params, (r".*/(q_proj|o_proj)/kernel$",), seed=21)
        np.savez(tmp_path / "lora.npz", **L.jlora.lora_state_dict(jov))
        args += ["--lora_npz", str(tmp_path / "lora.npz"), "--lora_r", "4", "--lora_alpha", "8"]
    lm_cfg = jllm.LMConfig(**U.LM, qwen=JQwen2Config(**U.QWEN))
    monkeypatch.setattr(jllm, "LMConfig", lambda: lm_cfg)
    monkeypatch.setattr(jflow, "FlowConfig", lambda: C.JCFG["flow_cfg"])
    monkeypatch.setattr(jhift, "HiFTConfig", lambda: C.JCFG["hift_cfg"])
    monkeypatch.setattr(sys, "argv", ["ckpt_resave", *args, "--out_prefix",
                                      str(tmp_path / "jax")])
    jresave.main()
    ckpt_resave.main([*args, "--out_prefix", str(tmp_path / "port")])
    for stem in ("llm", "flow", "hift"):
        want = np.load(tmp_path / f"jax.{stem}.npz")
        got = np.load(tmp_path / f"port.{stem}.npz")
        assert sorted(got.files) == sorted(want.files), stem
        for k in want.files:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
            if lora and stem == "llm":
                np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0, err_msg=k)
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_merge_state_dicts_is_strict_false():
    base = {"a": torch.zeros(2), "b": torch.zeros(3), "c": torch.zeros(1)}
    upd = {"a": torch.ones(2), "b": torch.ones(4), "x": torch.ones(1)}
    out = ckpt_resave.merge_state_dicts(base, upd)
    assert set(out) == {"a", "b", "c"}
    assert torch.equal(out["a"], torch.ones(2)) and torch.equal(out["b"], torch.zeros(3))
    wrapped = {"state_dict": {"generator.w": torch.ones(1)}, "epoch": 3}
    assert set(ckpt_resave.clean_state_dict(wrapped, "generator.")) == {"w"}


def test_export_serving_lm_matches_jax(tmp_path):
    pytest.importorskip("transformers")
    from cosyvoice_tpu.bin import export_serving_lm as jexport

    tree = _jax_tree("llm", 75)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jexport.export_serving_lm(tree, C.JCFG["lm_cfg"], jdir)
    torch.save(convert.lm_state_from_jax(tree), tmp_path / "llm.pt")
    conf = tmp_path / "conf.yaml"          # the recipe layout: an llm section
    conf.write_text("llm: " + json.dumps(dict(C.LM, kind="qwen2lm", qwen=C.QWEN)) + "\n")
    export_serving_lm.main(["--ckpt", str(tmp_path / "llm.pt"), "--out", tdir,
                            "--config", str(conf)])
    # the same LM as the newest checkpoint of a trainer's model_dir
    _write_port_checkpoints(str(tmp_path / "exp_llm"), "llm", [_jax_tree("llm", 76), tree])
    export_serving_lm.main(["--ckpt", str(tmp_path / "exp_llm"), "--out", tdir + "_dir",
                            "--config", str(conf)])
    want = torch.load(os.path.join(jdir, "pytorch_model.bin"), weights_only=True)
    got = load_safetensors(os.path.join(tdir, "model.safetensors"))
    from_dir = load_safetensors(os.path.join(tdir + "_dir", "model.safetensors"))
    assert all(torch.equal(from_dir[k], got[k]) for k in got) and set(from_dir) == set(got)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    vocab = C.TCFG["lm_cfg"].speech_token_size + 3
    assert got["lm_head.weight"].shape[0] % 64 == 0 and not got["lm_head.bias"][vocab:].any()
    jconf = json.load(open(os.path.join(jdir, "config.json")))
    tconf = json.load(open(os.path.join(tdir, "config.json")))
    for k, v in tconf.items():
        assert jconf.get(k) == v, (k, v, jconf.get(k))
    assert tconf["architectures"] == ["CosyVoice2ForCausalLM"]
