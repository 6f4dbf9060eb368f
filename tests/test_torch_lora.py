"""The port's LoRA (train/lora.py, convert.lora_overlay_from_jax, bin/train.py
--lora, bin/ckpt_resave.py --lora_npz) against the JAX package's
train/lora.py, on the CPU at small widths: the zero-initialised overlay is
the base model exactly; a JAX overlay (with nonzero b) mapped to the port's
names merges to the JAX package's merged weights (Linear weights of the
Qwen2 body and the flow's conformer, a weight-normed conv's direction); a
LoRA train step moves only the overlay, as the JAX one does; the train
CLI's lora.npz merges through ckpt_resave into the llm.pt a model
directory serves, for a port-written and a JAX-written file.  Each test
states its bar."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import torch_port_util as U
from torch_port_util import one_torch_thread, quick_jit, random_params  # noqa: F401
from torch_port_util import train_section, write_train_corpus
from cosyvoice_tpu import config as jconfig
from cosyvoice_tpu.train import lora as jlora
from cosyvoice_tpu.train import optim as joptim
from cosyvoice_tpu.train import step as jstep
from cosyvoice_tpu_torch import config as tconfig
from cosyvoice_tpu_torch import convert
from cosyvoice_tpu_torch.bin import ckpt_resave
from cosyvoice_tpu_torch.bin import train as train_cli
from cosyvoice_tpu_torch.train import lora as tlora
from cosyvoice_tpu_torch.train import optim as toptim
from cosyvoice_tpu_torch.train import step as tstep
from cosyvoice_tpu_torch.train.checkpoint import latest_step

QKVO = ["q_proj", "k_proj", "v_proj", "o_proj"]
ATTN = ["linear_q", "linear_k", "linear_v", "linear_out"]


def _jax_overlay(params, patterns, seed: int, r: int = 4):
    """A JAX overlay over `params` with b drawn too (init_lora sets b = 0)."""
    cfg = jlora.LoRAConfig(r=r, alpha=8, target_patterns=patterns)
    ov = jlora.init_lora(params, cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return cfg, {p: {"a": np.asarray(ab["a"]),
                     "b": (0.05 * rng.standard_normal(ab["b"].shape)).astype(np.float32)}
                 for p, ab in ov.items()}


def _lm_batch(seed: int = 3):
    rng = np.random.default_rng(seed)
    return {"text_token": _i(rng.integers(0, 300, (2, 5))), "text_token_len": _i([5, 3]),
            "speech_token": _i(rng.integers(0, U.SPEECH_VOCAB, (2, 6))),
            "speech_token_len": _i([6, 4])}


def _i(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.long)


def test_zero_init_is_the_base_model():
    """init_lora (r 4, q/k/v/o) on the port's Qwen2LM: one pair a projection
    of each layer, a [r, fan_in] ~ N(0, 0.01), b [fan_out, r] zero; the loss
    through lora_loss_fn equals the base model's exactly."""
    _, _, tm = U.build_lm()
    cfg = tlora.LoRAConfig(r=4, alpha=8, target_patterns=(tlora.target_pattern(QKVO),))
    ov = tlora.init_lora(tm, cfg, torch.Generator().manual_seed(0))
    assert len(ov) == 4 * U.QWEN["num_layers"]
    for name, ab in ov.items():
        w = tm.get_parameter(name)
        assert ab["a"].shape == (4, w.shape[1]) and ab["b"].shape == (w.shape[0], 4)
        assert not ab["b"].any() and 0.005 < float(ab["a"].std()) < 0.015
    b = _lm_batch()
    base = tstep.llm_loss_fn(tm.eval(), b)[0]
    fn = tlora.lora_loss_fn(tm, tstep.llm_loss_fn, cfg)
    assert fn(tlora.LoRAOverlay(ov).eval(), b)[0].item() == base.item()
    with pytest.raises(ValueError, match="Linear and Conv1d"):
        tlora.init_lora(tm, tlora.LoRAConfig(target_patterns=(r".*embed_tokens\.weight$",)),
                        torch.Generator())


def _merge_case(model: str):
    """-> (jax params, port model, jax patterns, port patterns)."""
    if model == "qwen2lm":
        _, params, tm = U.build_lm()
        return params, tm, (r".*/(q_proj|k_proj|v_proj|o_proj)/kernel$",), QKVO
    if model == "flow":         # shapes only (eval_shape): nothing of the flow compiles
        sec = train_section("flow")
        jm, _ = jconfig.build_model("flow", sec)
        rng = np.random.default_rng(0)
        args = (jnp.asarray(rng.integers(0, 128, (1, 4))), jnp.asarray([4]),
                jnp.zeros((1, 8, 20)), jnp.asarray([8]), jnp.zeros((1, 512)))
        params = random_params(jm.init, U.KEY, *args, U.KEY, deterministic=True, seed=3)
        tm, _ = tconfig.build_model("flow", sec)
        tm.load_state_dict(convert.train_state_from_jax("flow", params), strict=True)
        return (params, tm, (r".*/(linear_q|linear_k|linear_v|linear_out|w_1)/kernel$",),
                ATTN + ["w_1"])
    jm = U.jhift.HiFTGenerator(U.jhift.HiFTConfig(**U.HIFT), deterministic=True)
    params = random_params(jm.init, {"params": U.KEY, "noise": U.KEY},
                           jnp.zeros((1, 2, U.N_MEL)), seed=4)
    tm = U.thift.HiFTGenerator(U.thift.HiFTConfig(**U.HIFT), deterministic=True)
    tm.load_state_dict(convert.hift_state_from_jax(params), strict=True)
    return params, tm, (r".*/(conv_pre|conv_post)/v$",), None


@pytest.mark.parametrize("model", ["qwen2lm", "flow", "hift_wn_conv"])
def test_merge_matches_jax_on_a_converted_overlay(model):
    """The JAX package's merge_lora of a seeded overlay (nonzero b) against
    the port's merge_lora of the same overlay through
    convert.lora_overlay_from_jax, weight by weight: 1e-6 (the Qwen2 body's
    q/k/v/o, the flow conformer's attention projections and its FFNs' w_1
    (flax `w_1` is no list index), HiFT's weight-normed
    conv_pre / conv_post directions); every other weight unchanged; the
    port's own patterns select the same weights."""
    params, tm, jpat, names = _merge_case(model)
    cfg, ov = _jax_overlay(params, jpat, seed=11)
    want = convert.train_state_from_jax(
        "qwen2lm" if model == "qwen2lm" else model.split("_")[0],
        jlora.merge_lora(params, ov, cfg))
    base = {k: v.detach() for k, v in tm.named_parameters()}
    tov = convert.lora_overlay_from_jax(ov, list(base))
    assert len(tov) == len(ov) > 0
    got = tlora.merge_lora(base, tov, tlora.LoRAConfig(r=4, alpha=8))
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-6, err_msg=k)
        assert (k in tov) or torch.equal(v, base[k]), k
    if names is not None:
        mine = tlora.init_lora(tm, tlora.LoRAConfig(target_patterns=(
            tlora.target_pattern(names),)), torch.Generator())
        assert set(mine) == set(tov)


def test_lora_step_moves_only_the_overlay_as_jax():
    """One adam step of a LoRA train state (r 4, alpha 8, q/k/v/o) on the
    Qwen2LM: the JAX package's lora_loss_fn + make_train_step against the
    port's, from one overlay: loss and grad_norm 1e-5 relative, the
    overlay's a and b within 1e-5 (train_state_from_jax with lora_names);
    the port's base parameters bit-identical after the step, and b moved
    off 0 (so the merge is no longer the base)."""
    jm, params, tm = U.build_lm()
    jpat = (r".*/(q_proj|k_proj|v_proj|o_proj)/kernel$",)
    jcfg = jlora.LoRAConfig(r=4, alpha=8, target_patterns=jpat)
    jov = jlora.init_lora(params, jcfg, jax.random.PRNGKey(2))
    names = [k for k, _ in tm.named_parameters()]
    tcfg = tlora.LoRAConfig(r=4, alpha=8)
    overlay = tlora.LoRAOverlay(convert.lora_overlay_from_jax(
        {p: {k: np.asarray(v) for k, v in ab.items()} for p, ab in jov.items()}, names))
    b = _lm_batch(5)
    kw = dict(grad_clip=5.0, accum_grad=1)

    def jloss(p, batch, rng):
        out = jm.apply(p, batch["text_token"], batch["text_token_len"], batch["speech_token"],
                       batch["speech_token_len"])
        return out["loss"], {"acc": out["acc"]}

    jtx, _ = joptim.make_optimizer("adam", 1e-3, "constantlr", {}, **kw)
    jst = jstep.make_train_state(jov, jtx)
    jb = {k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in b.items()}
    jfn = jstep.make_train_step(jlora.lora_loss_fn(params, jloss, jcfg), jtx, donate=False)
    jst, jmet = quick_jit(jfn, jst, jb, U.KEY)(jst, jb, U.KEY)
    ttx, _ = toptim.make_optimizer("adam", 1e-3, "constantlr", {}, **kw)
    before = {k: v.detach().clone() for k, v in tm.named_parameters()}
    tst = tstep.make_train_state(overlay, ttx)
    assert set(tst.params) == {f"{ab}.{n.replace('.', '/')}" for n in
                               convert.lora_overlay_from_jax(jov, names) for ab in "ab"}
    tfn = tstep.make_train_step(tlora.lora_loss_fn(tm, tstep.llm_loss_fn, tcfg), ttx)
    tst, tmet = tfn(tst, b, torch.Generator().manual_seed(0))
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(tmet[key].item(), float(jmet[key]), rtol=1e-5)
    want = convert.train_state_from_jax("qwen2lm", jst.params, lora_names=names)
    for k, p in tst.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), atol=1e-5, err_msg=k)
    for k, v in tm.named_parameters():
        assert torch.equal(v, before[k]), k
    assert all(p.abs().max() > 0 for k, p in tst.params.items() if k.startswith("b."))


@pytest.mark.parametrize("model,kind", [("llm", "qwen2lm"), ("flow", "flow")])
def test_train_cli_lora(tmp_path, model, kind):
    """bin/train.py --lora (or lora_conf.enabled with the recipe's patterns)
    for the LM and the flow, one epoch: finite metrics; the checkpoint
    holds only the overlay; lora.npz holds a pair for each selected weight
    (q/k/v/o, or the flow recipe's linear_q / linear_v) with b off 0; the
    model's initial weights are never written."""
    lst = write_train_corpus(tmp_path, n=3)
    conf = {model: dict(train_section(kind), kind=kind),
            "data": {"filter": {"max_length": 99999, "token_max_length": 300},
                     "fbank": {"n_fft": 192, "hop": 48, "n_mels": 20},
                     "max_frames_in_batch": 1000, "shuffle_buf": 4, "sort_buf": 2},
            "train_conf": {"lr": 1e-3, "log_interval": 1, "scheduler": "constantlr",
                           "scheduler_conf": {"warmup_steps": 0}}}
    args = ["--lora"]
    if model == "flow":
        conf["lora_conf"] = {"enabled": True, "rank": 4, "alpha": 8,
                             "patterns": ["linear_q", "linear_v"]}
        args = []
    cfg = tmp_path / "c.yaml"
    cfg.write_text(yaml.safe_dump(conf, default_flow_style=False))
    model_dir = str(tmp_path / "exp")
    train_cli.main(["--config", str(cfg), "--model", model, "--train_data", lst, "--model_dir",
                    model_dir, "--epochs", "1", "--device", "cpu", *args])
    step = latest_step(model_dir)
    saved = torch.load(os.path.join(model_dir, str(step), "state.pt"), weights_only=True)
    assert saved["params"] and all(k[:2] in ("a.", "b.") for k in saved["params"])
    data = np.load(os.path.join(model_dir, "lora.npz"))
    a_keys = [k for k in data.files if k.endswith(".lora_A")]
    pats = ("linear_q", "linear_v") if model == "flow" else tuple(QKVO)
    assert a_keys and all(any(f".{p}." in k for p in pats) for k in a_keys)
    assert len(a_keys) == len(saved["params"]) // 2
    assert all(np.abs(data[k.replace("lora_A", "lora_B")]).max() > 0 for k in a_keys)


def _resave_llm(tmp_path, name: str, sd: dict, lora_npz: str, r: int, alpha: int) -> dict:
    torch.save(sd, tmp_path / f"{name}_in.pt")
    out = tmp_path / name
    ckpt_resave.main(["--out_dir", str(out), "--llm_pt", str(tmp_path / f"{name}_in.pt"),
                      "--lora_npz", lora_npz, "--lora_r", str(r), "--lora_alpha", str(alpha)])
    return torch.load(out / "llm.pt", weights_only=True)


def test_ckpt_resave_merges_port_and_jax_lora_npz(tmp_path):
    """ckpt_resave --lora_npz writes the LLM with the overlay merged: from
    the port's lora.npz (lora_state_dict of a trained-looking overlay) equal
    to the in-memory merge_lora exactly; from a JAX-written lora.npz (the
    JAX lora_state_dict of the same overlay under flax paths) within 1e-6
    of the JAX package's merge."""
    _, params, tm = U.build_lm()
    jpat = (r".*/(q_proj|k_proj|v_proj|o_proj)/kernel$",)
    jcfg, jov = _jax_overlay(params, jpat, seed=21, r=4)
    sd = {k: v.detach().clone() for k, v in tm.state_dict().items()}
    tov = convert.lora_overlay_from_jax(jov, list(sd))
    port_npz = str(tmp_path / "port_lora.npz")
    np.savez(port_npz, **tlora.lora_state_dict(tov))
    got = _resave_llm(tmp_path, "port", sd, port_npz, 4, 8)
    want = tlora.merge_lora(sd, tov, tlora.LoRAConfig(r=4, alpha=8))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    jax_npz = str(tmp_path / "jax_lora.npz")
    np.savez(jax_npz, **jlora.lora_state_dict(jov))
    got = _resave_llm(tmp_path, "jax", sd, jax_npz, 4, 8)
    want = convert.lm_state_from_jax(jlora.merge_lora(params, jov, jcfg))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-6, err_msg=k)
    with pytest.raises(ValueError, match="--llm_pt"):
        ckpt_resave.main(["--out_dir", str(tmp_path / "d"), "--lora_npz", port_npz])
