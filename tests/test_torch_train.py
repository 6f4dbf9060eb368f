"""The port's training path (cosyvoice_tpu_torch/train, ops/block_attention,
the models' training forwards, data/pipeline) against the JAX package, in
fp32 on the CPU, at the small widths of tests/test_train_cli.py's recipe.
Both sides start from one seeded parameter tree (numpy draws over the JAX
init's shapes), carried into the port by convert.train_state_from_jax, and
gradient trees are compared under the port's parameter names the same way.
Each test states its bar."""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_util import (one_torch_thread, quick_jit,  # noqa: F401 (autouse)
                             random_params, train_section)
from cosyvoice_tpu import config as jconfig
from cosyvoice_tpu.ops.block_attention import block_attention as jblock_attention
from cosyvoice_tpu.ops.masks import NEG_INF
from cosyvoice_tpu.train import optim as joptim
from cosyvoice_tpu.train import packing as jpacking
from cosyvoice_tpu.train import step as jstep
from cosyvoice_tpu_torch import config as tconfig
from cosyvoice_tpu_torch import convert
from cosyvoice_tpu_torch.models import llm as tllm
from cosyvoice_tpu_torch.models.flow import FlowDraws
from cosyvoice_tpu_torch.nn.dropout import dropout_generator
from cosyvoice_tpu_torch.ops.block_attention import block_attention, naive_attention
from cosyvoice_tpu_torch.train import checkpoint as tckpt
from cosyvoice_tpu_torch.train import optim as toptim
from cosyvoice_tpu_torch.train import packing as tpacking
from cosyvoice_tpu_torch.train import step as tstep

KEY = jax.random.PRNGKey(0)


def _t(x):
    a = np.asarray(x)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu" else a.copy())


def _grads(model, loss) -> dict:
    params = tstep.trainable_params(model)
    gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), gs)}


def _close_trees(got: dict, want: dict, atol: float, rtol: float) -> None:
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:6]
    for k in got:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(), atol=atol,
                                   rtol=rtol, err_msg=k)


# ---- block attention -------------------------------------------------------

def _ba_case(name: str):
    """q, k, v, bias (numpy) and the block size of one case."""
    rng = np.random.default_rng(11)
    B, H, KH, D = 2, 4, 2, 8
    T = S = 24
    block = 8
    hb = 1
    keep = np.tril(np.ones((T, S), bool))[None].repeat(B, 0)
    if name == "gqa_ragged_keys":           # S not a block multiple, per-head bias
        S, block, hb = 21, 8, H
        keep = np.ones((B, T, S), bool)
        keep[1, :, 15:] = False
    elif name == "packed_block_diagonal":   # two examples a row
        seg = np.array([[1] * 10 + [2] * 14, [1] * 16 + [2] * 5 + [0] * 3])
        keep = keep & (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] > 0)
    elif name == "fully_masked_row":
        keep = keep.copy()
        keep[0, 5] = False
    q = rng.standard_normal((B, H, T, D)).astype(np.float32)
    k = rng.standard_normal((B, KH, S, D)).astype(np.float32)
    v = rng.standard_normal((B, KH, S, D)).astype(np.float32)
    bias = np.where(keep[:, None], 0.0, NEG_INF).astype(np.float32)
    bias = np.broadcast_to(bias, (B, hb, T, S)).copy()
    bias += 0.1 * rng.standard_normal(bias.shape).astype(np.float32) * (bias == 0)
    return q, k, v, bias, block


BA_CASES = ["gqa_causal", "gqa_ragged_keys", "packed_block_diagonal", "fully_masked_row"]


@pytest.mark.parametrize("case", BA_CASES)
def test_block_attention_matches_jax(case):
    """Forward and the grads of q, k, v and the bias against the JAX op's
    custom VJP (one seeded cotangent): within 2e-5 absolute.  Where no row
    is fully masked, the port's op also equals its naive attention (2e-5)."""
    q, k, v, bias, block = _ba_case(case)
    scale = 1.0 / np.sqrt(q.shape[-1])
    dout = np.random.default_rng(12).standard_normal(q.shape).astype(np.float32)
    out_j, vjp = jax.vjp(lambda *a: jblock_attention(*a, scale, block), q, k, v, bias)
    grads_j = vjp(jnp.asarray(dout))
    xs = [torch.tensor(a, requires_grad=True) for a in (q, k, v, bias)]
    out = block_attention(*xs, scale, block)
    grads = torch.autograd.grad(out, xs, torch.from_numpy(dout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=2e-5)
    for name, g, gj in zip("qkvb", grads, grads_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(gj), atol=2e-5, err_msg=name)
    if case != "fully_masked_row":
        naive = naive_attention(*[torch.from_numpy(a) for a in (q, k, v, bias)], scale)
        np.testing.assert_allclose(out.detach().numpy(), naive.numpy(), atol=2e-5)


# ---- the LMs' losses -------------------------------------------------------

EXAMPLES = [(5, 7), (3, 4), (6, 9)]     # (text, speech) lengths


def _lm_examples(seed: int = 3):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 300, n).astype(np.int32),
             rng.integers(0, 128, s).astype(np.int32)) for n, s in EXAMPLES]


def _unpacked(examples):
    B = len(examples)
    Tt, Ts = max(len(t) for t, _ in examples), max(len(s) for _, s in examples)
    text, sp = np.zeros((B, Tt), np.int32), np.zeros((B, Ts), np.int32)
    for i, (t, s) in enumerate(examples):
        text[i, :len(t)], sp[i, :len(s)] = t, s
    return {"text_token": text, "text_token_len": np.array([len(t) for t, _ in examples],
                                                           np.int32),
            "speech_token": sp, "speech_token_len": np.array([len(s) for _, s in examples],
                                                             np.int32)}


def _packed(examples, row_len: int = 24):
    return {k: v for k, v in jpacking.pack_llm_examples(examples, row_len,
                                                        eos_token=128).items()
            if k != "n_tokens"}


@lru_cache(maxsize=None)
def _lm_params():
    jm, _ = jconfig.build_model("qwen2lm", train_section("qwen2lm"))
    b = _unpacked(_lm_examples())
    return random_params(jm.init, KEY, *(jnp.asarray(b[k]) for k in
                                         ("text_token", "text_token_len", "speech_token",
                                          "speech_token_len")), seed=21)


def _lm_sections(lsm: float, norm: bool, **qwen):
    return train_section("qwen2lm", lsm_weight=lsm, length_normalized_loss=norm, qwen=qwen)


def _port_lm(sec):
    tm, _ = tconfig.build_model("qwen2lm", sec)
    tm.load_state_dict(convert.train_state_from_jax("qwen2lm", _lm_params()), strict=True)
    return tm


def _jax_lm_call(jm, packed: bool):
    if packed:
        return lambda p, b: jm.apply(p, b["ids"], b["types"], b["positions"], b["seg"],
                                     b["target"], method=type(jm).packed_call)
    return lambda p, b: jm.apply(p, b["text_token"], b["text_token_len"], b["speech_token"],
                                 b["speech_token_len"])


def _jax_lm_value_and_grad(lsm: float, norm: bool, packed: bool, batch: dict):
    jm, _ = jconfig.build_model("qwen2lm", _lm_sections(lsm, norm))
    call = _jax_lm_call(jm, packed)

    def f(p, b):
        out = call(p, b)
        return out["loss"], out["acc"]

    vg = jax.value_and_grad(f, has_aux=True)
    return quick_jit(vg, _lm_params(), batch)(_lm_params(), batch)


def _port_lm_loss(tm, batch: dict, packed: bool):
    b = {k: _t(v) for k, v in batch.items()}
    if packed:
        return tm.packed_call(b["ids"], b["types"], b["positions"], b["seg"], b["target"])
    return tm(b["text_token"], b["text_token_len"], b["speech_token"], b["speech_token_len"])


# each value of each factor, and every (lsm, norm) pair once
LM_CASES = [(False, 0.0, True), (False, 0.1, False), (True, 0.1, True), (True, 0.0, False)]


@pytest.mark.parametrize("packed,lsm,norm", LM_CASES,
                         ids=[f"{'packed' if p else 'unpacked'}-lsm{l}-{'norm' if n else 'batch'}"
                              for p, l, n in LM_CASES])
def test_qwen2lm_loss_and_grads_match_jax(packed, lsm, norm):
    """Qwen2LM's training loss and accuracy (1e-5 relative) and its whole
    gradient tree (atol 1e-6, rtol 1e-4) against the JAX package's; and in
    the port packed equals unpacked (loss 1e-6 relative, acc exact)."""
    exs = _lm_examples()
    batch = _packed(exs) if packed else _unpacked(exs)
    (loss_j, acc_j), grads_j = _jax_lm_value_and_grad(
        lsm, norm, packed, {k: jnp.asarray(v) for k, v in batch.items()})
    tm = _port_lm(_lm_sections(lsm, norm))
    out = _port_lm_loss(tm, batch, packed)
    np.testing.assert_allclose(out["loss"].item(), float(loss_j), rtol=1e-5)
    assert abs(out["acc"].item() - float(acc_j)) < 1e-6
    want = {k: v for k, v in convert.train_state_from_jax("qwen2lm", grads_j).items()}
    _close_trees(_grads(tm, out["loss"]), want, atol=1e-6, rtol=1e-4)
    other = _port_lm_loss(tm, _unpacked(exs) if packed else _packed(exs), not packed)
    np.testing.assert_allclose(other["loss"].item(), out["loss"].item(), rtol=1e-6)
    assert other["acc"].item() == out["acc"].item()


@pytest.mark.parametrize("lsm,norm", [(0.0, True), (0.1, True), (0.0, False), (0.1, False)])
def test_masked_ce_loss_matches_jax(lsm, norm):
    """masked_ce_loss and masked_accuracy on seeded logits with ignored
    targets: 1e-6 relative."""
    from cosyvoice_tpu.models import llm as jllm

    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32) * 3
    target = rng.integers(-1, 11, (3, 7)).astype(np.int32)
    want = jllm.masked_ce_loss(jnp.asarray(logits), jnp.asarray(target), lsm, norm)
    got = tllm.masked_ce_loss(torch.from_numpy(logits), _t(target), lsm, norm)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(
        tllm.masked_accuracy(torch.from_numpy(logits), _t(target)).item(),
        float(jllm.masked_accuracy(jnp.asarray(logits), jnp.asarray(target))), rtol=1e-6)


ROUTES = {"remat_scores": dict(remat=True, remat_policy="scores"),
          "remat_all": dict(remat=True, remat_policy="all"),
          "block_attention": dict(block_attention=True, attention_block=8),
          "block_attention_remat_all": dict(block_attention=True, attention_block=8,
                                            remat=True, remat_policy="all")}


@pytest.mark.parametrize("route", list(ROUTES))
def test_lm_training_routes_match_naive(route):
    """The packed loss and gradient tree with remat (either policy) and with
    block attention against the plain route: loss 1e-6 relative, gradients
    atol 1e-6, rtol 1e-5."""
    batch = _packed(_lm_examples())
    base = _port_lm(_lm_sections(0.0, True))
    want_out = _port_lm_loss(base, batch, True)
    want = _grads(base, want_out["loss"])
    tm = _port_lm(_lm_sections(0.0, True, **ROUTES[route]))
    out = _port_lm_loss(tm, batch, True)
    np.testing.assert_allclose(out["loss"].item(), want_out["loss"].item(), rtol=1e-6)
    _close_trees(_grads(tm, out["loss"]), want, atol=1e-6, rtol=1e-5)


def test_quantized_lm_refuses_training():
    sec = train_section("qwen2lm", qwen={"quant": "int8"})
    tm, _ = tconfig.build_model("qwen2lm", sec)
    b = {k: _t(v) for k, v in _unpacked(_lm_examples()).items()}
    with pytest.raises(ValueError, match="quantized"):
        tm(b["text_token"], b["text_token_len"], b["speech_token"], b["speech_token_len"])


def _v1_batch():
    b = _unpacked(_lm_examples(9))
    b["embedding"] = np.random.default_rng(9).standard_normal((3, 512)).astype(np.float32)
    return b


def test_transformer_lm_loss_and_grads_match_jax():
    """The v1 TransformerLM's loss and accuracy (1e-5 relative) and gradient
    tree (atol 1e-6, rtol 1e-4) against the JAX package's, dropout off on
    both sides (JAX deterministic, the port in eval())."""
    jm, _ = jconfig.build_model("transformer_lm", train_section("transformer_lm"))
    b = _v1_batch()
    args = ("text_token", "text_token_len", "speech_token", "speech_token_len", "embedding")
    params = random_params(jm.init, KEY, *(jnp.asarray(b[k]) for k in args), seed=23)

    def f(p, *a):
        out = jm.apply(p, *a)
        return out["loss"], out["acc"]

    jargs = (params, *(jnp.asarray(b[k]) for k in args))
    (loss_j, acc_j), grads_j = quick_jit(jax.value_and_grad(f, has_aux=True), *jargs)(*jargs)
    tm, _ = tconfig.build_model("transformer_lm", train_section("transformer_lm"))
    tm.load_state_dict(convert.train_state_from_jax("transformer_lm", params), strict=True)
    tm.eval()
    out = tm(*(_t(b[k]) for k in args))
    np.testing.assert_allclose(out["loss"].item(), float(loss_j), rtol=1e-5)
    assert abs(out["acc"].item() - float(acc_j)) < 1e-6
    _close_trees(_grads(tm, out["loss"]),
                 convert.train_state_from_jax("transformer_lm", grads_j), atol=1e-6, rtol=1e-4)


# ---- the flows -------------------------------------------------------------

def _flow_batch(kind: str):
    rng = np.random.default_rng(31)
    B, T = 4, 10
    tok_len = np.array([10, 8, 6, 10], np.int32)
    if kind == "flow":
        Tf, feat_len = 2 * T, 2 * tok_len
    else:
        Tf, feat_len = 23, np.array([23, 19, 14, 21], np.int32)
    return {"speech_token": rng.integers(0, 128, (B, T)).astype(np.int32),
            "speech_token_len": tok_len,
            "speech_feat": rng.standard_normal((B, Tf, 20)).astype(np.float32),
            "speech_feat_len": feat_len,
            "embedding": rng.standard_normal((B, 512)).astype(np.float32)}


def _jax_flow_draws(rng, B: int, T: int, C: int, cfg_rate: float) -> dict:
    """The JAX flows' draws from `rng`, split in their order (the flow's
    __call__ splits cond_on, cond_len, cfm; compute_loss splits cfm into
    t, z, cfg)."""
    k_on, k_len, k_cfm = jax.random.split(rng, 3)
    k_t, k_z, k_cfg = jax.random.split(k_cfm, 3)
    return dict(use_cond=jax.random.bernoulli(k_on, 0.5, (B,)),
                frac=jax.random.uniform(k_len, (B,)),
                t=jax.random.uniform(k_t, (B, 1, 1), jnp.float32)[:, 0, 0],
                z=jax.random.normal(k_z, (B, T, C), jnp.float32),
                keep=jax.random.uniform(k_cfg, (B,)) > cfg_rate)


@pytest.mark.parametrize("kind", ["flow", "flow_v1"])
def test_flow_loss_and_grads_match_jax(kind):
    """CausalMaskedDiffWithXvec's and MaskedDiffWithXvec's training loss
    (1e-5 relative) and gradient tree (atol 1e-6, rtol 1e-4) against the
    JAX package's, with the JAX draws pinned (FlowDraws) and the conformer's
    dropout off on both sides; the draws cover conditioned and
    unconditioned rows and a CFG-dropped row."""
    sec = train_section(kind)
    jm, jcfg = jconfig.build_model(kind, sec)
    b = _flow_batch(kind)
    names = ("speech_token", "speech_token_len", "speech_feat", "speech_feat_len",
             "embedding")
    args = tuple(jnp.asarray(b[k]) for k in names)
    rng = jax.random.PRNGKey(1)
    params = random_params(jm.init, KEY, *args, rng, deterministic=True, seed=41)
    vg = jax.value_and_grad(lambda p, *a: jm.apply(p, *a, rng, deterministic=True)["loss"])
    loss_j, grads_j = quick_jit(vg, params, *args)(params, *args)
    B, C = b["speech_feat"].shape[0], jcfg.output_size
    T2 = b["speech_feat"].shape[1]
    d = _jax_flow_draws(rng, B, T2, C, jcfg.cfm.training_cfg_rate)
    assert 0 < int(d["use_cond"].sum()) < B and not bool(d["keep"].all())
    draws = FlowDraws(**{k: torch.from_numpy(np.array(v)) for k, v in d.items()})
    tm, _ = tconfig.build_model(kind, sec)
    tm.load_state_dict(convert.train_state_from_jax(kind, params), strict=True)
    tm.eval()
    loss = tm(*(_t(b[k]) for k in names), draws=draws)["loss"]
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    _close_trees(_grads(tm, loss), convert.train_state_from_jax(kind, grads_j), atol=1e-6,
                 rtol=1e-4)


def test_conformer_dropout_only_in_a_training_step():
    """The flow encoder at dropout 0.5: in train() mode under a generator
    the output changes and repeats with the generator's seed; in eval()
    mode, or with no generator open, it equals the plain forward exactly."""
    sec = train_section("flow", encoder={"dropout_rate": 0.5, "attention_dropout_rate": 0.5})
    torch.manual_seed(0)
    tm, _ = tconfig.build_model("flow", sec)
    x = torch.randn(2, 6, 32)
    lens = torch.tensor([6, 4])
    plain, _ = tm.encoder(x, lens)
    tm.train()
    out = lambda seed: tm.encoder(x, lens)[0] if seed is None else _with_gen(tm, x, lens, seed)
    assert torch.equal(out(None), plain)
    a, b = out(1), out(1)
    assert torch.equal(a, b) and not torch.allclose(a, plain)
    assert not torch.equal(a, out(2))
    tm.eval()
    assert torch.equal(_with_gen(tm, x, lens, 1), plain)


def _with_gen(tm, x, lens, seed):
    with dropout_generator(torch.Generator().manual_seed(seed)):
        return tm.encoder(x, lens)[0]


def test_fused_estimator_refuses_grad():
    """A grad-enabled estimator call on the K2/K3 route raises."""
    sec = train_section("flow", estimator={"fused_attention": True, "fused_norm": True,
                                           "approx_gelu": True})
    tm, _ = tconfig.build_model("flow", sec)
    b = {k: _t(v) for k, v in _flow_batch("flow").items()}
    with pytest.raises(RuntimeError, match="no backward"):
        tm(*b.values(), gen=torch.Generator().manual_seed(0))


# ---- the optimizer and the train step -------------------------------------

SCHEDULES = {"warmuplr": {"warmup_steps": 7}, "constantlr": {"warmup_steps": 5},
             "NoamHoldAnnealing": {"warmup_steps": 5, "hold_steps": 4, "min_lr": 1e-5},
             "CosineAnnealing": {"max_steps": 20, "warmup_steps": 4, "min_lr": 1e-5}}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_optax(name):
    """Each schedule against its JAX / optax counterpart over 30 steps: 1e-6
    relative."""
    js = joptim.SCHEDULERS[name](1e-3, **SCHEDULES[name])
    ts = toptim.SCHEDULERS[name](1e-3, **SCHEDULES[name])
    want = np.array([float(js(jnp.asarray(i))) for i in range(30)])
    got = np.array([float(ts(i)) for i in range(30)])
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("optim,accum", [("adam", 1), ("adamw", 3)])
def test_optimizer_matches_optax(optim, accum):
    """make_optimizer against the JAX package's optax chain on seeded
    gradients over 9 micro-steps, one of them NaN, the clip binding: params
    within 2e-7 after each, and the count of applied updates equal (a NaN
    step applies nothing; under accumulation it stays in the mean, as in
    optax, and no later update applies)."""
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 3), "b": (7,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(grad_clip=0.5, accum_grad=accum, weight_decay=0.1)
    jtx, _ = joptim.make_optimizer(optim, 1e-2, "warmuplr", {"warmup_steps": 3}, **kw)
    ttx, _ = toptim.make_optimizer(optim, 1e-2, "warmuplr", {"warmup_steps": 3}, **kw)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jtx.init(jp), ttx.init(tp)

    def jax_update(g, s, p):
        u, s = jtx.update(g, s, p)
        return optax.apply_updates(p, u), s

    jupd = quick_jit(jax_update, jp, js, jp)
    for i in range(9):
        g = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        if i == 4:
            g["a"][1, 2] = np.nan
        jp, js = jupd({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        ut, ts = ttx.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        if ut is not None:
            tp = {k: tp[k] + ut[k] for k in tp}
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=2e-7)
        inner = js.inner_opt_state if accum > 1 else js
        assert toptim.applied_updates(ts) == int(inner.inner_state[1][-1].count)


def _scaled_jax_loss(jm):
    def loss_fn(p, batch, rng):
        out = jm.apply(p, batch["text_token"], batch["text_token_len"],
                       batch["speech_token"], batch["speech_token_len"])
        return out["loss"] * batch["scale"], {"acc": out["acc"]}

    return loss_fn


def _scaled_port_loss(model, batch, gen):
    loss, metrics = tstep.llm_loss_fn(model, batch, gen)
    return loss * batch["scale"], metrics


STEP_CASES = {"adam_clip_nan": dict(optim="adam", accum=1, scales=(1.0, float("nan"), 1.0)),
              "adamw_accum2": dict(optim="adamw", accum=2, scales=(1.0,) * 6)}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_steps_match_jax(case):
    """make_train_step against the JAX package's jitted step from one
    init: each step's loss and grad_norm (1e-5 relative; NaN where the step's
    loss is scaled by NaN), then the params (atol 1e-5; adam's first updates
    are +-lr wherever a gradient is not tiny); the clip binds (grad_norm >
    0.05); the NaN step leaves params and the schedule's count as they
    were; with accum_grad 2, six micro-steps apply three updates."""
    c = STEP_CASES[case]
    jm, _ = jconfig.build_model("qwen2lm", _lm_sections(0.0, True))
    kw = dict(grad_clip=0.05, accum_grad=c["accum"], weight_decay=0.01)
    jtx, _ = joptim.make_optimizer(c["optim"], 1e-3, "warmuplr", {"warmup_steps": 3}, **kw)
    ttx, _ = toptim.make_optimizer(c["optim"], 1e-3, "warmuplr", {"warmup_steps": 3}, **kw)
    jst = jstep.make_train_state(_lm_params(), jtx)
    jfn = jstep.make_train_step(_scaled_jax_loss(jm), jtx, donate=False)
    example = dict(_unpacked(_lm_examples(100)), scale=np.float32(1.0))
    jfn = quick_jit(jfn, jst, {k: jnp.asarray(v) for k, v in example.items()}, KEY)
    tm = _port_lm(_lm_sections(0.0, True))
    tst = tstep.make_train_state(tm, ttx)
    tfn = tstep.make_train_step(_scaled_port_loss, ttx)
    for i, scale in enumerate(c["scales"]):
        b = dict(_unpacked(_lm_examples(100 + i % 2)), scale=np.float32(scale))
        jst, jm_ = jfn(jst, {k: jnp.asarray(v) for k, v in b.items()}, KEY)
        tst, tm_ = tfn(tst, tstep.to_device(dict(b, scale=np.asarray(scale, np.float32)),
                                            "cpu"), torch.Generator().manual_seed(i))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(tm_[key].item(), float(jm_[key]), rtol=1e-5,
                                       err_msg=f"step {i} {key}")
        if np.isfinite(scale):
            assert float(jm_["grad_norm"]) > 0.05
        _close_trees({k: p.detach() for k, p in tst.params.items()},
                     convert.train_state_from_jax("qwen2lm", jst.params), atol=1e-5, rtol=0)
    applied = sum(np.isfinite(c["scales"])) // c["accum"]
    assert toptim.applied_updates(tst.opt_state) == applied


def test_ema_matches_jax():
    """ema_init / ema_update over three updates against the JAX package's:
    1e-7."""
    from cosyvoice_tpu.train import ema as jema
    from cosyvoice_tpu_torch.train import ema as tema

    rng = np.random.default_rng(8)
    ps = [{"a": rng.standard_normal((3, 2)).astype(np.float32)} for _ in range(4)]
    js, ts = jema.ema_init(ps[0]), tema.ema_init({"a": torch.from_numpy(ps[0]["a"])})
    for p in ps[1:]:
        js = jema.ema_update(js, p, 0.9)
        ts = tema.ema_update(ts, {"a": torch.from_numpy(p["a"])}, 0.9)
    np.testing.assert_allclose(ts["a"].numpy(), np.asarray(js["a"]), atol=1e-7)


def test_mesh_refused():
    """A step on a mesh runs (one process: the 1 x 1 mesh, the same loss as
    without; more ranks: tests/test_torch_parallel.py); a data-parallel step
    over a loss without its denominator (a batch statistic) raises."""
    from cosyvoice_tpu_torch.parallel.mesh import Mesh, make_mesh

    b = tstep.to_device(_unpacked(_lm_examples()), "cpu")
    losses = []
    for mesh in (None, make_mesh()):
        tx = toptim.make_optimizer()[0]
        tm = _port_lm(_lm_sections(0.0, True))
        step = tstep.make_train_step(tstep.llm_loss_fn, tx, mesh=mesh)
        losses.append(float(step(tstep.make_train_state(tm, tx), b, None)[1]["loss"]))
    assert losses[0] == losses[1]
    stat = lambda m, batch, gen: (tstep.llm_loss_fn(m, batch)[0], {})  # noqa: E731
    tx = toptim.make_optimizer()[0]
    step = tstep.make_train_step(stat, tx, mesh=Mesh(data=2))
    with pytest.raises(NotImplementedError, match="denominator"):
        step(tstep.make_train_state(_port_lm(_lm_sections(0.0, True)), tx), b,
             torch.Generator().manual_seed(0))


# ---- checkpoints -----------------------------------------------------------

def test_checkpoint_resume_equals_unbroken_run(tmp_path):
    """Two steps, save, a fresh model restored from the checkpoint, two
    more steps: params and optimizer state equal to four unbroken steps
    (exactly); latest_step finds the step; average_checkpoints of steps 2
    and 4 is their mean (float64 accumulation; 1e-7)."""
    tx, _ = toptim.make_optimizer("adam", 1e-3, "warmuplr", {"warmup_steps": 3}, accum_grad=1)
    fn = tstep.make_train_step(tstep.llm_loss_fn, tx)
    batches = [tstep.to_device(_unpacked(_lm_examples(200 + i)), "cpu") for i in range(4)]

    def run(state, idx):
        for i in idx:
            state, _ = fn(state, batches[i], tstep.step_generator(7, i, "cpu"))
        return state

    unbroken = run(tstep.make_train_state(_port_lm(_lm_sections(0.0, True)), tx), range(4))
    d = str(tmp_path / "ckpt")
    first = run(tstep.make_train_state(_port_lm(_lm_sections(0.0, True)), tx), range(2))
    tckpt.save_checkpoint(d, first, 2, {"epoch": 0})
    at2 = {k: p.detach().clone() for k, p in first.params.items()}
    assert tckpt.latest_step(d) == 2
    fresh = tstep.make_train_state(_port_lm(_lm_sections(0.0, True)), tx)
    fresh, step = tckpt.restore_checkpoint(d, fresh)
    assert step == 2 and fresh.step == 2
    resumed = run(fresh, range(2, 4))
    for k, p in unbroken.params.items():
        assert torch.equal(p, resumed.params[k]), k
    assert toptim.applied_updates(resumed.opt_state) == 4
    tckpt.save_checkpoint(d, resumed, 4)
    assert tckpt.latest_step(d) == 4 and (tmp_path / "ckpt" / "info_4.json").exists()
    avg = tckpt.average_checkpoints(d, last_n=2)
    for k, p in resumed.params.items():
        np.testing.assert_allclose(avg[k].numpy(), ((at2[k].double() + p.detach().double())
                                                    / 2).float().numpy(), atol=1e-7)


# ---- the data pipeline and packing ----------------------------------------

def _samples(n: int = 6, seed: int = 0):
    """Seeded utterances of two lengths (0.6 s and 1.2 s; a 16 kHz one and
    a loud one among them): few shapes, so the JAX side's eager log-mel
    compiles each op a few times only."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        sr = 16000 if i == 2 else 24000
        dur = int(sr * (0.6 if i % 2 else 1.2))
        yield {"utt": f"u{i}", "text": "hello world " * int(rng.integers(1, 4)),
               "speech": (rng.standard_normal(dur) * 0.1).astype(np.float32)
               * (8.0 if i == 4 else 1.0),
               "sample_rate": sr, "speech_token": rng.integers(0, 100, dur // 960),
               "embedding": rng.standard_normal(16).astype(np.float32)}


@pytest.mark.parametrize("batching", ["dynamic", "static"])
def test_pipeline_batches_match_jax(batching):
    """The port's pipeline (filter, resample of a 16 kHz sample, peak
    normalization of a loud one, fbank, tokenize, shuffle, sort, batch,
    pad) against the JAX package's on the same seeded samples, batch by
    batch and key by key: ids, lengths and embeddings exact, the mel
    within 1e-4."""
    from cosyvoice_tpu.data import pipeline as jpp
    from cosyvoice_tpu.tokenizer.text import ByteTokenizer as JByte
    from cosyvoice_tpu_torch.data import pipeline as tpp
    from cosyvoice_tpu_torch.tokenizer.text import ByteTokenizer as TByte

    def stages(pp, tok):
        batcher = (pp.dynamic_batch(max_frames_in_batch=300) if batching == "dynamic"
                   else pp.static_batch(4))
        return [pp.filter_samples(), pp.resample(24000), pp.compute_fbank(), pp.tokenize(tok),
                pp.shuffle(4, seed=1), pp.sort_by_feat_len(3), batcher, pp.padding()]

    want = list(jpp.Pipeline(_samples(), *stages(jpp, JByte())))
    got = list(tpp.Pipeline(_samples(), *stages(tpp, TByte())))
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        assert set(g) == set(w) and g["utts"] == w["utts"]
        for k in w:
            if k == "speech_feat":
                np.testing.assert_allclose(g[k], w[k], atol=1e-4)
            elif k != "utts":
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_packing_matches_jax():
    """pack_llm_examples equal to the JAX package's, array by array."""
    rng = np.random.default_rng(4)
    exs = [(rng.integers(0, 300, n), rng.integers(0, 128, s))
           for n, s in [(5, 7), (3, 4), (6, 9), (2, 3), (9, 20)]]
    want = jpacking.pack_llm_examples(exs, 40, eos_token=128, n_rows=3)
    got = tpacking.pack_llm_examples(exs, 40, eos_token=128, n_rows=3)
    assert got["n_tokens"] == want["n_tokens"]
    for k in ("ids", "types", "positions", "seg", "target"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
