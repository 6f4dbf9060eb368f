"""The phoneme LMs' training in the port against the JAX package, on the CPU
at small widths: ops/delay's focal and VICReg losses, the training
forwards of the three Qwen2 phoneme LMs, the multi-code LM,
TransformerLMPhoneme and TransformerLMPhonemeWithSpk (its SpecAugment
masks and posterior samples pinned to the JAX draws), one train step of
the production Src2 LM, the online labeler (train/online_codec.py), and
bin/train.py's phoneme route on a speaker-JSON corpus with its refusals.
Both sides start from one seeded parameter tree (numpy draws over the JAX
init's shapes) carried into the port by convert.train_state_from_jax.
Each test states its bar."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import test_torch_speaker as S
import torch_port_util as U
from torch_port_util import one_torch_thread, quick_jit, random_params  # noqa: F401
from cosyvoice_tpu import config as jconfig
from cosyvoice_tpu.models import llm_phoneme as jpho
from cosyvoice_tpu.models import llm_v1_phoneme as jv1
from cosyvoice_tpu.models import s3tokenizer as js3
from cosyvoice_tpu.ops import delay as jdelay
from cosyvoice_tpu.train import optim as joptim
from cosyvoice_tpu.train import step as jstep
from cosyvoice_tpu.train.online_codec import OnlineCodecLabeler as JLabeler
from cosyvoice_tpu_torch import config as tconfig
from cosyvoice_tpu_torch import convert
from cosyvoice_tpu_torch.bin import train as train_cli
from cosyvoice_tpu_torch.bin.inference import write_wav
from cosyvoice_tpu_torch.models import llm_phoneme as tpho
from cosyvoice_tpu_torch.models import llm_v1_phoneme as tv1
from cosyvoice_tpu_torch.models import s3tokenizer as ts3
from cosyvoice_tpu_torch.models.conformer import ConformerConfig as TConformerConfig
from cosyvoice_tpu_torch.nn.dropout import dropout_generator
from cosyvoice_tpu_torch.ops import delay as tdelay
from cosyvoice_tpu_torch.train import optim as toptim
from cosyvoice_tpu_torch.train import step as tstep
from cosyvoice_tpu_torch.train.checkpoint import latest_step
from cosyvoice_tpu_torch.train.online_codec import OnlineCodecLabeler, random_crop_or_repeat
from cosyvoice_tpu_torch.utils import onnx_io as tonnx

KEY = jax.random.PRNGKey(0)
PHO_EMB = {"text_token_size": 8, "text_token_dim": 16, "text_tone_size": 16,
           "text_tone_dim": 8, "text_lang_size": 2, "text_lang_dim": 4,
           "text_prsd_size": 6, "text_prsd_dim": 4}
QWEN = {"vocab_size": 300, "hidden_size": 32, "num_layers": 1, "num_heads": 4,
        "num_kv_heads": 2, "head_dim": 8, "intermediate_size": 64}


def pho_section(dropout: float = 0.0, **over) -> dict:
    """tests/test_train_cli.py's phoneme LM widths (a 32-wide phoneme
    embedding, encoder, fusion and Qwen2 body, 24 speech ids)."""
    sec = {"llm_input_size": 32, "llm_output_size": 32, "speech_token_size": 24,
           "spk_embed_dim": 16, "phoneme": PHO_EMB,
           "encoder": {"input_size": 32, "dim": 32, "heads": 2, "linear_units": 48,
                       "num_blocks": 1, "dropout_rate": dropout,
                       "attention_dropout_rate": 0.0},
           "fusion_heads": 2, "fusion_ffn": 48, "qwen": QWEN}
    return json.loads(json.dumps(dict(sec, **over)))


def _t(x):
    a = np.asarray(x)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu" else a.copy())


def _pho_tokens(rng, B, T):
    return np.stack([rng.integers(0, PHO_EMB[f"text_{t}_size"], (B, T))
                     for t in ("token", "tone", "lang", "prsd")], axis=-1).astype(np.int32)


def _batch(seed: int = 0, codes: int = 0) -> dict:
    """Three ragged rows: text, factored phonemes, speech tokens (or
    `codes` codebooks of aligned codes), a speaker vector."""
    rng = np.random.default_rng(seed)
    tl, pl, sl = np.array([5, 3, 6]), np.array([7, 4, 9]), np.array([6, 4, 8])
    b = {"text_token": rng.integers(0, 300, (3, 6)).astype(np.int32),
         "text_token_len": tl.astype(np.int32),
         "pho_token": _pho_tokens(rng, 3, 9), "pho_token_len": pl.astype(np.int32),
         "speech_token": rng.integers(0, 24, (3, 8) + ((codes,) if codes else ()))
         .astype(np.int32),
         "speech_token_len": sl.astype(np.int32),
         "embedding": rng.standard_normal((3, 16)).astype(np.float32)}
    return b


ARGS = ("text_token", "text_token_len", "pho_token", "pho_token_len", "speech_token",
        "speech_token_len", "embedding")


def _models(kind: str, sec: dict, seed: int):
    """-> (jax module, its seeded params, the port module with them)."""
    jm, _ = jconfig.build_model(kind, sec)
    b = _batch()
    params = random_params(jm.init, KEY, *(jnp.asarray(b[k]) for k in ARGS), seed=seed)
    tm, _ = tconfig.build_model(kind, sec)
    tm.load_state_dict(convert.train_state_from_jax(kind, params), strict=True)
    return jm, params, tm


def _close_trees(got: dict, want: dict, atol: float, rtol: float) -> None:
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:6]
    for k in got:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(), atol=atol,
                                   rtol=rtol, err_msg=k)


# ---- the losses ------------------------------------------------------------

@pytest.mark.parametrize("gamma,masked", [(1.0, True), (2.0, False), (0.0, True)])
def test_focal_loss_matches_jax(gamma, masked):
    """focal_loss on seeded logits [2, 5, 3, 11] with a 0/1 mask (or none):
    1e-6 relative."""
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((2, 5, 3, 11)) * 3).astype(np.float32)
    tgt = rng.integers(0, 11, (2, 5, 3)).astype(np.int32)
    mask = (rng.random((2, 5, 3)) < 0.6).astype(np.float32) if masked else None
    want = jdelay.focal_loss(jnp.asarray(logits), jnp.asarray(tgt), gamma,
                             None if mask is None else jnp.asarray(mask))
    got = tdelay.focal_loss(torch.from_numpy(logits), _t(tgt), gamma,
                            None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("B,D", [(2, 5), (6, 16)])
def test_vicreg_loss_matches_jax(B, D):
    """vicreg_loss (ddof=1 variances, the off-diagonal covariance penalty)
    on seeded pairs, one of them scaled so the variance hinge binds: 1e-5
    relative."""
    rng = np.random.default_rng(B)
    x = rng.standard_normal((B, D)).astype(np.float32)
    y = (x * 0.3 + 0.2 * rng.standard_normal((B, D))).astype(np.float32)
    want = jdelay.vicreg_loss(jnp.asarray(x), jnp.asarray(y), 0.5, 0.4, 0.1)
    got = tdelay.vicreg_loss(torch.from_numpy(x), torch.from_numpy(y), 0.5, 0.4, 0.1)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


# ---- the Qwen2 phoneme LMs ---------------------------------------------------

PHO_CASES = {"qwen2lm_phoneme": {}, "qwen2lm_phoneme_src": {},
             "qwen2lm_phoneme_src2": {"lsm_weight": 0.1, "length_normalized_loss": False},
             "qwen2lm_phoneme-text_masked": {"text_emb_mask_prob": 1.0}}


@pytest.mark.parametrize("case", list(PHO_CASES))
def test_phoneme_lm_loss_matches_jax(case):
    """The training loss and accuracy of each Qwen2 phoneme LM against the
    JAX module's (loss 1e-5 relative, acc 1e-6): deterministic on both
    sides; and Qwen2LMPhoneme in a training step with text_emb_mask_prob 1
    (every text embedding zeroed: the JAX module with deterministic=False
    and an rng, the port in train() with a generator), where the loss must
    also differ from the deterministic one."""
    kind = case.split("-")[0]
    sec = pho_section(**PHO_CASES[case])
    jm, params, tm = _models(kind, sec, seed=3)
    b = _batch(1)
    masked = case.endswith("text_masked")

    def f(p, bb):
        out = jm.apply(p, *(bb[k] for k in ARGS), KEY, deterministic=not masked)
        return out["loss"], out["acc"]

    jb = {k: jnp.asarray(b[k]) for k in ARGS}
    loss_j, acc_j = quick_jit(f, params, jb)(params, jb)
    tb = {k: _t(b[k]) for k in ARGS}
    if masked:
        tm.train()
        gen = torch.Generator().manual_seed(0)
        with dropout_generator(gen):
            out = tm(*(tb[k] for k in ARGS), gen=gen)
        plain = tm.eval()(*(tb[k] for k in ARGS))
        assert abs(plain["loss"].item() - out["loss"].item()) > 1e-4
    else:
        out = tm.eval()(*(tb[k] for k in ARGS))
    np.testing.assert_allclose(out["loss"].item(), float(loss_j), rtol=1e-5)
    assert abs(out["acc"].item() - float(acc_j)) < 1e-6
    with pytest.raises(NotImplementedError, match="packed"):
        tm.packed_call()


def test_phoneme_lm_train_step_matches_jax():
    """Two adam steps (clip 5, warmuplr) of the production Src2 LM through
    make_train_step against the JAX package's jitted step from one init:
    each step's loss and grad_norm 1e-5 relative, then every parameter
    within 2 lr + 1e-5 of the JAX package's through train_state_from_jax,
    and all but 0.5% of them within 1e-5 (124 of 44,251 here): adam moves an
    element whose gradient is far below its eps (0 analytically for the
    attention key biases; 214 of the rel-pos projection's 1,024 have |g| <
    1e-7 at this init, the two packages' gradients within 3.3e-9) by up to
    lr in either package as its rounding falls (ROADMAP, known traps)."""
    kind = "qwen2lm_phoneme_src2"
    sec = pho_section()
    jm, params, tm = _models(kind, sec, seed=5)
    kw = dict(grad_clip=5.0, accum_grad=1)
    jtx, _ = joptim.make_optimizer("adam", 1e-3, "warmuplr", {"warmup_steps": 3}, **kw)
    ttx, _ = toptim.make_optimizer("adam", 1e-3, "warmuplr", {"warmup_steps": 3}, **kw)

    def jloss(p, batch, rng):
        out = jm.apply(p, *(batch[k] for k in ARGS), rng, deterministic=False,
                       rngs={"dropout": rng})
        return out["loss"], {"acc": out["acc"]}

    jst = jstep.make_train_state(params, jtx)
    jfn = jstep.make_train_step(jloss, jtx, donate=False)
    b0 = {k: jnp.asarray(v) for k, v in _batch(10).items()}
    jfn = quick_jit(jfn, jst, b0, KEY)
    tst = tstep.make_train_state(tm, ttx)
    tfn = tstep.make_train_step(tstep.phoneme_llm_loss_fn, ttx)
    for i in range(2):
        b = _batch(10 + i)
        jst, jmet = jfn(jst, {k: jnp.asarray(v) for k, v in b.items()}, KEY)
        tst, tmet = tfn(tst, tstep.to_device(b, "cpu"), torch.Generator().manual_seed(i))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(tmet[key].item(), float(jmet[key]), rtol=1e-5,
                                       err_msg=f"step {i} {key}")
    want = convert.train_state_from_jax(kind, jst.params)
    far = total = 0
    for k, p in tst.params.items():
        d = (p.detach() - want[k]).abs()
        assert d.max() <= 2e-3 + 1e-5, (k, float(d.max()))
        far, total = far + int((d > 1e-5).sum()), total + d.numel()
    assert far <= 5e-3 * total, (far, total)


def test_multicode_loss_matches_jax():
    """Qwen2LMPhonemeMultiCode's focal loss over the delayed codes and the
    trailing EOS row (3 codebooks, 2 fusion layers) against the JAX
    module's: 1e-5 relative; and its gradient reaches the code tables."""
    kind = "qwen2lm_phoneme_multicode"
    sec = pho_section(codebooknum=3, src_attn_layers=2)
    jm, _ = jconfig.build_model(kind, sec)
    b = _batch(2, codes=3)
    params = random_params(jm.init, KEY, *(jnp.asarray(b[k]) for k in ARGS), seed=7)
    tm, _ = tconfig.build_model(kind, sec)
    tm.load_state_dict(convert.train_state_from_jax(kind, params), strict=True)
    jb = {k: jnp.asarray(b[k]) for k in ARGS}
    want = quick_jit(lambda p, bb: jm.apply(p, *(bb[k] for k in ARGS))["loss"], params,
                     jb)(params, jb)
    out = tm.eval()(*(_t(b[k]) for k in ARGS))
    np.testing.assert_allclose(out["loss"].item(), float(want), rtol=1e-5)
    out["loss"].backward()
    assert tm.code_embeddings[2].weight.grad.abs().sum() > 0


V1_PHO = dict(text_token_size=30, text_token_dim=12, text_tone_size=16, text_tone_dim=8,
              text_lang_size=2, text_lang_dim=2, text_prsd_size=6, text_prsd_dim=2)
V1_TE = dict(dim=32, heads=4, linear_units=48, num_blocks=1, input_size=24,
             static_chunk_size=1, dropout_rate=0.0, attention_dropout_rate=0.0)
V1_BODY = dict(dim=32, heads=4, linear_units=48, num_blocks=1, input_size=32,
               static_chunk_size=1, input_layer="linear_legacy", activation="relu",
               dropout_rate=0.0, attention_dropout_rate=0.0)
V1_LM = dict(text_encoder_input_size=24, llm_input_size=32, llm_output_size=32,
             text_token_size=300, speech_token_size=24, spk_embed_dim=20)


def _v1_batch(seed: int):
    rng = np.random.default_rng(seed)
    pho = np.stack([rng.integers(0, V1_PHO[f"text_{t}_size"], (2, 9))
                    for t in ("token", "tone", "lang", "prsd")], axis=-1).astype(np.int32)
    return (pho, np.array([9, 6], np.int32), rng.integers(0, 24, (2, 7)).astype(np.int32),
            np.array([7, 5], np.int32))


def test_transformer_lm_phoneme_loss_matches_jax():
    """TransformerLMPhoneme's (spk_adapt on) loss and accuracy against the
    JAX module's: 1e-5 relative, acc 1e-6."""
    sec = dict(V1_LM, spk_adapt=True, phoneme=V1_PHO, text_encoder=V1_TE, llm=V1_BODY)
    jm, _ = jconfig.build_model("transformer_lm_phoneme", sec)
    pho, pl, sp, sl = _v1_batch(4)
    emb = np.random.default_rng(5).standard_normal((2, 20)).astype(np.float32)
    args = [jnp.asarray(a) for a in (pho, pl, sp, sl, emb)]
    params = random_params(jm.init, KEY, *args, seed=9)
    out_j = quick_jit(lambda p, *a: jm.apply(p, *a), params, *args)(params, *args)
    tm, _ = tconfig.build_model("transformer_lm_phoneme", sec)
    tm.load_state_dict(convert.train_state_from_jax("transformer_lm_phoneme", params),
                       strict=True)
    out = tm.eval()(*(_t(a) for a in (pho, pl, sp, sl, emb)))
    np.testing.assert_allclose(out["loss"].item(), float(out_j["loss"]), rtol=1e-5)
    assert abs(out["acc"].item() - float(out_j["acc"])) < 1e-6


def _jax_spec_augment_masks(rng, B, T, F, freq_mask=10, time_mask_frac=0.1, n_masks=2):
    """The JAX spec_augment's draws from `rng`, split in its order."""
    tmax = max(int(T * time_mask_frac), 1)
    out = []
    for _ in range(n_masks):
        kf0, kf1, kt0, kt1, rng = jax.random.split(rng, 5)
        draws = (jax.random.randint(kf0, (B, 1, 1), 0, max(F - freq_mask, 1)),
                 jax.random.randint(kf1, (B, 1, 1), 0, freq_mask + 1),
                 jax.random.randint(kt0, (B, 1, 1), 0, max(T - tmax, 1)),
                 jax.random.randint(kt1, (B, 1, 1), 0, tmax + 1))
        out.append(tuple(torch.from_numpy(np.array(d).reshape(B).astype(np.int64))
                         for d in draws))
    return out


def test_spec_augment_matches_jax():
    """spec_augment with the JAX draws pinned equals the JAX function's
    output exactly; drawn from a generator, it zeroes bands and spans
    within the bounds."""
    x = np.random.default_rng(6).standard_normal((3, 40, 33)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jv1.spec_augment(jnp.asarray(x), key))
    got = tv1.spec_augment(torch.from_numpy(x), masks=_jax_spec_augment_masks(key, 3, 40, 33))
    np.testing.assert_array_equal(got.numpy(), want)
    drawn = tv1.spec_augment(torch.from_numpy(x), torch.Generator().manual_seed(0)).numpy()
    assert ((drawn == 0) | (drawn == x)).all() and (drawn == 0).any()


def test_with_spk_loss_with_vicreg_matches_jax():
    """TransformerLMPhonemeWithSpk's training loss (the LM's CE on the clean
    speaker vector + VICReg against a SpecAugment'ed pass under no_grad)
    against the JAX module with deterministic=False and dropout rates 0:
    the posterior samples and the masks pinned to the JAX draws; loss and
    the VICReg term 1e-4 relative; the speaker embedding's parameters get
    gradients, its BatchNorm statistics stay as they were."""
    jcfg, tcfg = S._cfgs()
    jlm = jv1.V1PhonemeLMConfig(**V1_LM, phoneme=jpho.PhonemeEmbedConfig(**V1_PHO),
                                text_encoder=S.JConformerConfig(**V1_TE),
                                llm=S.JConformerConfig(**V1_BODY))
    jm = jv1.TransformerLMPhonemeWithSpk(jv1.WithSpkConfig(lm=jlm, spk=jcfg))
    pho, pl, sp, sl = _v1_batch(12)
    emb0 = jnp.zeros((2, 20))
    lm_params = random_params(jv1.TransformerLMPhoneme(jlm).init, KEY, jnp.asarray(pho),
                              jnp.asarray(pl), jnp.asarray(sp), jnp.asarray(sl), emb0, seed=13)
    spk = S._speaker()[0]
    variables = {"params": {"lm": lm_params["params"], "speaker_embed": spk["params"]},
                 "batch_stats": {"speaker_embed": spk["batch_stats"]}}
    fb, spec, lens = S._features(np.random.default_rng(14))
    rng = jax.random.PRNGKey(15)
    args = [jnp.asarray(a) for a in (pho, pl, sp, sl, fb, spec, lens)]
    out_j = quick_jit(lambda v, *a: jm.apply(v, *a, rng, deterministic=False), variables,
                      *args)(variables, *args)
    k_clean, k_aug, k_aug1, k_aug2 = jax.random.split(rng, 4)
    shape = (2, spec.shape[1], S.SMALL["inter_channels"])
    aug = {"fbank_masks": _jax_spec_augment_masks(k_aug1, 2, fb.shape[1], fb.shape[2]),
           "spec_masks": _jax_spec_augment_masks(k_aug2, 2, spec.shape[1], spec.shape[2]),
           "noise": torch.from_numpy(np.array(jax.random.normal(k_aug, shape)))}
    tm = tv1.TransformerLMPhonemeWithSpk(tv1.WithSpkConfig(
        lm=tv1.V1PhonemeLMConfig(**V1_LM, phoneme=tpho.PhonemeEmbedConfig(**V1_PHO),
                                 text_encoder=TConformerConfig(**V1_TE),
                                 llm=TConformerConfig(**V1_BODY)), spk=tcfg))
    tm.load_state_dict(convert.with_spk_state_from_jax(variables), strict=True)
    stats = {k: v.clone() for k, v in tm.state_dict().items() if "running" in k}
    tm.train()
    with dropout_generator(torch.Generator().manual_seed(0)):
        out = tm(*(_t(a) for a in (pho, pl, sp, sl, fb, spec, lens)),
                 noise=torch.from_numpy(np.array(jax.random.normal(k_clean, shape))), aug=aug)
    np.testing.assert_allclose(out["vicreg"].item(), float(out_j["vicreg"]), rtol=1e-4)
    np.testing.assert_allclose(out["loss"].item(), float(out_j["loss"]), rtol=1e-4)
    out["loss"].backward()
    assert tm.speaker_embed.gst.embeds[0].grad.abs().sum() > 0
    for k, v in tm.state_dict().items():
        if "running" in k:
            assert torch.equal(v, stats[k]), k


# ---- the online labeler -----------------------------------------------------

def test_online_labeler_matches_jax(tmp_path, monkeypatch):
    """OnlineCodecLabeler.label_batch on a padded batch of two chirps (24
    kHz; one shorter than the 0.5 s speaker crop, so it is tiled) against
    the JAX package's, from one speech_tokenizer_v2.onnx and one speaker
    state dict: speech tokens and lengths equal; the speaker vectors within
    1e-4 with each row's posterior sample pinned to the JAX draw (the JAX
    labeler takes the batch's key for every row); the crops from numpy
    generators of one seed."""
    variables = random_params(js3.S3TokenizerV2(js3.S3Config(**U.S3)).init, U.KEY,
                              jnp.zeros((1, 20, 128)), jnp.asarray([20]), seed=5)
    path = str(tmp_path / "speech_tokenizer_v2.onnx")
    tonnx.write_onnx_tensors(path, js3.s3tokenizer_state_dict(variables, js3.S3Config(**U.S3)))
    spk_vars, spk_t, _ = S._speaker()
    # the JAX labeler's speaker_embed, its model call jitted (eager flax
    # dispatches CAMPPlus op by op)
    jitted = {}
    orig = S.jspk.speaker_embed

    def speaker_embed(model, variables, wav, rng):
        jitted.setdefault(id(model), jax.jit(model.apply))
        stub = type("M", (), {"cfg": model.cfg, "apply": staticmethod(jitted[id(model)])})
        return orig(stub(), variables, wav, rng)

    monkeypatch.setattr(S.jspk, "speaker_embed", speaker_embed)
    jl = JLabeler(js3.S3TokenizerV2(js3.S3Config(**U.S3)),
                  js3.import_s3tokenizer_onnx(path, js3.S3Config(**U.S3)),
                  S.jspk.SpeakerEmbedding(S._cfgs()[0]), spk_vars, spk_crop_seconds=0.5)
    tl = OnlineCodecLabeler(ts3.import_s3tokenizer_onnx(path, ts3.S3Config(**U.S3), "cpu"),
                            spk_t, spk_crop_seconds=0.5)
    t = np.arange(24000) / 24000.0
    speech = np.zeros((2, 24000), np.float32)
    speech[0] = 0.3 * np.sin(2 * np.pi * (120 * t + 700 * t * t))
    speech[1, :7200] = (0.2 * np.sin(2 * np.pi * 300 * t[:7200])
                        + 0.05 * np.random.default_rng(2).standard_normal(7200))
    batch = {"speech": speech, "speech_len": np.array([24000, 7200], np.int32)}
    key = jax.random.PRNGKey(4)
    want = jl.label_batch(dict(batch), np.random.default_rng(0), key)
    frames = S.tspk.speaker_features(spk_t.cfg, np.zeros(12000, np.float32), "cpu")[1].shape[1]
    noise = torch.from_numpy(np.array(jax.random.normal(
        key, (1, frames, S.SMALL["inter_channels"]))))
    got = tl.label_batch(dict(batch), np.random.default_rng(0), spk_noise=[noise, noise])
    np.testing.assert_array_equal(got["speech_token"].numpy(), want["speech_token"])
    np.testing.assert_array_equal(got["speech_token_len"].numpy(), want["speech_token_len"])
    assert len(np.unique(want["speech_token"])) > 2
    np.testing.assert_allclose(got["embedding"].numpy(), want["embedding"], atol=1e-4)
    w = np.arange(5, dtype=np.float32)
    np.testing.assert_array_equal(random_crop_or_repeat(w, 12, np.random.default_rng(0)),
                                  np.tile(w, 3)[:12])


# ---- the train CLI's phoneme route -----------------------------------------

def write_spk_json_corpus(dirpath, sr: int = 24000) -> tuple:
    """tests/test_train_cli.py's speaker-JSON corpus: 2 speakers x 3
    utterances of ~1.2 s, phonemes with #1 / #3 marks, MFA durations, a
    16-d offline vector each; -> (shard list, phoneme table path)."""
    rng = np.random.default_rng(3)
    dict_path = dirpath / "pho2id.json"
    dict_path.write_text(json.dumps({"sil": 0, "n": 1, "i": 2, "h": 3, "ao": 4, "uo": 5,
                                     "m": 6}))
    corpus = {}
    for spk in ("spkA", "spkB"):
        utts = []
        for i in range(3):
            pho = ["sil", "n", "i3", "#1", "h", "ao3", "#3", "m", "uo2", "sil"]
            dur = [0.1, 0.12, 0.15, 0.0, 0.12, 0.18, 0.0, 0.12, 0.2, 0.1]
            n = int(sum(dur) * sr) + 480
            path = dirpath / f"{spk}_{i}.wav"
            write_wav(str(path), (rng.standard_normal(n) * 0.1).astype(np.float32), sr)
            utts.append({"utt": f"{spk}_{i}", "wav": str(path), "duration": n / sr,
                         "text": "ni hao", "phoneme": " ".join(pho), "durations": dur,
                         "embedding": rng.standard_normal(16).tolist()})
        corpus[spk] = utts
    (dirpath / "corpus.json").write_text(json.dumps(corpus))
    lst = dirpath / "train.list"
    lst.write_text(str(dirpath / "corpus.json") + "\n")
    return str(lst), str(dict_path)


def _pho_conf(tmp_path, dict_path: str, kind: str = "qwen2lm_phoneme_src2", llm=None,
              **extra) -> str:
    conf = {"llm": dict(pho_section(0.1), kind=kind, **(llm or {})),
            "s3": {"kind": "s3tokenizer", "dim": 32, "heads": 2, "layers": 1, "fsq_dim": 2},
            "data": {"sample_rate": 24000, "phoneme_dict": dict_path, "batch_size": 3,
                     "fbank": {"n_fft": 192, "hop": 48, "n_mels": 20},
                     "filter": {"max_length": 99999, "token_max_length": 300},
                     "shuffle_buf": 10, "sort_buf": 4},
            "train_conf": {"lr": 1e-4, "log_interval": 1,
                           "scheduler_conf": {"warmup_steps": 10}}, **extra}
    path = tmp_path / "pho.yaml"
    path.write_text(yaml.safe_dump(json.loads(json.dumps(conf)), default_flow_style=None,
                                   width=1000))
    return str(path)


@pytest.mark.parametrize("labels", ["random_s3", "checkpoints"])
def test_train_cli_phoneme_llm_spk_json(tmp_path, monkeypatch, labels):
    """The tiny qwen2lm_phoneme_src2 run of tests/test_train_cli.py through
    the port's CLI (speaker-JSON corpus, the prosody crop, factored ids,
    online speech-token labels): with a random frozen S3 tokenizer and the
    corpus's offline speaker vectors; or with --s3_ckpt (a
    speech_tokenizer_v2.onnx of the recipe's s3 width) and --spk_ckpt (a
    reference-named SpeakerEmbedding state dict for the recipe's `speaker`
    section, whose 20-d vectors replace the corpus's; 1 s crops).  Two steps with
    finite loss, acc and grad_norm, a checkpoint that a second run resumes
    from."""
    lst, dict_path = write_spk_json_corpus(tmp_path)
    args, extra, llm = [], {}, None
    if labels == "checkpoints":
        s3_cfg = ts3.S3Config(dim=32, heads=2, layers=1, fsq_dim=2)
        torch.manual_seed(0)
        onnx = str(tmp_path / "speech_tokenizer_v2.onnx")
        tonnx.write_onnx_tensors(onnx, ts3.s3tokenizer_state_dict(ts3.S3TokenizerV2(s3_cfg)))
        torch.save(S._speaker()[2], tmp_path / "speaker.pt")
        args = ["--s3_ckpt", onnx, "--spk_ckpt", str(tmp_path / "speaker.pt")]
        extra = {"speaker": dict(S.SMALL, kind="speaker_embedding", campplus=U.CAMP)}
        llm = {"spk_embed_dim": S.SMALL["speaker_emb_dim"]}
        build = train_cli.online_labeler

        def short_crops(*a, **k):     # 1 s speaker crops: 10 s ones take ~40 s on the CPU
            labeler = build(*a, **k)
            labeler.spk_crop_seconds = 1.0
            return labeler

        monkeypatch.setattr(train_cli, "online_labeler", short_crops)
    cfg = _pho_conf(tmp_path, dict_path, llm=llm, **extra)
    model_dir = str(tmp_path / "exp_pho")
    argv = ["--config", cfg, "--model", "llm", "--train_data", lst, "--model_dir", model_dir,
            "--data_format", "spk_json", "--epochs", "1", "--device", "cpu", *args]
    train_cli.main(argv)
    assert latest_step(model_dir) == 2
    train_cli.main(argv)
    recs = [json.loads(line) for line in open(os.path.join(model_dir, "metrics.jsonl"))]
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    for r in recs:
        assert all(np.isfinite(r[k]) for k in ("loss", "acc", "grad_norm")), r
    assert latest_step(model_dir) == 4


@pytest.mark.parametrize("kind,args,match", [
    ("qwen2lm_phoneme_multicode", [], "get_delay_pattern"),
    ("transformer_lm_phoneme", [], "other arguments"),
    ("transformer_lm_phoneme_with_spk", [], "other arguments"),
    ("qwen2lm_phoneme_src2", ["--lora"], "trains every parameter"),
    ("qwen2lm_phoneme", ["--data_format", "parquet"], "as jsonl"),
], ids=["multicode", "v1_phoneme", "with_spk", "lora", "parquet"])
def test_train_cli_refuses_what_the_jax_cli_does_not_train(tmp_path, kind, args, match):
    """Each raises NotImplementedError naming what the JAX CLI does there
    (its phoneme branch fails on these kinds, ignores --lora, reads
    parquet shards as jsonl)."""
    cfg = _pho_conf(tmp_path, "none.json", kind=kind)
    with pytest.raises(NotImplementedError, match=match) as e:
        train_cli.main(["--config", cfg, "--model", "llm", "--train_data", "x",
                        "--model_dir", str(tmp_path / "m"), "--device", "cpu", *args])
    assert "JAX CLI" in str(e.value)
