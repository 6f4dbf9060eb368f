"""The incremental streaming flow of the port against the JAX package and
against the port's own one-shot stream-masked flow: the anchored chunk masks
(exact), every `.chunk` / `chunk_decode` step (2e-5 in fp32), `flow_chunk`
driven through FlowSlotEngine over two interleaved rows (2e-4 against the
JAX FlowSlotEngine, the bar ROADMAP gives the incremental flow) and the
chunked mel against `inference(streaming=True, chunk_anchor=...)` (2e-4, as
tests/test_flow_incremental.py holds the JAX package).  The configuration is
tests/test_flow_incremental.py's; inputs come from seeded numpy generators."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_port_util as U
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)
from cosyvoice_tpu.models import conformer as jconf
from cosyvoice_tpu.models import flow as jflow
from cosyvoice_tpu.models import flow_chunk as JFC
from cosyvoice_tpu.ops import masks as jmasks
from cosyvoice_tpu.runtime import flow_engine as JFE
from cosyvoice_tpu_torch import convert
from cosyvoice_tpu_torch.models import conformer as tconf
from cosyvoice_tpu_torch.models import flow as tflow
from cosyvoice_tpu_torch.models import flow_chunk as FC
from cosyvoice_tpu_torch.ops import masks as tmasks
from cosyvoice_tpu_torch.runtime import flow_engine as TFE

ENC = dict(dim=16, heads=2, linear_units=32, num_blocks=2, input_size=16, static_chunk_size=4)
EST = dict(in_channels=32, out_channels=8, n_blocks=1, num_mid_blocks=2, num_heads=2,
           attention_head_dim=4, static_chunk_size=8, stream=True, left_chunks=1)
COMMON = dict(input_size=16, output_size=8, spk_embed_dim=12, vocab_size=50,
              token_mel_ratio=2, pre_lookahead_len=3)
JCFG = jflow.FlowConfig(**COMMON, encoder=jconf.ConformerConfig(
    **ENC, dropout_rate=0.0, attention_dropout_rate=0.0), cfm=jflow.CFMConfig(n_timesteps=4),
    estimator=jflow.EstimatorConfig(**EST, causal=True, channels=(16,)))
TCFG = tflow.FlowConfig(**COMMON, encoder=tconf.ConformerConfig(**ENC),
                        cfm=tflow.CFMConfig(n_timesteps=4),
                        estimator=tflow.EstimatorConfig(**EST, causal=True, channels=(16,)))
HOP, LA, TOK_CAP = 4, 3, 64


@pytest.fixture(scope="module")
def flows():
    """(JAX model, its params, port model) on one set of numpy-drawn weights."""
    jm = jflow.StreamMaskedDiffWithXvec(JCFG)
    params = U.random_params(jm.init, U.KEY, jnp.zeros((1, 8), jnp.int32), jnp.asarray([8]),
                             jnp.zeros((1, 4, 8)), jnp.zeros((1, 12)),
                             method=jflow.CausalMaskedDiffWithXvec.inference, seed=4)
    tm = tflow.CausalMaskedDiffWithXvec(TCFG)
    tm.load_state_dict(convert.flow_state_from_jax(params), strict=True)
    return jm, params, tm.eval()


@pytest.mark.parametrize("chunk,left", [(4, -1), (4, 1), (3, 2), (8, 0)])
def test_anchored_chunk_masks_match_jax(chunk, left):
    """anchored_chunk_ids and anchored_chunk_mask equal the JAX ones exactly,
    for per-row and scalar anchors."""
    rng = np.random.default_rng(chunk + 10 * (left + 1))
    T = 29
    pad = np.arange(T)[None, :] < rng.integers(1, T + 1, 3)[:, None]
    for anchors in ([0, 5, 11], 7):
        want = jmasks.anchored_chunk_mask(jnp.asarray(pad), chunk, jnp.asarray(anchors), left)
        got = tmasks.anchored_chunk_mask(torch.as_tensor(pad), chunk, torch.tensor(anchors),
                                         left)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pos = rng.integers(0, 40, (3, 9))
    anchor = rng.integers(0, 12, (3, 1))
    np.testing.assert_array_equal(
        tmasks.anchored_chunk_ids(torch.as_tensor(pos), torch.as_tensor(anchor), chunk).numpy(),
        np.asarray(jmasks.anchored_chunk_ids(jnp.asarray(pos), jnp.asarray(anchor), chunk)))


def _chunk_case(name, tm, rng):
    """(JAX method on the bound flow model, port callable, numpy inputs)."""
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    B, M = 2, 5
    enc, est = tm.encoder, tm.decoder.estimator
    if name in ("rel_pos_chunk_decode", "conformer_layer_chunk"):
        Tcap = 12
        pos = np.asarray([0, 4])
        valid = np.arange(Tcap)[None, None, :] < (pos + np.asarray([5, 3]))[:, None, None]
        bias = np.where(valid & (np.arange(M)[None, :, None] >= 0), 0.0, -1e9).astype(np.float32)
        args = (f(B, M, 16), f(B, Tcap, 2, 8), f(B, Tcap, 2, 8), pos, bias)
        if name == "rel_pos_chunk_decode":
            return (lambda m, *a: m.encoder.encoders[0].self_attn.chunk_decode(*a),
                    lambda x, k, v, p, b: (enc.encoders[0].self_attn.chunk_decode(
                        x, k, v, p, b), k, v), args)
        return (lambda m, *a: m.encoder.encoders[1].chunk(*a),
                lambda x, k, v, p, b: (enc.encoders[1].chunk(x, k, v, p, b), k, v), args)
    if name == "pre_lookahead_chunk":
        return (lambda m, *a: m.encoder.pre_lookahead_layer.chunk(*a),
                enc.pre_lookahead_layer.chunk, (f(B, M, 16), f(B, M + LA, 16), f(B, 2, 16)))
    if name == "upsample_chunk":
        return (lambda m, *a: m.encoder.up_layer.chunk(*a), enc.up_layer.chunk,
                (f(B, M, 16), f(B, 2, 16)))
    mask = (np.arange(2 * M)[None, :] < np.asarray([10, 7])[:, None]).astype(np.float32)
    if name == "block1d_chunk":
        return (lambda m, *a: m.decoder.estimator.final_block.chunk(*a), est.final_block.chunk,
                (f(B, 2 * M, 16), mask, f(B, 2, 16)))
    if name == "resnet_chunk":
        return (lambda m, *a: m.decoder.estimator.mid_resnets[1].chunk(*a),
                est.mid_blocks[1][0].chunk,
                (f(B, 2 * M, 16), mask, f(B, 64), f(B, 2, 16), f(B, 2, 16)))
    R, N = 6, 2 * M
    keys = np.concatenate([np.arange(R)[None, :] >= np.asarray([0, 3])[:, None],
                           mask > 0], axis=1)
    bias = np.where(keys[:, None, :] & (np.arange(N)[None, :, None] >= 0), 0.0,
                    -1e9).astype(np.float32)
    return (lambda m, *a: m.decoder.estimator.up_tbs[0][0].chunk(*a),
            est.up_blocks[0][1][0].chunk, (f(B, N, 16), f(B, R, 2, 8), bias))


@pytest.mark.parametrize("name", ["rel_pos_chunk_decode", "conformer_layer_chunk",
                                  "pre_lookahead_chunk", "upsample_chunk", "block1d_chunk",
                                  "resnet_chunk", "dit_block_chunk"])
def test_chunk_steps_match_jax(flows, name):
    """Each incremental step against its JAX twin on the same inputs, every
    output (and the caches the port writes in place) within 2e-5."""
    jm, params, tm = flows
    jfn, tfn, args = _chunk_case(name, tm, np.random.default_rng(len(name)))
    want = jm.apply(params, *map(jnp.asarray, args), method=jfn)
    with torch.no_grad():
        got = tfn(*(torch.from_numpy(np.array(a)) for a in args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=2e-5)


def _streams(seed=0):
    """Two rows: prompts of 3 and 4 tokens (off the grid), 11 and 8 generated
    tokens, their prompt mels and speaker vectors, and the pinned noise."""
    rng = np.random.default_rng(seed)
    rows = []
    for P, G in ((3, 11), (4, 8)):
        rows.append(dict(pt=rng.integers(1, 50, P).astype(np.int32),
                         gt=rng.integers(1, 50, G).astype(np.int32),
                         pf=(rng.standard_normal((2 * P, 8)) * 0.3).astype(np.float32),
                         emb=rng.standard_normal(12).astype(np.float32)))
    noise = rng.standard_normal((1, 200, 8)).astype(np.float32)
    return rows, noise


def _slot_jobs(rows):
    """The chunk calls of two interleaved streams: the first chunk of both,
    then each later chunk of one row at a time (row 1 first), as the
    continuous server issues them.  -> [(slots, tokens, ctx, ctx_len, n_valid,
    first, pfeat, pfl)]."""
    jobs = []
    Pmax = max(len(r["pt"]) for r in rows)
    tok = np.zeros((2, Pmax + HOP), np.int32)
    ctx, cl, nv = np.zeros((2, LA), np.int32), np.zeros(2, np.int32), np.zeros(2, np.int32)
    pf = np.zeros((2, 2 * Pmax, 8), np.float32)
    pfl = np.zeros(2, np.int32)
    for b, r in enumerate(rows):
        row = np.concatenate([r["pt"], r["gt"][:HOP]])
        tok[b, :len(row)], nv[b] = row, len(row)
        c = r["gt"][HOP:HOP + LA]
        ctx[b, :len(c)], cl[b] = c, len(c)
        pf[b, :len(r["pf"])], pfl[b] = r["pf"], len(r["pf"])
    jobs.append(([0, 1], tok, ctx, cl, nv, True, pf, pfl))
    for s in range(HOP, max(len(r["gt"]) for r in rows), HOP):
        for b in (1, 0):
            g = rows[b]["gt"]
            if s >= len(g):
                continue
            take = g[s:s + HOP]
            t = np.zeros((1, HOP), np.int32)
            t[0, :len(take)] = take
            c = g[s + HOP:s + HOP + LA]
            cx = np.zeros((1, LA), np.int32)
            cx[0, :len(c)] = c
            jobs.append(([b], t, cx, np.asarray([len(c)]), np.asarray([len(take)]), False,
                         None, None))
    return jobs


def _run_slots(engine, rows, starts_at=None):
    """Drive `engine` (JAX or port FlowSlotEngine) through _slot_jobs; ->
    each row's generated mel, concatenated."""
    out = [[], []]
    for slots, tok, ctx, cl, nv, first, pf, pfl in _slot_jobs(rows):
        mel = np.asarray(engine.chunk(slots, tok, ctx, cl, nv, first, pf, pfl,
                                      ragged=bool(first or (nv != HOP).any())))
        for i, s in enumerate(slots):
            lo = 2 * len(rows[s]["pt"]) if first else 0
            out[s].append(mel[s, lo:2 * nv[i]])
    return [np.concatenate(o) for o in out]


def test_flow_slot_engine_matches_jax(flows):
    """FlowSlotEngine over two interleaved rows (a joint first chunk, then
    single-row chunks, ragged last chunks): the port's mel within 2e-4 of the
    JAX FlowSlotEngine's on the same weights and noise."""
    jm, params, tm = flows
    rows, noise = _streams()
    got_engine = TFE.FlowSlotEngine(tm, 2, TOK_CAP, torch.from_numpy(noise), 12, device="cpu")
    want_engine = JFE.FlowSlotEngine(jm, params, 2, TOK_CAP, noise, spk_dim=12)
    for b, r in enumerate(rows):
        assert got_engine.admit(len(r["pt"]), r["emb"]) == want_engine.admit(
            len(r["pt"]), r["emb"]) == b
    got, want = _run_slots(got_engine, rows), _run_slots(want_engine, rows)
    for b in range(2):
        assert got[b].shape == (2 * len(rows[b]["gt"]), 8)
        np.testing.assert_allclose(got[b], want[b], atol=2e-4, rtol=1e-3, err_msg=f"row {b}")


def test_incremental_matches_one_shot(flows):
    """The port's chunked mel against its own one-shot stream-masked flow on
    the anchored grid with the same finite left context (2e-4 / 1e-3)."""
    _, _, tm = flows
    rows, noise = _streams(1)
    engine = TFE.FlowSlotEngine(tm, 2, TOK_CAP, torch.from_numpy(noise), 12, device="cpu")
    for r in rows:
        engine.admit(len(r["pt"]), r["emb"])
    got = _run_slots(engine, rows)
    T = max(len(r["pt"]) + len(r["gt"]) for r in rows)
    tok = np.zeros((2, T), np.int64)
    pf = np.zeros((2, 2 * max(len(r["pt"]) for r in rows), 8), np.float32)
    for b, r in enumerate(rows):
        seq = np.concatenate([r["pt"], r["gt"]])
        tok[b, :len(seq)] = seq
        pf[b, :len(r["pf"])] = r["pf"]
    pfl = [len(r["pf"]) for r in rows]
    with torch.no_grad():
        mel = tm.inference(torch.from_numpy(tok), torch.tensor([len(r["pt"]) + len(r["gt"])
                                                                for r in rows]),
                           torch.from_numpy(pf), torch.from_numpy(np.stack([r["emb"]
                                                                           for r in rows])),
                           n_timesteps=4, noise=torch.from_numpy(noise[:, :2 * T]),
                           streaming=True, prompt_feat_len=torch.tensor(pfl),
                           chunk_anchor=torch.tensor([len(r["pt"]) for r in rows])).numpy()
    for b, r in enumerate(rows):
        want = mel[b, pfl[b]:pfl[b] + 2 * len(r["gt"])]
        np.testing.assert_allclose(got[b], want, atol=2e-4, rtol=1e-3, err_msg=f"row {b}")


def test_reset_rows_matches_jax():
    """reset_rows zeroes the state of the streams whose keep flag is False
    (both CFG rows of the estimator's), as the JAX function does."""
    rng = np.random.default_rng(6)
    state = FC.init_state(TCFG, 3, 8)
    for name in ("enc_k", "enc_v", "up_k", "up_v", "pre_hist", "ups_hist", "est_kv"):
        getattr(state, name).copy_(torch.from_numpy(rng.standard_normal(
            getattr(state, name).shape).astype(np.float32)))
    for v in state.est_conv.values():
        v.copy_(torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32)))
    state.tok_pos[:], state.anchor[:] = torch.tensor([5, 6, 7]), torch.tensor([1, 2, 3])
    jstate = JFC.init_state(JCFG, 3, 8)._replace(
        **{k: jnp.asarray(getattr(state, k).numpy()) for k in JFC.FlowChunkState._fields
           if k != "est_conv"},
        est_conv={k: jnp.asarray(v.numpy()) for k, v in state.est_conv.items()})
    keep = np.asarray([True, False, True])
    want = JFC.reset_rows(jstate, jnp.asarray(keep))
    got = FC.reset_rows(state, torch.from_numpy(keep))
    for k in JFC.FlowChunkState._fields:
        if k == "est_conv":
            for name, v in got.est_conv.items():
                np.testing.assert_array_equal(v.numpy(), np.asarray(want.est_conv[name]))
        else:
            np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)))


def test_incremental_flow_refusals(flows):
    """A left window wider than the first hop (not exact), a non-stream
    estimator and a prompt that fills the slot's cache all raise."""
    import dataclasses

    _, _, tm = flows
    wide = dataclasses.replace(TCFG, input_frame_rate=1, estimator=dataclasses.replace(
        TCFG.estimator, left_chunks=2))
    with pytest.raises(ValueError, match="first hop"):
        FC.init_state(wide, 1, TOK_CAP)
    with pytest.raises(ValueError, match="stream estimator"):
        FC.init_state(dataclasses.replace(TCFG, estimator=dataclasses.replace(
            TCFG.estimator, stream=False)), 1, TOK_CAP)
    engine = TFE.FlowSlotEngine(tm, 1, 16, np.zeros((1, 100, 8), np.float32), 12,
                                device="cpu")
    with pytest.raises(ValueError, match="tok_cap"):
        engine.admit(16, np.zeros(12, np.float32))
