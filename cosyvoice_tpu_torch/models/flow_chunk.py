"""Incremental streaming flow: token chunks -> mel chunks with cached state.

Port of cosyvoice_tpu/models/flow_chunk.py.  The windowed streaming path
re-runs the flow encoder and the 10-step CFM over the prompt and a window of
context to emit one hop; here every mel row is computed once, each chunk
running only its new rows against cached left-context state:
  * flow encoder: per-layer K/V caches at token and mel rate
    (RelPositionAttention.chunk_decode takes the espnet rel-pos skew at a
    per-row offset) and 2-row conv histories for the pre-lookahead and
    upsample convs;
  * CFM estimator (stream config): per-Euler-step, per-DiT-block K/V of the
    last `left_chunks * static_chunk_size` mel rows and 2-row histories for
    every causal conv.  Chunk-causal masks make each row's Euler trajectory
    independent of later rows, so per-chunk completion is exact.

Chunked output equals the one-shot stream-masked model
(`inference(streaming=True, chunk_anchor=...)` with the same finite
`left_chunks`) to fp tolerance, on a chunk grid anchored at the
prompt/generation boundary (ops/masks.anchored_chunk_ids).  That holds only
while the estimator's left window never reaches back into the prompt after
the first chunk, i.e. left_chunks * static_chunk_size <= ratio * hop mel
rows; `init_state` raises otherwise.

The state is a dataclass of tensors that `flow_chunk` updates in place (the
JAX package returns a new state); the encoder's K/V writes skip pad rows
past the cache instead of clamping, and a chunk whose valid rows do not fit
raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from cosyvoice_tpu_torch.models.flow import _DTYPES, cosine_t_span
from cosyvoice_tpu_torch.ops.masks import NEG_INF, anchored_chunk_ids


def tail_rows(full: torch.Tensor, shift: torch.Tensor, rows: int) -> torch.Tensor:
    """Rows [shift_b, shift_b + rows) of full [B, H + N, ...] per row b."""
    idx = shift.to(full.device).long()[:, None] + torch.arange(rows, device=full.device)
    return full[torch.arange(full.shape[0], device=full.device)[:, None], idx]


def roll_rows(cache: torch.Tensor, new: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """The stream's most recent R valid rows: per row, rows [shift_b, shift_b
    + R) of [cache ++ new] (cache [B, R, ...]; new [B, N, ...] with rows >=
    shift_b pad)."""
    return tail_rows(torch.cat([cache, new.to(cache.dtype)], dim=1), shift, cache.shape[1])


@dataclass
class FlowChunkState:
    """Cross-chunk state of B concurrent streams (estimator rows are 2B: the
    CFG cond/uncond halves, rows b and b + B for stream b)."""

    enc_k: torch.Tensor          # [L, B, Tcap, H, D] encoder, token rate
    enc_v: torch.Tensor
    up_k: torch.Tensor           # [Lu, B, 2 Tcap, H, D] encoder, mel rate
    up_v: torch.Tensor
    pre_hist: torch.Tensor       # [B, 2, dim] pre-lookahead conv2 inputs
    ups_hist: torch.Tensor       # [B, 2, dim] token-rate rows of the upsample conv
    est_kv: torch.Tensor         # [S, L_est, 2B, R, 2, inner] per-Euler-step DiT K/V
    est_conv: dict               # name -> [S, 2B, 2, C_in] causal conv histories
    tok_pos: torch.Tensor        # [B] token frontier (valid tokens incl. prompt)
    anchor: torch.Tensor         # [B] prompt token count (grid anchor)

    @property
    def batch(self) -> int:
        return self.tok_pos.shape[0]

    def rows(self, idx: torch.Tensor) -> "FlowChunkState":
        """A copy of the state of streams idx [K]."""
        idx2 = torch.cat([idx, idx + self.batch])
        return FlowChunkState(
            enc_k=self.enc_k[:, idx], enc_v=self.enc_v[:, idx], up_k=self.up_k[:, idx],
            up_v=self.up_v[:, idx], pre_hist=self.pre_hist[idx], ups_hist=self.ups_hist[idx],
            est_kv=self.est_kv[:, :, idx2],
            est_conv={k: v[:, idx2] for k, v in self.est_conv.items()},
            tok_pos=self.tok_pos[idx], anchor=self.anchor[idx])

    def set_rows(self, idx: torch.Tensor, sub: "FlowChunkState") -> None:
        """Write `sub` (from rows(idx)) back into streams idx, in place."""
        idx2 = torch.cat([idx, idx + self.batch])
        for name in ("enc_k", "enc_v", "up_k", "up_v"):
            getattr(self, name)[:, idx] = getattr(sub, name)
        for name in ("pre_hist", "ups_hist", "tok_pos", "anchor"):
            getattr(self, name)[idx] = getattr(sub, name)
        self.est_kv[:, :, idx2] = sub.est_kv
        for k, v in self.est_conv.items():
            v[:, idx2] = sub.est_conv[k]


def est_block_count(cfg) -> int:
    return (2 + cfg.num_mid_blocks) * cfg.n_blocks


def est_conv_shapes(cfg) -> dict:
    """name -> input width of every causal conv of the estimator (the causal
    one-level topology, the only one the incremental flow takes)."""
    if not cfg.causal or len(cfg.channels) != 1:
        raise ValueError("the incremental flow takes the causal one-level estimator")
    ch = cfg.channels[0]
    shapes = {"d0b1": cfg.in_channels, "d0b2": ch, "ds0": ch, "u0b1": 2 * ch, "u0b2": ch,
              "us0": ch, "fb": ch}
    for i in range(cfg.num_mid_blocks):
        shapes[f"m{i}b1"] = ch
        shapes[f"m{i}b2"] = ch
    return shapes


def init_state(flow_cfg, B: int, tok_cap: int, dtype=torch.float32, est_dtype=None,
               device=None) -> FlowChunkState:
    """Zero state for B streams of at most tok_cap tokens (prompt + generated).
    The estimator cache keeps R = left_chunks * static_chunk_size mel rows."""
    enc, est = flow_cfg.encoder, flow_cfg.estimator
    if not (est.stream and est.left_chunks >= 0):
        raise ValueError("incremental flow needs the stream estimator (stream=True) with "
                         f"finite left_chunks, got stream={est.stream} "
                         f"left_chunks={est.left_chunks}")
    R = est.left_chunks * est.static_chunk_size
    first_hop = flow_cfg.token_mel_ratio * 2 * flow_cfg.input_frame_rate
    if R > first_hop:
        raise ValueError(
            f"incremental flow is exact only while the estimator's left window "
            f"(left_chunks * static_chunk_size = {R} mel rows) fits in the first hop "
            f"({first_hop} mel rows): a later chunk would otherwise reach into the prompt")
    H, D = enc.heads, enc.dim // enc.heads
    S = flow_cfg.cfm.n_timesteps
    inner = est.num_heads * est.attention_head_dim
    edt = est_dtype or _DTYPES[est.dtype]
    z = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=device)
    return FlowChunkState(
        enc_k=z(enc.num_blocks, B, tok_cap, H, D), enc_v=z(enc.num_blocks, B, tok_cap, H, D),
        up_k=z(4, B, 2 * tok_cap, H, D), up_v=z(4, B, 2 * tok_cap, H, D),
        pre_hist=z(B, 2, enc.dim), ups_hist=z(B, 2, enc.dim),
        est_kv=z(S, est_block_count(est), 2 * B, max(R, 1), 2, inner, dt=edt),
        est_conv={k: z(S, 2 * B, 2, c, dt=edt) for k, c in est_conv_shapes(est).items()},
        tok_pos=z(B, dt=torch.long), anchor=z(B, dt=torch.long))


def reset_rows(state: FlowChunkState, keep: torch.Tensor) -> FlowChunkState:
    """Zero the state of the streams where keep[b] is False (in place)."""
    keep = keep.to(state.tok_pos.device)
    keep2 = torch.cat([keep, keep])

    def z(x, k, axis):
        shape = [1] * x.ndim
        shape[axis] = -1
        x.masked_fill_(~k.reshape(shape), 0)

    for name in ("enc_k", "enc_v", "up_k", "up_v"):
        z(getattr(state, name), keep, 1)
    for name in ("pre_hist", "ups_hist", "tok_pos", "anchor"):
        z(getattr(state, name), keep, 0)
    z(state.est_kv, keep2, 2)
    for v in state.est_conv.values():
        z(v, keep2, 1)
    return state


# --------------------------------------------------------------------------
# encoder chunk
# --------------------------------------------------------------------------

def _enc_bias(pos, n_valid, M: int, Tcap: int, anchor, C: int, dtype) -> torch.Tensor:
    """[B, M, Tcap] additive: anchored chunk-causal (all left context) and
    validity.  Query i sits at absolute pos_b + i; key slot j is position j."""
    dev = pos.device
    qa = pos[:, None] + torch.arange(M, device=dev)[None, :]
    ka = torch.arange(Tcap, device=dev)[None, :]
    cq = anchored_chunk_ids(qa, anchor[:, None], C)
    ck = anchored_chunk_ids(ka.expand(pos.shape[0], Tcap), anchor[:, None], C)
    keep = (ck[:, None, :] <= cq[:, :, None]) & (ka[:, None, :] < (pos + n_valid)[:, None, None])
    return torch.where(keep, 0.0, NEG_INF).to(dtype)


def encoder_chunk(mdl, tokens, ctx_tokens, ctx_len, n_valid, state: FlowChunkState):
    """One encoder step over M new tokens [B, M] (rows >= n_valid pad) with
    the lookahead ctx_tokens [B, la] and its per-row counts ctx_len [B] (0:
    the stream ends here, so the lookahead is the one-shot zero pad).  Writes
    the K/V caches and rolls the conv histories of `state` in place.
    -> (mu [B, 2M, 80] fp32, valid mel rows [B, 2M] bool)."""
    enc = mdl.encoder
    cfg = enc.cfg
    B, M = tokens.shape
    dev = tokens.device
    la = enc.pre_lookahead_layer.pre_lookahead_len
    edt = _DTYPES[mdl.cfg.encoder_dtype]
    valid = torch.arange(M, device=dev)[None, :] < n_valid[:, None]
    emb = (mdl.input_embedding(tokens.clamp_min(0)) * valid[..., None]).to(edt)
    ctx_emb = mdl.input_embedding(ctx_tokens.clamp_min(0)).to(edt)
    xs = enc.embed(emb) * valid[..., None].to(edt)
    # the embedded lookahead rows sit at each row's valid frontier, so the
    # right-looking conv1 sees [valid rows ++ lookahead] even in a
    # tail-padded chunk; rows past ctx_len are zero
    cemb = enc.embed(ctx_emb) * (torch.arange(la, device=dev)[None, :]
                                 < ctx_len[:, None])[..., None].to(edt)
    ctx_buf = torch.zeros((B, M + la, cemb.shape[-1]), dtype=cemb.dtype, device=dev)
    ctx_buf[torch.arange(B, device=dev)[:, None],
            n_valid[:, None] + torch.arange(la, device=dev)[None, :]] = cemb
    xs, pre_in = enc.pre_lookahead_layer.chunk(xs, ctx_buf, state.pre_hist)
    bias = _enc_bias(state.tok_pos, n_valid, M, state.enc_k.shape[2], state.anchor,
                     cfg.static_chunk_size, xs.dtype)
    for i, layer in enumerate(enc.encoders):
        xs = layer.chunk(xs, state.enc_k[i], state.enc_v[i], state.tok_pos, bias)
    up, ups_in = enc.up_layer.chunk(xs * valid[..., None].to(xs.dtype), state.ups_hist)
    s = enc.up_stride
    valid2 = torch.arange(s * M, device=dev)[None, :] < (s * n_valid)[:, None]
    up = enc.up_embed(up) * valid2[..., None].to(up.dtype)
    bias2 = _enc_bias(s * state.tok_pos, s * n_valid, s * M, state.up_k.shape[2],
                      s * state.anchor, s * cfg.static_chunk_size, up.dtype)
    for i, layer in enumerate(enc.up_encoders):
        up = layer.chunk(up, state.up_k[i], state.up_v[i], s * state.tok_pos, bias2)
    mu = mdl.encoder_proj(enc.after_norm(up).float()) * valid2[..., None]
    state.pre_hist = roll_rows(state.pre_hist, pre_in[:, 2:], n_valid)
    state.ups_hist = roll_rows(state.ups_hist, ups_in[:, 2:], n_valid)
    return mu, valid2


# --------------------------------------------------------------------------
# estimator chunk (one Euler step)
# --------------------------------------------------------------------------

def _est_bias(pos2, n_valid2, N: int, R: int, anchor2, C: int, left: int,
              dtype) -> torch.Tensor:
    """[2B, N, R + N] additive for the chunk estimator: keys are the R cached
    rows (absolute pos2 - R + j) then the N new rows (absolute pos2 + j)."""
    dev = pos2.device
    ar_n = torch.arange(N, device=dev)[None, :]
    qa = pos2[:, None] + ar_n
    ka_cache = pos2[:, None] - R + torch.arange(R, device=dev)[None, :]
    ka = torch.cat([ka_cache, qa], dim=1)
    valid_k = torch.cat([ka_cache >= 0, ar_n < n_valid2[:, None]], dim=1)
    cq = anchored_chunk_ids(qa, anchor2[:, None], C)
    ck = anchored_chunk_ids(ka, anchor2[:, None], C)
    keep = ((ck[:, None, :] <= cq[:, :, None]) & (ck[:, None, :] >= cq[:, :, None] - left)
            & valid_k[:, None, :])
    return torch.where(keep, 0.0, NEG_INF).to(dtype)


def _conv_hist_chunk(conv, h, mask, hist):
    """A causal k3 conv driven chunk-wise: prepend the 2-row history, drop
    its 2 outputs.  -> (out, inputs)."""
    xin = torch.cat([hist, h * mask[..., None]], dim=1)
    return conv(xin)[:, 2:], xin


def estimator_step(est, x, mu, t_emb, spks, cond, mask, bias, kv_s, conv_s):
    """One Euler step's estimator forward over N new rows (2B batch); est a
    ConditionalDecoder of the stream config.  kv_s [L_est, 2B, R, 2, inner];
    conv_s name -> [2B, 2, C_in]; bias [2B, N, R + N].  -> (v [2B, N, 80]
    fp32, new K/V rows [L_est, 2B, N, 2, inner], new conv input rows by name)."""
    cdt = _DTYPES[est.cfg.dtype]
    x, mu, spks, cond, mask, bias = (v.to(cdt) for v in (x, mu, spks, cond, mask, bias))
    N = x.shape[1]
    h = torch.cat([x, mu, spks[:, None, :].expand(-1, N, -1), cond], dim=-1)
    kv_new, conv_new = [], {}

    def resnet_chunk(res, h, k1, k2):
        h, conv_new[k1], conv_new[k2] = res.chunk(h, mask, t_emb, conv_s[k1].to(cdt),
                                                  conv_s[k2].to(cdt))
        return h

    def tbs_chunk(tbs, h):
        for tb in tbs:
            h, k, v = tb.chunk(h, kv_s[len(kv_new)].to(cdt), bias)
            kv_new.append(torch.stack([k, v], dim=2))
        return h

    resnet, tbs, down = est.down_blocks[0]
    skip = tbs_chunk(tbs, resnet_chunk(resnet, h, "d0b1", "d0b2"))
    h, conv_new["ds0"] = _conv_hist_chunk(down, skip, mask, conv_s["ds0"].to(cdt))
    for i, (resnet, tbs) in enumerate(est.mid_blocks):
        h = tbs_chunk(tbs, resnet_chunk(resnet, h, f"m{i}b1", f"m{i}b2"))
    resnet, tbs, up = est.up_blocks[0]
    h = tbs_chunk(tbs, resnet_chunk(resnet, torch.cat([h, skip], dim=-1), "u0b1", "u0b2"))
    h, conv_new["us0"] = _conv_hist_chunk(up, h, mask, conv_s["us0"].to(cdt))
    h, conv_new["fb"] = est.final_block.chunk(h, mask, conv_s["fb"].to(cdt))
    out = est.final_proj(h * mask[..., None])
    return (out * mask[..., None]).float(), torch.stack(kv_new), conv_new


# --------------------------------------------------------------------------
# whole-chunk CFM
# --------------------------------------------------------------------------

@torch.no_grad()
def flow_chunk(mdl, tokens, ctx_tokens, prompt_feat: Optional[torch.Tensor],
               prompt_feat_len: Optional[torch.Tensor], embedding, n_valid, ctx_len,
               state: FlowChunkState, noise, first: bool = False,
               ragged_tail: bool = True):
    """One chunk for B streams of `mdl` (a CausalMaskedDiffWithXvec of the
    stream config, finite left_chunks).

    tokens [B, M]: the first chunk carries [prompt ++ first hop], later ones
    generated tokens only; rows >= n_valid[b] are pad.  ctx_tokens [B, la] the
    next chunk's first tokens with counts ctx_len [B] (0: the stream ends
    here).  prompt_feat [B, P, 80] and prompt_feat_len [B] on first chunks
    (state.anchor must already hold the prompt token counts).  noise
    [B, 2M, 80]: the pinned CFM noise at each row's absolute mel rows.
    ragged_tail=False when every n_valid is M or 0 (the cache rolls become a
    slice).  -> (mel [B, 2M, 80] fp32, zero past each row's valid rows;
    state, updated in place)."""
    cfm = mdl.decoder
    est = cfm.estimator
    ecfg = est.cfg
    ratio = mdl.cfg.token_mel_ratio
    if ratio != 2 or mdl.encoder.up_stride != 2:
        raise ValueError("incremental flow: token_mel_ratio and up_stride must be 2")
    B, M = tokens.shape
    N = ratio * M
    dev = tokens.device
    n_valid = n_valid.to(dev).long()
    if int((state.tok_pos + n_valid).max()) > state.enc_k.shape[2]:
        raise ValueError(f"flow_chunk: a stream outgrows its {state.enc_k.shape[2]}-token "
                         "cache (tok_cap)")
    mu, valid2 = encoder_chunk(mdl, tokens, ctx_tokens, ctx_len.to(dev).long(), n_valid, state)
    spks = embedding / embedding.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    spks = mdl.spk_embed_affine_layer(spks)
    cond = torch.zeros((B, N, mdl.cfg.output_size), dtype=mu.dtype, device=dev)
    if first:
        P = min(prompt_feat.shape[1], N)
        cond[:, :P] = prompt_feat[:, :P].to(mu.dtype)
        keep = torch.arange(N, device=dev)[None, :] < prompt_feat_len.to(dev)[:, None]
        cond = cond.masked_fill(~keep[..., None], 0.0)
    # CFG 2B layout: rows [0, B) conditioned, [B, 2B) unconditioned
    mu2 = torch.cat([mu, torch.zeros_like(mu)])
    spks2 = torch.cat([spks, torch.zeros_like(spks)])
    cond2 = torch.cat([cond, torch.zeros_like(cond)])
    mask2 = torch.cat([valid2, valid2]).to(mu.dtype)
    pos2 = (ratio * state.tok_pos).repeat(2)
    nv2 = (ratio * n_valid).repeat(2)
    R = state.est_kv.shape[3]
    cdt = _DTYPES[ecfg.dtype]
    bias2 = _est_bias(pos2, nv2, N, R, (ratio * state.anchor).repeat(2),
                      ecfg.static_chunk_size, ecfg.left_chunks, cdt)
    t_span = cosine_t_span(cfm.cfg.n_timesteps, mu.dtype, dev)
    r = cfm.cfg.inference_cfg_rate
    x = noise.to(device=dev, dtype=mu.dtype) * valid2[..., None]
    static_roll = not ragged_tail and N >= R
    full = nv2 == N
    for s in range(cfm.cfg.n_timesteps):
        t, dt = t_span[s], t_span[s + 1] - t_span[s]
        t_emb = est.time_embed(t.expand(2 * B), cdt)
        v, kv_rows, conv_rows = estimator_step(
            est, torch.cat([x, x]), mu2, t_emb, spks2, cond2, mask2, bias2, state.est_kv[s],
            {k: c[s] for k, c in state.est_conv.items()})
        kv_s = state.est_kv[s]
        if static_roll:
            keep = full[None, :, None, None, None]
            kv_s.copy_(torch.where(keep, kv_rows[:, :, N - R:].to(kv_s.dtype), kv_s))
            for k, c in state.est_conv.items():
                c[s] = torch.where(full[:, None, None], conv_rows[k][:, N:N + 2].to(c.dtype),
                                   c[s])
        else:
            # the block axis rides along: roll rows of [2B, R, L_est, 2, inner]
            rows_first = lambda t: t.permute(1, 2, 0, 3, 4)
            kv_s.copy_(roll_rows(rows_first(kv_s), rows_first(kv_rows), nv2)
                       .permute(2, 0, 1, 3, 4))
            # the conv input rows already carry the old history in front
            for k, c in state.est_conv.items():
                c[s] = tail_rows(conv_rows[k].to(c.dtype), nv2, 2)
        x = x + dt * ((1.0 + r) * v[:B] - r * v[B:])
    state.tok_pos = state.tok_pos + n_valid
    return x * valid2[..., None], state

