"""Conformer encoders with espnet relative-position attention: the
CosyVoice2 flow encoder (UpsampleConformerEncoder) and the generic
ConformerEncoder of the CosyVoice v1 family (its text encoder, its LM body
and its flow encoder).

Port of cosyvoice_tpu/models/conformer.py: the encoder layer with its
options (the macaron FFN at half weight, the conv module with norm_conv /
norm_final, the mixture-of-experts FFN), the speaker-adaptive layer of the
phoneme LMs' text encoders (`spk_adapt`: a per-layer `spk_linear` adds the
raw speaker vector at the layer's entry, and the layer's norms take eps
1e-5), the absolute positional encodings (sinusoidal, whisper, learnable,
none) and the subsampling front ends (EmbedNoSubsampling,
Conv1dSubsampling2, Conv2dSubsampling4/6/8) that the transformer stack's
other users take, and two kinds of incremental step:
  * `.chunk`, which models/flow_chunk.py drives: new rows against cached
    K/V (the espnet rel-pos skew at a per-row offset) and 2-row conv
    histories; `chunk_anchor` anchors the encoder's chunk grid at the
    prompt/generation boundary (ops/masks.anchored_chunk_mask);
  * ConformerEncoder's `prefill` / `decode_step` over a ConformerKVCache,
    the v1 LM's decode.  Prefill is one causal pass that writes the cache
    (the JAX package scans one-token decodes: the same function); each
    decode step reads its layer's projected rel-pos table, computed once a
    decode, where the JAX package projects the whole table every step.
    Like the JAX decode, both keep the macaron FFN and skip the conv module
    (it spans time and would need its own history); `.chunk` refuses either
    option, as the JAX one does.
Dropout (the attention probabilities at attention_dropout_rate; the FFN's
hidden layer, each residual branch and the input embedding at dropout_rate)
acts in train() mode inside an nn/dropout.dropout_generator block (a
training step), its masks drawn from that generator, at the JAX package's
places.  Parameter names follow the reference checkpoint (`encoders.{i}.self_attn.linear_q`,
`encoders.{i}.feed_forward.w_1`, `embed.out.0`, ...; wenet's
TransformerEncoderLayer, the v1 LM body's, names its norms `norm1` / `norm2`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from cosyvoice_tpu_torch.nn.conv import Conv1d
from cosyvoice_tpu_torch.nn.dense import Dense
from cosyvoice_tpu_torch.nn.dropout import Dropout, training_step
from cosyvoice_tpu_torch.nn.norm import LayerNorm
from cosyvoice_tpu_torch.ops.activations import swish
from cosyvoice_tpu_torch.ops.masks import (NEG_INF, add_chunk_mask, anchored_chunk_mask,
                                          make_non_pad_mask)


@dataclass(frozen=True)
class ConformerConfig:
    dim: int = 512
    heads: int = 8
    linear_units: int = 2048
    num_blocks: int = 6
    input_size: int = 512
    key_bias: bool = True
    static_chunk_size: int = 0
    activation: str = "swish"     # swish | relu: the FFN's
    input_layer: str = "linear"   # linear | linear_legacy (a ReLU after the norm)
    spk_adapt: bool = False       # per-layer speaker injection (full forward only)
    spk_emb_size: int = 512
    # training only (train() mode): nn/dropout.py
    dropout_rate: float = 0.1
    attention_dropout_rate: float = 0.1
    # the layer's options (the CosyVoice recipes set none of them)
    macaron_style: bool = False   # a second FFN before attention, both at weight 0.5
    use_cnn_module: bool = False  # the conv module after attention, and norm_final
    cnn_module_kernel: int = 15
    cnn_causal: bool = False
    cnn_norm: str = "batch_norm"  # batch_norm (running statistics) | layer_norm
    ffn_type: str = "ffn"         # ffn | moe (MoEFFNLayer)
    n_expert: int = 8
    n_expert_per_token: int = 2


@lru_cache(maxsize=None)
def _espnet_rel_pos_np(T: int, d: int) -> np.ndarray:
    """[1, 2T-1, d] rel-pos table: index m <-> relative distance T-1-m."""
    pos = np.arange(T, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float32) * -(np.log(10000.0) / d))
    pe_pos = np.zeros((T, d), np.float32)
    pe_pos[:, 0::2] = np.sin(pos * div)
    pe_pos[:, 1::2] = np.cos(pos * div)
    pe_neg = np.zeros((T, d), np.float32)
    pe_neg[:, 0::2] = np.sin(-pos * div)
    pe_neg[:, 1::2] = np.cos(-pos * div)
    return np.concatenate([pe_pos[::-1], pe_neg[1:]], axis=0)[None]


def espnet_rel_pos_emb(T: int, d: int, dtype, device) -> torch.Tensor:
    return torch.as_tensor(_espnet_rel_pos_np(T, d), dtype=dtype, device=device)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, 2T-1] -> [B, H, T, T]: out[..., i, j] = x[..., i, T-1-i+j]."""
    B, H, T, L = x.shape
    x = F.pad(x, (1, 0))
    return x.reshape(B, H, L + 1, T)[:, :, 1:].reshape(B, H, T, L)[..., :T]


class RelPositionAttention(nn.Module):
    def __init__(self, heads: int, dim: int, key_bias: bool = True,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.heads, self.dim = heads, dim
        self.attn_dropout = Dropout(dropout_rate)
        self.linear_q = Dense(dim, dim)
        self.linear_k = Dense(dim, dim, bias=key_bias)
        self.linear_v = Dense(dim, dim)
        self.linear_out = Dense(dim, dim)
        self.linear_pos = Dense(dim, dim, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(heads, dim // heads))
        self.pos_bias_v = nn.Parameter(torch.zeros(heads, dim // heads))

    def forward(self, x: torch.Tensor, pos_emb: torch.Tensor, mask: torch.Tensor):
        """x [B, T, dim]; pos_emb [1, 2T-1, dim]; mask [B, T|1, T] bool."""
        H, D = self.heads, self.dim // self.heads
        B, T, _ = x.shape
        q = self.linear_q(x).reshape(B, T, H, D)
        k = self.linear_k(x).reshape(B, T, H, D)
        v = self.linear_v(x).reshape(B, T, H, D)
        p = self.linear_pos(pos_emb).reshape(1, -1, H, D)
        ac = torch.einsum("bihd,bjhd->bhij", q + self.pos_bias_u.to(q.dtype), k)
        bd = torch.einsum("bihd,bjhd->bhij", q + self.pos_bias_v.to(q.dtype), p)
        scores = (ac + rel_shift(bd)) / math.sqrt(D)
        m = mask[:, None]
        attn = torch.softmax(scores.masked_fill(~m, NEG_INF), dim=-1).masked_fill(~m, 0.0)
        attn = self.attn_dropout(attn)
        out = torch.einsum("bhij,bjhd->bihd", attn, v).reshape(B, T, self.dim)
        return self.linear_out(out)

    def pos_table(self, T: int, dtype, device) -> torch.Tensor:
        """linear_pos of the [2T-1]-row espnet table -> [2T-1, H, D]."""
        p = self.linear_pos(espnet_rel_pos_emb(T, self.dim, dtype, device))
        return p.reshape(2 * T - 1, self.heads, self.dim // self.heads)

    def decode(self, x: torch.Tensor, layer_k: torch.Tensor, layer_v: torch.Tensor,
               pos: int, valid: torch.Tensor,
               table: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One new row x [B, 1, dim] at slot `pos` of the cache layer_k/v
        [B, Tmax, H, D] (its K/V written there in place first), attending
        over the keys that `valid` [B, Tmax] keeps.  Slot j reads the rel-pos
        table at (Tmax - 1) - pos + j; `table` is pos_table(Tmax), built here
        when not given.  -> out [B, 1, dim]."""
        H, D = self.heads, self.dim // self.heads
        B = x.shape[0]
        Tmax = layer_k.shape[1]
        q = self.linear_q(x).reshape(B, 1, H, D)
        layer_k[:, pos] = self.linear_k(x)[:, 0].reshape(B, H, D).to(layer_k.dtype)
        layer_v[:, pos] = self.linear_v(x)[:, 0].reshape(B, H, D).to(layer_v.dtype)
        if table is None:
            table = self.pos_table(Tmax, x.dtype, x.device)
        p = table[Tmax - 1 - pos: 2 * Tmax - 1 - pos]
        ac = torch.einsum("bihd,bjhd->bhij", q + self.pos_bias_u.to(q.dtype),
                          layer_k.to(q.dtype))
        bd = torch.einsum("bihd,jhd->bhij", q + self.pos_bias_v.to(q.dtype), p)
        scores = ((ac + bd) / math.sqrt(D)).masked_fill(~valid[:, None, None, :], NEG_INF)
        out = torch.einsum("bhij,bjhd->bihd", torch.softmax(scores, dim=-1),
                           layer_v.to(q.dtype))
        return self.linear_out(out.reshape(B, 1, self.dim))

    def chunk_decode(self, x: torch.Tensor, layer_k: torch.Tensor, layer_v: torch.Tensor,
                     pos: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """M new rows at absolute positions pos_b + i (pos [B]) against the
        cache layer_k/v [B, Tcap, H, D]: the new rows' K/V are written at
        pos_b first (in place; rows past Tcap are pad rows and are not
        written), then every row attends over the cache under the additive
        bias [B, M, Tcap] (validity and the anchored chunk mask).  The
        rel-pos term reads the espnet table at (Tcap - 1) - (pos_b + i) + j,
        the full-sequence skew at a per-row offset.  -> out [B, M, dim]."""
        H, D = self.heads, self.dim // self.heads
        B, M, _ = x.shape
        Tcap = layer_k.shape[1]
        q = self.linear_q(x).reshape(B, M, H, D)
        k = self.linear_k(x).reshape(B, M, H, D)
        v = self.linear_v(x).reshape(B, M, H, D)
        rows = pos.to(x.device)[:, None] + torch.arange(M, device=x.device)[None, :]
        fits = rows < Tcap
        b_idx = torch.arange(B, device=x.device)[:, None].expand(B, M)
        layer_k[b_idx[fits], rows[fits]] = k[fits].to(layer_k.dtype)
        layer_v[b_idx[fits], rows[fits]] = v[fits].to(layer_v.dtype)
        p = self.linear_pos(espnet_rel_pos_emb(Tcap, self.dim, x.dtype, x.device))
        p = p.reshape(1, -1, H, D)
        ac = torch.einsum("bihd,bjhd->bhij", q + self.pos_bias_u.to(q.dtype),
                          layer_k.to(q.dtype))
        bd_full = torch.einsum("bihd,bjhd->bhij", q + self.pos_bias_v.to(q.dtype), p)
        idx = ((Tcap - 1) - rows[:, :, None]
               + torch.arange(Tcap, device=x.device)[None, None, :]).clamp(0, 2 * Tcap - 2)
        bd = torch.gather(bd_full, 3, idx[:, None].expand(B, H, M, Tcap))
        scores = (ac + bd) / math.sqrt(D) + bias[:, None].to(ac.dtype)
        attn = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhij,bjhd->bihd", attn, layer_v.to(q.dtype))
        return self.linear_out(out.reshape(B, M, self.dim))


def _gelu(x):
    return F.gelu(x, approximate="tanh")      # jax.nn.gelu's default


_ACTIVATIONS = {"swish": swish, "relu": F.relu, "gelu": _gelu}


class PositionwiseFeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int, activation: str = "swish",
                 dropout_rate: float = 0.0):
        super().__init__()
        self.w_1 = Dense(dim, hidden)
        self.w_2 = Dense(hidden, dim)
        self.act = _ACTIVATIONS[activation]
        self.dropout = Dropout(dropout_rate)

    def forward(self, x):
        return self.w_2(self.dropout(self.act(self.w_1(x))))


class MoEFFNLayer(nn.Module):
    """Mixture-of-experts positionwise FFN: a linear router (`gate`, no
    bias), the top-k experts a token, a softmax (fp32) over the selected
    logits.  Every expert runs on every token and the top-k weights mask the
    sum, as in the JAX package; the experts keep the reference's names
    (`experts.{e}.w_1` / `w_2`)."""

    def __init__(self, dim: int, hidden: int, n_expert: int, n_expert_per_token: int,
                 activation: str = "relu"):
        super().__init__()
        self.k = n_expert_per_token
        self.gate = Dense(dim, n_expert, bias=False)
        self.experts = nn.ModuleList(PositionwiseFeedForward(dim, hidden, activation)
                                     for _ in range(n_expert))
        self.act = _ACTIVATIONS[activation]

    def forward(self, x):
        logits, idx = torch.topk(self.gate(x), self.k, dim=-1)
        weights = torch.softmax(logits.float(), dim=-1).to(x.dtype)           # [B, T, k]
        gate = (F.one_hot(idx, len(self.experts)).to(x.dtype) * weights[..., None]).sum(-2)
        cat = lambda name: torch.stack([getattr(e, name).weight for e in self.experts]).to(x.dtype)
        bias = lambda name: torch.stack([getattr(e, name).bias for e in self.experts]).to(x.dtype)
        h = self.act(torch.einsum("btd,ehd->bteh", x, cat("w_1")) + bias("w_1"))
        y = torch.einsum("bteh,edh->bted", h, cat("w_2")) + bias("w_2")
        return torch.einsum("bted,bte->btd", y, gate)


class ConvolutionModule(nn.Module):
    """The conformer conv module: pointwise conv to 2C -> GLU -> depthwise
    conv (causal: left pad K - 1; else centred) -> norm -> activation ->
    pointwise conv; pad rows zeroed on the way in and out.  The norm is a
    LayerNorm (eps 1e-5) or a BatchNorm from its running statistics (eps
    1e-5, flax's formula)."""

    def __init__(self, channels: int, kernel_size: int = 15, causal: bool = False,
                 norm: str = "batch_norm", activation: str = "swish"):
        super().__init__()
        pad = (kernel_size - 1, 0) if causal else ((kernel_size - 1) // 2,) * 2
        self.pointwise_conv1 = Conv1d(channels, 2 * channels, 1)
        self.depthwise_conv = Conv1d(channels, channels, kernel_size, padding=pad,
                                     groups=channels)
        self.norm = (LayerNorm(channels, 1e-5) if norm == "layer_norm"
                     else nn.BatchNorm1d(channels, eps=1e-5))
        self.pointwise_conv2 = Conv1d(channels, channels, 1)
        self.act = _ACTIVATIONS[activation]

    def forward(self, x, pad_mask: Optional[torch.Tensor] = None):
        """x [B, T, C]; pad_mask [B, T] bool (True = valid)."""
        if self.training and isinstance(self.norm, nn.BatchNorm1d) and training_step():
            raise NotImplementedError("training a conv module with batch_norm needs batch "
                                      "statistics (no recipe sets use_cnn_module); use "
                                      "cnn_norm='layer_norm' or eval()")
        if pad_mask is not None:
            x = x.masked_fill(~pad_mask[..., None], 0.0)
        a, b = self.pointwise_conv1(x).chunk(2, dim=-1)
        x = self.depthwise_conv(a * torch.sigmoid(b))
        n = self.norm
        if isinstance(n, nn.BatchNorm1d):
            mul = torch.rsqrt(n.running_var + n.eps) * n.weight
            x = ((x.float() - n.running_mean) * mul + n.bias).to(x.dtype)
        else:
            x = n(x)
        x = self.pointwise_conv2(self.act(x))
        if pad_mask is not None:
            x = x.masked_fill(~pad_mask[..., None], 0.0)
        return x


class ConformerEncoderLayer(nn.Module):
    """Pre-norm [macaron FFN x 0.5] -> self-attention -> [conv module] ->
    FFN (x 0.5 with the macaron one) [-> norm_final].  Norms eps 1e-12;
    with spk_adapt, norm_mha / norm_ff eps 1e-5 and the speaker vector's
    projection added at the entry."""

    NORMS = ("norm_mha", "norm_ff")     # the checkpoint's names of the two norms

    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        self.cfg = cfg
        for name in self.NORMS:
            self.add_module(name, LayerNorm(cfg.dim, 1e-5 if cfg.spk_adapt else 1e-12))
        self.spk_linear = Dense(cfg.spk_emb_size, cfg.dim) if cfg.spk_adapt else None
        self.res_dropout = Dropout(cfg.dropout_rate)
        self.self_attn = RelPositionAttention(cfg.heads, cfg.dim, cfg.key_bias,
                                              cfg.attention_dropout_rate)
        if cfg.ffn_type == "moe":
            self.feed_forward = MoEFFNLayer(cfg.dim, cfg.linear_units, cfg.n_expert,
                                            cfg.n_expert_per_token, cfg.activation)
        else:
            self.feed_forward = PositionwiseFeedForward(cfg.dim, cfg.linear_units,
                                                        cfg.activation, cfg.dropout_rate)
        if cfg.macaron_style:
            self.norm_ff_macaron = LayerNorm(cfg.dim, 1e-12)
            self.feed_forward_macaron = PositionwiseFeedForward(cfg.dim, cfg.linear_units,
                                                                cfg.activation,
                                                                cfg.dropout_rate)
        if cfg.use_cnn_module:
            self.norm_conv = LayerNorm(cfg.dim, 1e-12)
            self.norm_final = LayerNorm(cfg.dim, 1e-12)
            self.conv_module = ConvolutionModule(cfg.dim, cfg.cnn_module_kernel,
                                                 cfg.cnn_causal, cfg.cnn_norm, cfg.activation)
        self.ff_scale = 0.5 if cfg.macaron_style else 1.0

    def _norms(self):
        return self._modules[self.NORMS[0]], self._modules[self.NORMS[1]]

    def _macaron(self, x):
        if self.cfg.macaron_style:
            x = x + self.ff_scale * self.res_dropout(
                self.feed_forward_macaron(self.norm_ff_macaron(x)))
        return x

    def forward(self, x, pos_emb, attn_mask, spk_emb: Optional[torch.Tensor] = None,
                pad_mask: Optional[torch.Tensor] = None):
        """pad_mask [B, T] (True = valid) masks the conv module's input and
        output."""
        norm_mha, norm_ff = self._norms()
        if spk_emb is not None and self.spk_linear is not None:
            x = x + self.spk_linear(spk_emb)[:, None, :].to(x.dtype)
        drop = self.res_dropout
        x = self._macaron(x)
        x = x + drop(self.self_attn(norm_mha(x), pos_emb, attn_mask))
        if self.cfg.use_cnn_module:
            x = x + drop(self.conv_module(self.norm_conv(x), pad_mask))
        x = x + self.ff_scale * drop(self.feed_forward(norm_ff(x)))
        return self.norm_final(x) if self.cfg.use_cnn_module else x

    def chunk(self, x, layer_k, layer_v, pos, bias):
        """M-row incremental step over a static K/V cache (written in place);
        the flow encoder's configuration only (no macaron FFN, no conv
        module), as in the JAX package."""
        assert not self.cfg.macaron_style and not self.cfg.use_cnn_module
        return self.cached_rows(x, layer_k, layer_v, pos, bias)

    def cached_rows(self, x, layer_k, layer_v, pos, bias):
        """chunk's computation with decode's options: the macaron FFN kept,
        the conv module skipped (ConformerEncoder.prefill)."""
        norm_mha, norm_ff = self._norms()
        x = self._macaron(x)
        x = x + self.self_attn.chunk_decode(norm_mha(x), layer_k, layer_v, pos, bias)
        return x + self.ff_scale * self.feed_forward(norm_ff(x))

    def decode(self, x, layer_k, layer_v, pos: int, valid, table=None):
        """One-row step at cache slot `pos` (RelPositionAttention.decode); the
        macaron FFN kept, the conv module skipped, as the JAX decode does."""
        norm_mha, norm_ff = self._norms()
        x = self._macaron(x)
        x = x + self.self_attn.decode(norm_mha(x), layer_k, layer_v, pos, valid, table)
        return x + self.ff_scale * self.feed_forward(norm_ff(x))


class TransformerEncoderLayer(ConformerEncoderLayer):
    """wenet's TransformerEncoderLayer as the v1 LM body configures it: the
    same computation, its norms named norm1 / norm2."""

    NORMS = ("norm1", "norm2")


class LinearEmbed(nn.Module):
    """LinearNoSubsampling: Linear -> LayerNorm(1e-5) -> x sqrt(dim); with
    `legacy`, LegacyLinearNoSubsampling's ReLU after the norm (the v1 LM
    body's input layer)."""

    def __init__(self, in_dim: int, dim: int, legacy: bool = False,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.out = nn.ModuleList([Dense(in_dim, dim), LayerNorm(dim, 1e-5)])
        self.scale = float(np.sqrt(dim))
        self.legacy = legacy
        self.dropout = Dropout(dropout_rate)

    def forward(self, x):
        h = self.dropout(self.out[1](self.out[0](x)))
        return (F.relu(h) if self.legacy else h) * self.scale


def sinusoidal_pos_emb(T: int, d: int, offset: int = 0, dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """Absolute sinusoidal table [1, T, d] (interleaved sin / cos) from
    position `offset` on; the caller adds it to x * sqrt(d)."""
    pos = np.arange(offset, offset + T, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float32) * -(np.log(10000.0) / d))
    pe = np.zeros((T, d), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.as_tensor(pe[None], dtype=dtype, device=device)


def whisper_pos_emb(T: int, d: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """openai-whisper's encoder sinusoids [1, T, d]: sin | cos concatenated,
    log timescales over d // 2; no input scale."""
    inc = np.log(10000.0) / (d // 2 - 1)
    inv = np.exp(-inc * np.arange(d // 2, dtype=np.float32))
    t = np.arange(T, dtype=np.float32)[:, None] * inv[None, :]
    return torch.as_tensor(np.concatenate([np.sin(t), np.cos(t)], axis=1)[None],
                           dtype=dtype, device=device)


def no_pos_emb(T: int, d: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """NoPositionalEncoding's zero table [1, T, d]."""
    return torch.zeros((1, T, d), dtype=dtype, device=device)


class LearnablePositionalEncoding(nn.Module):
    """whisper-decoder learned positions: a `pe` table [1, max_len, d]; no
    input scale.  forward(x [B, T, d], offset) -> (x + pe[offset:offset+T],
    that slice)."""

    def __init__(self, dim: int, max_len: int = 448):
        super().__init__()
        self.pe = nn.Parameter(torch.randn(1, max_len, dim) * 0.02)

    def forward(self, x: torch.Tensor, offset: int = 0):
        emb = self.pe[:, offset:offset + x.shape[1]].to(x.dtype)
        return x + emb, emb


class EmbedNoSubsampling(nn.Module):
    """Id embedding, no rate change: (ids [B, T], mask) -> ([B, T, odim],
    mask); the caller adds positions."""

    def __init__(self, vocab: int, odim: int):
        super().__init__()
        self.embed = nn.Embedding(vocab, odim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor):
        return self.embed(x), mask


class Conv1dSubsampling2(nn.Module):
    """whisper's 1/2-rate front end: conv (k3, pad 1) -> GELU -> conv (k3,
    stride 2, pad 1) -> GELU on [B, T, idim]; the mask [B, 1, T] sliced
    [(T + 1) % 2::2].  The convs keep the reference's names conv.0 / conv.2."""

    def __init__(self, idim: int, odim: int):
        super().__init__()
        self.conv = nn.ModuleList([Conv1d(idim, odim, 3, padding=1), nn.GELU(),
                                   Conv1d(odim, odim, 3, stride=2, padding=1), nn.GELU()])

    def forward(self, x: torch.Tensor, mask: torch.Tensor):
        T = x.shape[1]
        for m in self.conv:
            x = m(x)
        return x, mask[:, :, (T + 1) % 2::2]


class Conv2dSubsampling(nn.Module):
    """The 1/4, 1/6 and 1/8-rate front ends: VALID 2-D convs over (time,
    feature) each with a ReLU, then a linear over the channel-major
    flattened (channels x reduced features); the mask [B, 1, T] sliced as
    each conv strides.  Names as the reference's: conv.{0,2,4}, then out.0
    (rate 4) or linear (rates 6, 8)."""

    PLANS = {4: ((3, 2), (3, 2)), 6: ((3, 2), (5, 3)), 8: ((3, 2), (3, 2), (3, 2))}

    def __init__(self, idim: int, odim: int, rate: int):
        super().__init__()
        plan = self.PLANS[rate]
        layers, f = [], idim
        for i, (k, s) in enumerate(plan):
            layers += [nn.Conv2d(1 if i == 0 else odim, odim, k, s), nn.ReLU()]
            f = (f - k) // s + 1
        self.conv = nn.Sequential(*layers)
        lin = Dense(odim * f, odim)
        if rate == 4:
            self.out = nn.ModuleList([lin])
        else:
            self.linear = lin
        self.plan = plan

    def forward(self, x: torch.Tensor, mask: torch.Tensor):
        """x [B, T, idim], mask [B, 1, T] -> ([B, T', odim], mask [B, 1, T'])."""
        h = self.conv(x[:, None])                                  # [B, C, T', F']
        B, C, T2, F2 = h.shape
        h = h.transpose(1, 2).reshape(B, T2, C * F2)
        h = self.out[0](h) if hasattr(self, "out") else self.linear(h)
        for k, s in self.plan:
            mask = mask[:, :, k - 1::s]
        return h, mask


class PreLookaheadLayer(nn.Module):
    """Right-pad lookahead conv + causal conv, residual."""

    def __init__(self, channels: int, pre_lookahead_len: int = 3):
        super().__init__()
        self.pre_lookahead_len = pre_lookahead_len
        self.conv1 = Conv1d(channels, channels, pre_lookahead_len + 1)
        self.conv2 = Conv1d(channels, channels, 3)

    def forward(self, x):
        h = F.pad(x, (0, 0, 0, self.pre_lookahead_len))
        h = F.leaky_relu(self.conv1(h), 0.01)
        h = self.conv2(F.pad(h, (0, 0, 2, 0)))
        return h + x

    def chunk(self, x, ctx_buf, hist2):
        """Incremental step over N new rows x [B, N, C] (pad rows zero):
        ctx_buf [B, N + la, C] holds the lookahead rows placed at each row's
        valid frontier (zeros where a stream ends: the one-shot right zero
        pad); hist2 [B, 2, C] the last two valid conv2 inputs (zeros at the
        stream's start: the one-shot left pad).  -> (out [B, N, C], conv2
        inputs [B, 2 + N, C] for the caller's history roll)."""
        la = self.pre_lookahead_len
        h = F.pad(x, (0, 0, 0, la)) + ctx_buf
        h = F.leaky_relu(self.conv1(h), 0.01)
        h2in = torch.cat([hist2.to(h.dtype), h], dim=1)
        return self.conv2(h2in) + x, h2in


class Upsample1D(nn.Module):
    """Nearest x`stride` upsample, left zero-pad 2*stride, conv k=2*stride+1."""

    def __init__(self, channels: int, stride: int = 2):
        super().__init__()
        self.stride = stride
        self.conv = Conv1d(channels, channels, stride * 2 + 1)

    def forward(self, x):
        x = torch.repeat_interleave(x, self.stride, dim=1)
        return self.conv(F.pad(x, (0, 0, self.stride * 2, 0)))

    def chunk(self, x, hist2):
        """Incremental step: x [B, N, C] new token-rate rows, hist2 [B, 2, C]
        the last two valid ones (zeros at the stream's start: the one-shot
        left zero pad of 2 * stride upsampled rows).  -> (out [B, N * stride,
        C], conv inputs [B, 2 + N, C] for the history roll)."""
        xin = torch.cat([hist2.to(x.dtype), x], dim=1)
        return self.conv(torch.repeat_interleave(xin, self.stride, dim=1)), xin


class UpsampleConformerEncoder(nn.Module):
    """lookahead -> num_blocks layers -> x2 upsample -> up_blocks layers.
    The static chunk mask (doubled after the upsample) applies whenever
    static_chunk_size > 0, as in the v2 flow encoder; with chunk_always
    False (the stream family's encoder) only while streaming."""

    def __init__(self, cfg: ConformerConfig, up_blocks: int = 4,
                 pre_lookahead_len: int = 3, up_stride: int = 2,
                 chunk_always: bool = True):
        super().__init__()
        self.cfg, self.up_stride, self.chunk_always = cfg, up_stride, chunk_always
        self.embed = LinearEmbed(cfg.input_size, cfg.dim, dropout_rate=cfg.dropout_rate)
        self.pre_lookahead_layer = PreLookaheadLayer(cfg.dim, pre_lookahead_len)
        self.encoders = nn.ModuleList(ConformerEncoderLayer(cfg)
                                      for _ in range(cfg.num_blocks))
        self.up_layer = Upsample1D(cfg.dim, up_stride)
        self.up_embed = LinearEmbed(cfg.dim, cfg.dim, dropout_rate=cfg.dropout_rate)
        self.up_encoders = nn.ModuleList(ConformerEncoderLayer(cfg)
                                         for _ in range(up_blocks))
        self.after_norm = LayerNorm(cfg.dim, 1e-5)

    def forward(self, xs: torch.Tensor, lens: torch.Tensor, streaming: bool = False,
                chunk_anchor: Optional[torch.Tensor] = None):
        """xs [B, T, input_size], lens [B] -> (h [B, 2T, dim], valid [B, 2T]).
        With `chunk_anchor` [B] (prompt tokens a row) the chunk grid starts
        at the prompt/generation boundary."""
        cfg = self.cfg
        T = xs.shape[1]
        chunk = cfg.static_chunk_size if (self.chunk_always or streaming) else 0
        anchored = chunk_anchor is not None and chunk > 0
        pad = make_non_pad_mask(lens, T)
        xs = self.embed(xs)
        pos_emb = espnet_rel_pos_emb(T, cfg.dim, xs.dtype, xs.device)
        attn_mask = (anchored_chunk_mask(pad, chunk, chunk_anchor) if anchored
                     else add_chunk_mask(pad, chunk))
        # zero pad rows before the right-looking lookahead conv (the embed
        # LayerNorm maps zeros to its bias, which would leak into valid rows)
        xs = self.pre_lookahead_layer(xs * pad[..., None].to(xs.dtype))
        for layer in self.encoders:
            xs = layer(xs, pos_emb, attn_mask, pad_mask=pad)
        xs = self.up_layer(xs)
        T2 = xs.shape[1]
        pad2 = make_non_pad_mask(lens * self.up_stride, T2)
        xs = self.up_embed(xs)
        pos_emb2 = espnet_rel_pos_emb(T2, cfg.dim, xs.dtype, xs.device)
        attn_mask2 = (anchored_chunk_mask(pad2, chunk * self.up_stride,
                                          torch.as_tensor(chunk_anchor) * self.up_stride)
                      if anchored else add_chunk_mask(pad2, chunk * self.up_stride))
        for layer in self.up_encoders:
            xs = layer(xs, pos_emb2, attn_mask2, pad_mask=pad2)
        return self.after_norm(xs), pad2


@dataclass
class ConformerKVCache:
    """Per-layer K/V [L, B, Tmax, H, D], written in place; `pos` is the
    filled length (one frontier for the batch); `tables` holds each layer's
    projected rel-pos table once a decode step has built it."""

    k: torch.Tensor
    v: torch.Tensor
    pos: int = 0
    tables: Optional[list] = None

    @staticmethod
    def create(cfg: ConformerConfig, batch: int, max_len: int, dtype=torch.float32,
               device=None) -> "ConformerKVCache":
        shape = (cfg.num_blocks, batch, max_len, cfg.heads, cfg.dim // cfg.heads)
        return ConformerKVCache(torch.zeros(shape, dtype=dtype, device=device),
                                torch.zeros(shape, dtype=dtype, device=device))


class ConformerEncoder(nn.Module):
    """The generic conformer (wenet's ConformerEncoder, or with
    `transformer_layer` its TransformerEncoder): linear embed -> layers ->
    after_norm, masked by key padding and, with static_chunk_size > 0, a
    static chunk mask (1: causal).  `prefill` / `decode_step` are its
    streaming twins over a ConformerKVCache (B=1 exact, as in the JAX
    package: one frontier for the batch)."""

    def __init__(self, cfg: ConformerConfig, transformer_layer: bool = False):
        super().__init__()
        self.cfg = cfg
        layer = TransformerEncoderLayer if transformer_layer else ConformerEncoderLayer
        self.embed = LinearEmbed(cfg.input_size, cfg.dim,
                                 legacy=cfg.input_layer == "linear_legacy",
                                 dropout_rate=cfg.dropout_rate)
        self.encoders = nn.ModuleList(layer(cfg) for _ in range(cfg.num_blocks))
        self.after_norm = LayerNorm(cfg.dim, 1e-5)

    def forward(self, xs: torch.Tensor, lens: torch.Tensor,
                spk_emb: Optional[torch.Tensor] = None):
        """xs [B, T, input_size], lens [B] -> (h [B, T, dim], valid [B, T]);
        spk_emb [B, spk_emb_size] (the raw speaker vector) feeds the
        spk_adapt layers and is ignored without them."""
        T = xs.shape[1]
        pad = make_non_pad_mask(lens, T)
        xs = self.embed(xs)
        pos_emb = espnet_rel_pos_emb(T, self.cfg.dim, xs.dtype, xs.device)
        attn_mask = add_chunk_mask(pad, self.cfg.static_chunk_size)
        for layer in self.encoders:
            xs = layer(xs, pos_emb, attn_mask, spk_emb, pad)
        return self.after_norm(xs), pad

    def prefill(self, xs: torch.Tensor, cache: ConformerKVCache):
        """Causal pass over xs [B, T, input_size] at cache slots pos..pos+T-1,
        writing the cache -> (h [B, T, dim], the cache advanced by T)."""
        B, T = xs.shape[:2]
        x = self.embed(xs)
        Tmax = cache.k.shape[2]
        rows = cache.pos + torch.arange(T, device=x.device)
        keep = torch.arange(Tmax, device=x.device)[None, :] <= rows[:, None]
        bias = torch.where(keep, 0.0, NEG_INF).to(x.dtype)[None].expand(B, T, Tmax)
        pos = torch.full((B,), cache.pos, dtype=torch.long, device=x.device)
        for i, layer in enumerate(self.encoders):
            x = layer.cached_rows(x, cache.k[i], cache.v[i], pos, bias)
        cache.pos += T
        return self.after_norm(x), cache

    def decode_step(self, x: torch.Tensor, cache: ConformerKVCache):
        """x [B, 1, input_size] -> (h [B, 1, dim], the cache advanced by 1)."""
        x = self.embed(x)
        Tmax = cache.k.shape[2]
        if cache.tables is None:
            cache.tables = [layer.self_attn.pos_table(Tmax, x.dtype, x.device)
                            for layer in self.encoders]
        valid = (torch.arange(Tmax, device=x.device) <= cache.pos)[None].expand(x.shape[0],
                                                                                  Tmax)
        for i, layer in enumerate(self.encoders):
            x = layer.decode(x, cache.k[i], cache.v[i], cache.pos, valid, cache.tables[i])
        cache.pos += 1
        return self.after_norm(x), cache
