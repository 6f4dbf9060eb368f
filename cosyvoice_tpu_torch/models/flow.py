"""Conditional flow matching: speech tokens -> mel (the CosyVoice2 "flow").

Port of cosyvoice_tpu/models/flow.py: the ConditionalDecoder estimator (a
UNet of ResnetBlock1D + DiT blocks), the Euler CFM sampler with batch-2
classifier-free guidance, and CausalMaskedDiffWithXvec (token embed ->
UpsampleConformerEncoder -> proj 80; L2-normalized speaker vector -> Linear
80; prompt mel as conditioning).  Channels-last [B, T, C] throughout.
Parameter names follow the reference checkpoint (`down_blocks.0.1.0.attn1.to_q`,
`mid_blocks.3.0.block1.block.0`, ...).  The estimator takes both topologies
of the JAX config: CosyVoice2's causal one level (`channels=(256,)`: causal
convs, LayerNorm + mish in Block1D) and CosyVoice v1's non-causal levels
(`channels=(256, 256)`: centred convs, GroupNorm(8) + mish in Block1D,
stride-2 conv down and k4 s2 transposed conv up between levels, each level
at its own mask `mask[:, ::2]`, skips saved before the downsample).

The serving estimator (`fused_attention` + `fused_norm` + `approx_gelu`, bf16)
runs its DiT attention through the `dit_attention_packed` kernel (each
level's own key lengths) and its LayerNorms (+mish) through the
`fused_layer_norm` kernel; with `fused_block` as well, each whole DiT block
is one `dit_block_fused` call where T is a multiple of 128.  The causal
estimator pads T to a multiple of 128 on that route, as the JAX package
does (exact: every row is normalized on its own and the convs look left);
the non-causal one does not, since its GroupNorm statistics span the pad
rows (the JAX package's fused route would move them; its v1 runtime keeps
that route off), so K4 does not take it and its attention and norms go
through K2 and K3 unpadded.  Without
`fused_attention` the DiT attention is plain PyTorch with an additive bias:
true -inf key masking under `exact_pad_mask`, else the reference's 0/1 float
mask used verbatim as a bias.

`streaming` (the non-final chunks of streaming synthesis) threads through
the flow, the CFM and the estimator.  It changes nothing for the main
path's estimator family (`stream=False`, which keeps its fused route); the
stream family (`stream=True`, the reference's StreamConditionalDecoder)
attends under a -inf key-pad bias, and with `streaming` under a static
chunk mask of `static_chunk_size` mel frames and `left_chunks` chunks of
left context.  The flow encoder applies its chunk mask always for
`stream=False` and only while streaming for `stream=True`.  `chunk_anchor`
(prompt tokens a row) anchors the stream family's chunk grid at the
prompt/generation boundary (ops/masks.anchored_chunk_mask): the one-shot
twin of the incremental flow (models/flow_chunk.py), which drives the
`.chunk` steps of Block1D, ResnetBlock1D and DiTBlock below.

CosyVoice v1's flow is MaskedDiffWithXvec: token embed -> ConformerEncoder
-> proj 80 -> InterpolateRegulator to the mel rate (the prompt and the
generated part interpolated apart, the generated part's first and last 20
tokens on their own) -> ConditionalCFM, whose noise is fresh each call (the
caller's draw: runtime/model.py's CosyVoiceV1Model takes it from the
session's generator) and whose `flow_cache` pins the prompt's and the last
34 frames' noise and mu across streamed chunks.

Training: `CausalConditionalCFM.compute_loss` (the masked OT-CFM loss at a
cosine-scheduled t, with CFG dropout at training_cfg_rate) and the two
flows' `forward` (the loss, with a 0-30% prompt prefix as conditioning in
half the rows).  Their random draws come from a torch.Generator, or from a
`FlowDraws` given by the caller (tests pin the JAX package's draws with
it).  The kernels have no backward, so a grad-enabled estimator call on a
route through K2/K3/K4 raises.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from cosyvoice_tpu_torch.models.conformer import (ConformerConfig, ConformerEncoder,
                                                  UpsampleConformerEncoder)
from cosyvoice_tpu_torch.nn.conv import CausalConv1d, Conv1d, ConvTranspose1d
from cosyvoice_tpu_torch.nn.dense import Dense
from cosyvoice_tpu_torch.nn.norm import GroupNorm, LayerNorm
from cosyvoice_tpu_torch.ops.activations import mish
from cosyvoice_tpu_torch.ops.kernels import dit_block
from cosyvoice_tpu_torch.ops.kernels.dit_attention import dit_attention_packed
from cosyvoice_tpu_torch.ops.masks import (NEG_INF, add_chunk_mask, anchored_chunk_mask,
                                          make_non_pad_mask)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def sinusoidal_time_emb(t: torch.Tensor, dim: int, scale: float = 1000.0) -> torch.Tensor:
    """[B] -> [B, dim] (Matcha SinusoidalPosEmb); call with fp32 t."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=t.dtype, device=t.device)
                      * -(math.log(10000.0) / (half - 1)))
    ang = scale * t[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_channels: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = Dense(in_channels, time_embed_dim)
        self.linear_2 = Dense(time_embed_dim, time_embed_dim)

    def forward(self, t_emb):
        return self.linear_2(F.silu(self.linear_1(t_emb)))


class Block1D(nn.Module):
    """conv3 -> norm + mish, masked: causal, the reference CausalBlock1D
    (LayerNorm, fused with the mish on the serving route); non-causal, the
    Matcha Block1D (GroupNorm(8))."""

    def __init__(self, dim_in: int, dim_out: int, fused_norm: bool = False,
                 causal: bool = True, groups: int = 8):
        super().__init__()
        self.causal = causal
        if causal:
            self.block = nn.ModuleList([CausalConv1d(dim_in, dim_out, 3), nn.Identity(),
                                        LayerNorm(dim_out, fused=fused_norm, act="mish")])
        else:
            self.block = nn.ModuleList([Conv1d(dim_in, dim_out, 3, padding=1),
                                        GroupNorm(groups, dim_out)])

    def forward(self, x, mask):
        m = mask[..., None]
        h = self.block[0](x * m)
        return (self.block[2](h) if self.causal else mish(self.block[1](h))) * m

    def chunk(self, x, mask, hist):
        """Causal step over N new rows x [B, N, C] with hist [B, 2, C] the
        stream's last two valid conv inputs (x * mask): the conv's own left
        pad is replaced by the history and its two outputs are dropped.
        -> (out [B, N, C], conv inputs [B, 2 + N, C] for the history roll)."""
        if not self.causal:
            raise ValueError("Block1D.chunk takes the causal block only")
        m = mask[..., None]
        xin = torch.cat([hist, x * m], dim=1)
        return self.block[2](self.block[0](xin)[:, 2:]) * m, xin


class ResnetBlock1D(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, time_emb_dim: int,
                 fused_norm: bool = False, causal: bool = True):
        super().__init__()
        self.block1 = Block1D(dim_in, dim_out, fused_norm, causal)
        self.block2 = Block1D(dim_out, dim_out, fused_norm, causal)
        self.mlp = nn.ModuleList([nn.Identity(), Dense(time_emb_dim, dim_out)])
        self.res_conv = Conv1d(dim_in, dim_out, 1)

    def forward(self, x, mask, t):
        h = self.block1(x, mask)
        h = h + self.mlp[1](mish(t))[:, None, :]
        h = self.block2(h, mask)
        return h + self.res_conv(x * mask[..., None])

    def chunk(self, x, mask, t, h1, h2):
        """Chunk step with the two convs' histories h1/h2 (Block1D.chunk).
        -> (out, block1 inputs, block2 inputs) for the history rolls."""
        h, x1 = self.block1.chunk(x, mask, h1)
        h = h + self.mlp[1](mish(t))[:, None, :]
        h, x2 = self.block2.chunk(h, mask, h2)
        return h + self.res_conv(x * mask[..., None]), x1, x2


def _block_layout(params, dtype) -> tuple:
    """(wq, wk, wv, wo, bo, g1, b1, g3, b3, wi, bi, wo2, bo2) in torch's layout
    -> dit_block_fused's operands: [in, out] matrices in `dtype`, fp32
    vectors."""
    wq, wk, wv, wo, bo, g1, b1, g3, b3, wi, bi, wo2, bo2 = params
    mat = lambda w: w.t().to(dtype).contiguous()  # noqa: E731
    return tuple(v.float().contiguous() if v.ndim == 1 else mat(v) for v in
                 (g1, b1, torch.cat([wq, wk, wv], 0), wo, bo, g3, b3, wi, bi, wo2, bo2))


class DiTBlock(nn.Module):
    """diffusers BasicTransformerBlock (self-attention + gelu FF)."""

    def __init__(self, dim: int, heads: int, head_dim: int, ff_mult: int = 4,
                 approx_gelu: bool = False, fused_norm: bool = False,
                 fused_block: bool = False):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim, self.approx_gelu = heads, head_dim, approx_gelu
        self.fused_block = fused_block
        self._block_weights = (None, None)     # (key, weights) for dit_block_fused
        self.norm1 = LayerNorm(dim, fused=fused_norm)
        self.attn1 = nn.ModuleDict({
            "to_q": Dense(dim, inner, bias=False), "to_k": Dense(dim, inner, bias=False),
            "to_v": Dense(dim, inner, bias=False),
            "to_out": nn.ModuleList([Dense(inner, dim)])})
        self.norm3 = LayerNorm(dim, fused=fused_norm)
        self.ff = nn.ModuleDict({"net": nn.ModuleList([
            nn.ModuleDict({"proj": Dense(dim, dim * ff_mult)}), nn.Identity(),
            Dense(dim * ff_mult, dim)])})

    def fused_weights(self, dtype) -> tuple:
        """The block's parameters in dit_block_fused's order and JAX layout
        ([in, out] matrices in `dtype`, fp32 vectors), rebuilt only when a
        parameter or the dtype changes."""
        a, net = self.attn1, self.ff["net"]
        params = (a["to_q"].weight, a["to_k"].weight, a["to_v"].weight, a["to_out"][0].weight,
                  a["to_out"][0].bias, self.norm1.weight, self.norm1.bias, self.norm3.weight,
                  self.norm3.bias, net[0]["proj"].weight, net[0]["proj"].bias, net[2].weight,
                  net[2].bias)
        if torch.compiler.is_compiling():
            # traced (torch.export): the layout ops go into the graph; a
            # traced tensor has no storage to key the cache on
            return _block_layout(params, dtype)
        key = (dtype,) + tuple((p.data_ptr(), p._version) for p in params)
        if self._block_weights[0] != key:
            self._block_weights = (key, _block_layout([p.detach() for p in params], dtype))
        return self._block_weights[1]

    def forward(self, x, attn_bias: Optional[torch.Tensor],
                lengths: Optional[torch.Tensor] = None):
        """attn_bias [B, 1|T, T] is added to the scores verbatim; with
        `lengths` [B] int32 the kernel path masks keys at j >= lengths[b]
        instead (the pad mask must be prefix-contiguous).  With `lengths`,
        `fused_block` and `approx_gelu`, the whole block is one
        dit_block_fused call where its shape contract holds."""
        B, T, dim = x.shape
        H, hd = self.heads, self.head_dim
        a = self.attn1
        ff = self.ff["net"][2].weight.shape[1]
        if (lengths is not None and self.fused_block and self.approx_gelu
                and dit_block.supports(T, H, hd, dim, ff)):
            return dit_block.dit_block_fused(x, lengths, *self.fused_weights(x.dtype),
                                             sm_scale=1.0 / math.sqrt(hd), heads=H,
                                             head_dim=hd)
        h = self.norm1(x)
        w = torch.cat([a["to_q"].weight, a["to_k"].weight, a["to_v"].weight], 0)
        qkv = h @ w.to(h.dtype).t()
        if lengths is not None:
            o = dit_attention_packed(qkv.contiguous(), lengths, 1.0 / math.sqrt(hd), hd)
        else:
            q, k, v = (qkv[..., i * H * hd:(i + 1) * H * hd].reshape(B, T, H, hd)
                       for i in range(3))
            scores = torch.einsum("bihd,bjhd->bhij", q, k) / math.sqrt(hd)
            if attn_bias is not None:
                scores = scores + attn_bias[:, None]
            o = torch.einsum("bhij,bjhd->bihd", torch.softmax(scores, dim=-1),
                             v).reshape(B, T, H * hd)
        return self._out_ffn(x, o)

    def _out_ffn(self, x, o):
        """Out-projection + residual, then LN3 -> gelu FFN + residual."""
        x = x + self.attn1["to_out"][0](o)
        net = self.ff["net"]
        h = F.gelu(net[0]["proj"](self.norm3(x)),
                   approximate="tanh" if self.approx_gelu else "none")
        return x + net[2](h)

    def chunk(self, x, kv_cache, bias):
        """Incremental step: x [B, N, dim] new rows; kv_cache [B, R, 2, inner]
        the K/V of the retained left-context rows; bias [B, N, R + N] additive
        (cached keys first).  The blocks carry no positional encoding, so only
        the bias encodes structure.  Plain PyTorch attention, as in the JAX
        package.  -> (x_out, k_new, v_new [B, N, inner])."""
        B, N, _ = x.shape
        H, hd = self.heads, self.head_dim
        a = self.attn1
        h = self.norm1(x)
        w = torch.cat([a["to_q"].weight, a["to_k"].weight, a["to_v"].weight], 0)
        q, k_new, v_new = (h @ w.to(h.dtype).t()).split(H * hd, dim=-1)
        k = torch.cat([kv_cache[:, :, 0].to(h.dtype), k_new], dim=1)
        v = torch.cat([kv_cache[:, :, 1].to(h.dtype), v_new], dim=1)
        scores = torch.einsum("bihd,bjhd->bhij", q.reshape(B, N, H, hd),
                              k.reshape(B, -1, H, hd)) / math.sqrt(hd)
        attn = torch.softmax(scores + bias[:, None], dim=-1)
        o = torch.einsum("bhij,bjhd->bihd", attn, v.reshape(B, -1, H, hd)).reshape(B, N, H * hd)
        return self._out_ffn(x, o), k_new, v_new


@dataclass(frozen=True)
class EstimatorConfig:
    in_channels: int = 320  # x(80) + mu(80) + spks(80) + cond(80)
    out_channels: int = 80
    causal: bool = True
    channels: Sequence[int] = (256,)  # one width a level
    n_blocks: int = 4
    num_mid_blocks: int = 12
    num_heads: int = 8
    attention_head_dim: int = 64
    # serving: DiT attention through the dit_attention kernel (true pad-key
    # masking; the causal estimator pads T to a multiple of 128 as the JAX
    # package does, the non-causal one does not)
    fused_attention: bool = False
    dtype: str = "float32"          # compute dtype: "float32" | "bfloat16"
    approx_gelu: bool = False       # tanh-approximate gelu in the DiT FFN
    fused_norm: bool = False        # LayerNorm(+mish) through fused_layer_norm
    # serving: each whole DiT block through the dit_block_fused kernel (with
    # fused_attention and approx_gelu; the JAX package keeps it off on the
    # TPU for a compile-time hazard that the GPU does not have)
    fused_block: bool = False
    # the stream family: chunk-masked attention while streaming (mel frames a
    # chunk, chunks of left context; -1 = all)
    stream: bool = False
    static_chunk_size: int = 50
    left_chunks: int = -1


class Downsample1D(nn.Module):
    """conv k3 s2 p1 between two non-causal levels."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv1d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample1DT(nn.Module):
    """Matcha's Upsample1D(use_conv_transpose=True): convT k4 s2 p1."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = ConvTranspose1d(channels, channels, 4, 2, padding=1)

    def forward(self, x):
        return self.conv(x)


class ConditionalDecoder(nn.Module):
    """The CFM estimator v(x, mu, t, spk, cond) on [B, T, C]: one down level a
    width (resnet + DiT blocks, then a stride-2 conv, or a closing conv after
    the last), num_mid_blocks more at the last level's rate, then the up
    levels in reverse (each fed the matching down level's output as a skip,
    then a transposed conv, or a closing conv after the last)."""

    def __init__(self, cfg: EstimatorConfig):
        super().__init__()
        self.cfg = cfg
        chans = tuple(cfg.channels)
        self.time_mlp = TimestepEmbedding(cfg.in_channels, 4 * chans[0])

        def closing_conv(ch):
            return CausalConv1d(ch, ch, 3) if cfg.causal else Conv1d(ch, ch, 3, padding=1)

        def level(dim_in, ch, resample=None):
            blocks = [ResnetBlock1D(dim_in, ch, 4 * chans[0], cfg.fused_norm, cfg.causal),
                      nn.ModuleList(DiTBlock(ch, cfg.num_heads, cfg.attention_head_dim,
                                             approx_gelu=cfg.approx_gelu,
                                             fused_norm=cfg.fused_norm,
                                             fused_block=cfg.fused_block)
                                    for _ in range(cfg.n_blocks))]
            return nn.ModuleList(blocks + ([resample] if resample is not None else []))

        n = len(chans)
        self.down_blocks = nn.ModuleList(
            level(cfg.in_channels if i == 0 else chans[i - 1], ch,
                  closing_conv(ch) if i == n - 1 else Downsample1D(ch))
            for i, ch in enumerate(chans))
        self.mid_blocks = nn.ModuleList(level(chans[-1], chans[-1])
                                        for _ in range(cfg.num_mid_blocks))
        up = chans[::-1] + (chans[0],)
        self.up_blocks = nn.ModuleList(
            level(2 * up[i], up[i + 1],
                  closing_conv(up[i + 1]) if i == n - 1 else Upsample1DT(up[i + 1]))
            for i in range(n))
        self.final_block = Block1D(chans[0], chans[0], cfg.fused_norm, cfg.causal)
        self.final_proj = Conv1d(chans[0], cfg.out_channels, 1)

    def time_embed(self, t: torch.Tensor, cdt) -> torch.Tensor:
        """[B] t -> [B, time_dim]; the angles reach `scale` rad, so they stay
        fp32 and only the embedding is cast."""
        return self.time_mlp(sinusoidal_time_emb(t.float(), self.cfg.in_channels).to(cdt))

    def _attention_mask(self, m, cdt, serving_fast: bool, streaming: bool, exact_pad_mask: bool,
                        chunk_anchor):
        """A level's (additive bias [B, T|1, T], kernel key lengths [B]) for
        its mask m [B, T]: one of them is None."""
        cfg = self.cfg
        if serving_fast:
            return None, (m > 0).sum(dim=1).to(torch.int32)
        if cfg.stream and streaming and chunk_anchor is not None:
            keep = anchored_chunk_mask(m > 0, cfg.static_chunk_size, chunk_anchor,
                                       cfg.left_chunks)
        elif cfg.stream:
            keep = add_chunk_mask(m > 0, cfg.static_chunk_size if streaming else 0,
                                  cfg.left_chunks)
        elif exact_pad_mask:
            keep = m[:, None, :] > 0
        else:
            # the reference's 0/1 float mask, added to the scores verbatim
            return (m[:, :, None] * m[:, None, :]).to(cdt), None
        return torch.where(keep, 0.0, NEG_INF).to(cdt), None

    def forward(self, x, mask, mu, t, spks, cond, streaming: bool = False,
                exact_pad_mask: bool = False, chunk_anchor: Optional[torch.Tensor] = None):
        """x/mu/cond [B, T, C], mask [B, T] float, t [B], spks [B, C] ->
        [B, T, out_channels] fp32.  chunk_anchor [B] (mel rows) anchors the
        stream family's streaming chunk grid."""
        cfg = self.cfg
        if torch.is_grad_enabled() and (cfg.fused_attention or cfg.fused_norm
                                        or cfg.fused_block):
            raise RuntimeError("the estimator's fused route (K2/K3/K4) has no backward: "
                               "train with fused_attention, fused_norm and fused_block "
                               "off, or call it under torch.no_grad()")
        cdt = _DTYPES[cfg.dtype]
        x, mu, spks, cond, mask = (v.to(cdt) for v in (x, mu, spks, cond, mask))
        t_emb = self.time_embed(t, cdt)
        T_in = x.shape[1]
        serving_fast = cfg.fused_attention and not (cfg.stream and streaming)
        if serving_fast and cfg.causal and T_in % 128:
            grow = (0, 0, 0, -T_in % 128)
            x, mu, cond = (F.pad(v, grow) for v in (x, mu, cond))
            mask = F.pad(mask, (0, -T_in % 128))
        T = x.shape[1]
        masks = [mask]                          # one a level: mask[:, ::2] below
        for _ in range(len(self.down_blocks) - 1):
            masks.append(masks[-1][:, ::2])
        attn = [self._attention_mask(m, cdt, serving_fast, streaming, exact_pad_mask,
                                     chunk_anchor) for m in masks]

        def blocks(h, lvl, i):
            resnet, tbs = lvl[0], lvl[1]
            h = resnet(h, masks[i], t_emb)
            for tb in tbs:
                h = tb(h, *attn[i])
            return h

        h = torch.cat([x, mu, spks[:, None, :].expand(-1, T, -1), cond], dim=-1)
        skips = []
        for i, lvl in enumerate(self.down_blocks):
            h = blocks(h, lvl, i)
            skips.append(h)                     # saved before the downsample
            h = lvl[2](h * masks[i][..., None])
        last = len(masks) - 1
        for lvl in self.mid_blocks:
            h = blocks(h, lvl, last)
        for i, lvl in enumerate(self.up_blocks):
            skip = skips.pop()
            h = blocks(torch.cat([h[:, :skip.shape[1]], skip], dim=-1), lvl, last - i)
            h = lvl[2](h * masks[last - i][..., None])
        m = mask[..., None]
        out = self.final_proj(self.final_block(h, mask) * m)
        return (out * m).float()[:, :T_in]


@dataclass(frozen=True)
class CFMConfig:
    # the training loss (compute_loss): the OT path's floor, t's schedule and
    # the share of rows trained without conditioning
    sigma_min: float = 1e-6
    t_scheduler: str = "cosine"
    training_cfg_rate: float = 0.2
    inference_cfg_rate: float = 0.7
    noise_frames: int = 15000  # 50 fps * 300 s pinned-noise buffer
    n_timesteps: int = 10      # Euler steps of the incremental flow (flow_chunk)


@lru_cache(maxsize=None)
def reference_rand_noise(frames: int = 15000, channels: int = 80) -> torch.Tensor:
    """The reference's pinned CFM noise: a CPU generator seeded 0 draws
    randn([1, channels, 15000]) once and each synthesis slices it; returned
    as [1, frames, channels] on the CPU (callers move it to their device: a
    CUDA draw would be a different stream)."""
    g = torch.Generator().manual_seed(0)
    buf = torch.randn([1, channels, 15000], generator=g)
    return buf[:, :, :frames].permute(0, 2, 1).contiguous()


def cosine_t_span(n_timesteps: int, dtype=torch.float32, device=None) -> torch.Tensor:
    ts = torch.linspace(0.0, 1.0, n_timesteps + 1, dtype=dtype, device=device)
    return 1.0 - torch.cos(ts * 0.5 * math.pi)


@dataclass
class FlowDraws:
    """The random draws of one flow training loss: use_cond [B] bool (rows
    conditioned on a prompt prefix), frac [B] (the prefix's share of 30%),
    t [B] uniform (before the cosine schedule), z [B, T, C] noise, keep [B]
    bool (rows that keep their conditioning under CFG dropout)."""

    use_cond: torch.Tensor
    frac: torch.Tensor
    t: torch.Tensor
    z: torch.Tensor
    keep: torch.Tensor

    @staticmethod
    def draw(gen: torch.Generator, B: int, T: int, C: int, cfg_rate: float) -> "FlowDraws":
        """The JAX draws' distributions, from `gen` on its device."""
        dev = gen.device
        rand = lambda *shape: torch.rand(shape, generator=gen, device=dev)
        use_cond, frac, t = rand(B) < 0.5, rand(B), rand(B)
        z = torch.randn((B, T, C), generator=gen, device=dev)
        keep = rand(B) > cfg_rate if cfg_rate > 0 else torch.ones(B, dtype=torch.bool,
                                                                   device=dev)
        return FlowDraws(use_cond, frac, t, z, keep)

    @staticmethod
    def draw_rows(gen: torch.Generator, B: int, T: int, C: int, cfg_rate: float,
                  rows: Optional[tuple] = None) -> "FlowDraws":
        """draw() for B rows, or with rows = (start, total) rows [start,
        start + B) of the draws of a total-row batch: a data-parallel rank's
        share of the whole batch's draws (train/step.shard_batch)."""
        if rows is None:
            return FlowDraws.draw(gen, B, T, C, cfg_rate)
        start, total = rows
        d = FlowDraws.draw(gen, total, T, C, cfg_rate)
        return FlowDraws(*(getattr(d, f.name)[start:start + B]
                           for f in dataclasses.fields(FlowDraws)))


def prompt_prefix_cond(feat, feat_len, draws: FlowDraws) -> torch.Tensor:
    """The flows' training conditioning: in the use_cond rows the first
    int(frac * 0.3 * feat_len) mel frames of feat [B, T, C], zeros elsewhere."""
    dev = feat.device
    idx = (draws.frac.to(dev) * 0.3 * feat_len).to(torch.int32)
    pos = torch.arange(feat.shape[1], device=dev)[None, :]
    keep = (pos < idx[:, None]) & draws.use_cond.to(dev)[:, None]
    return torch.where(keep[..., None], feat, torch.zeros_like(feat))


class CausalConditionalCFM(nn.Module):
    """Euler OT-CFM sampler around a ConditionalDecoder estimator."""

    def __init__(self, cfg: CFMConfig = CFMConfig(),
                 est_cfg: EstimatorConfig = EstimatorConfig()):
        super().__init__()
        self.cfg = cfg
        self.estimator = ConditionalDecoder(est_cfg)

    def forward(self, mu, mask, spks, cond, n_timesteps: int = 10,
                temperature: float = 1.0, noise: Optional[torch.Tensor] = None,
                streaming: bool = False, exact_pad_mask: bool = False,
                chunk_anchor: Optional[torch.Tensor] = None):
        """mu [B,T,80], mask [B,T] float, spks [B,80], cond [B,T,80] -> mel [B,T,80]."""
        B, T, C = mu.shape
        if noise is None:
            noise = reference_rand_noise(self.cfg.noise_frames, C)[:, :T]
        z = (noise.to(device=mu.device, dtype=mu.dtype) * temperature).expand(B, T, C)
        return self.solve_euler(z, n_timesteps, mu, mask, spks, cond, streaming,
                                exact_pad_mask, chunk_anchor)

    def solve_euler(self, z, n_timesteps: int, mu, mask, spks, cond, streaming: bool = False,
                    exact_pad_mask: bool = False, chunk_anchor=None):
        """Fixed-step Euler over the cosine t schedule from z, each step one
        estimator call on the CFG pair [cond; uncond]."""
        B = z.shape[0]
        t_span = cosine_t_span(n_timesteps, mu.dtype, mu.device)
        r = self.cfg.inference_cfg_rate
        mask2 = torch.cat([mask, mask])
        mu2 = torch.cat([mu, torch.zeros_like(mu)])
        spks2 = torch.cat([spks, torch.zeros_like(spks)])
        cond2 = torch.cat([cond, torch.zeros_like(cond)])
        anchor2 = None if chunk_anchor is None else torch.cat([chunk_anchor, chunk_anchor])
        x = z
        for i in range(n_timesteps):
            t, dt = t_span[i], t_span[i + 1] - t_span[i]
            v = self.estimator(torch.cat([x, x]), mask2, mu2, t.expand(2 * B), spks2,
                               cond2, streaming, exact_pad_mask=exact_pad_mask,
                               chunk_anchor=anchor2)
            x = x + dt * ((1.0 + r) * v[:B] - r * v[B:])
        return x

    def compute_loss(self, x1, mask, mu, spks, cond, draws: FlowDraws,
                     streaming: bool = False):
        """Masked OT-CFM MSE: x1 / mu / cond [B, T, C] (x1 the target mel),
        mask [B, T] float, spks [B, C] -> (loss, y), the loss divided by
        sum(mask) * C."""
        cfg = self.cfg
        B, T, C = mu.shape
        dev, dt = mu.device, mu.dtype
        t = draws.t.to(device=dev, dtype=dt)[:, None, None]
        if cfg.t_scheduler == "cosine":
            t = 1.0 - torch.cos(t * 0.5 * math.pi)
        z = draws.z.to(device=dev, dtype=x1.dtype)
        y = (1.0 - (1.0 - cfg.sigma_min) * t) * z + t * x1
        u = x1 - (1.0 - cfg.sigma_min) * z
        if cfg.training_cfg_rate > 0:
            keep = draws.keep.to(device=dev, dtype=dt)
            mu = mu * keep[:, None, None]
            spks = spks * keep[:, None]
            cond = cond * keep[:, None, None]
        pred = self.estimator(y, mask, mu, t[:, 0, 0], spks, cond, streaming)
        m = mask[..., None]
        loss = torch.sum(((pred - u) * m) ** 2) / (torch.sum(mask) * C)
        return loss, y


@dataclass(frozen=True)
class FlowConfig:
    input_size: int = 512
    output_size: int = 80
    spk_embed_dim: int = 192
    vocab_size: int = 6561
    input_frame_rate: int = 25
    token_mel_ratio: int = 2
    pre_lookahead_len: int = 3
    encoder: ConformerConfig = field(default_factory=lambda: ConformerConfig(
        dim=512, heads=8, linear_units=2048, num_blocks=6, input_size=512,
        static_chunk_size=50))
    cfm: CFMConfig = field(default_factory=CFMConfig)
    estimator: EstimatorConfig = field(default_factory=EstimatorConfig)
    encoder_dtype: str = "float32"  # conformer compute dtype


class CausalMaskedDiffWithXvec(nn.Module):
    """CosyVoice2 flow model: tokens -> mel."""

    def __init__(self, cfg: FlowConfig = FlowConfig()):
        super().__init__()
        self.cfg = cfg
        self.input_embedding = nn.Embedding(cfg.vocab_size, cfg.input_size)
        self.spk_embed_affine_layer = Dense(cfg.spk_embed_dim, cfg.output_size)
        self.encoder = UpsampleConformerEncoder(cfg.encoder, up_blocks=4,
                                                pre_lookahead_len=cfg.pre_lookahead_len,
                                                up_stride=cfg.token_mel_ratio,
                                                chunk_always=not cfg.estimator.stream)
        self.encoder_proj = Dense(cfg.encoder.dim, cfg.output_size)
        self.decoder = CausalConditionalCFM(cfg.cfm, cfg.estimator)

    def _encode(self, token, token_len, streaming: bool = False, chunk_anchor=None):
        mask = make_non_pad_mask(token_len, token.shape[1])
        emb = self.input_embedding(token.clamp_min(0)) * mask[..., None]
        h, pad2 = self.encoder(emb.to(_DTYPES[self.cfg.encoder_dtype]), token_len, streaming,
                               chunk_anchor)
        return self.encoder_proj(h.float()), pad2

    def forward(self, token, token_len, feat, feat_len, embedding,
                gen: Optional[torch.Generator] = None, draws: Optional[FlowDraws] = None,
                streaming: bool = False, rows: Optional[tuple] = None) -> dict:
        """Training loss: token [B, Tt], feat [B, Tf, 80] the target mel
        (Tf >= ratio * Tt; cut to the encoder's rows), embedding [B, spk] ->
        {"loss", "denom"} (denom: the count the loss is divided by).  Draws
        from `gen` (rows: FlowDraws.draw_rows), or the given `draws`."""
        spks = embedding / embedding.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        spks = self.spk_embed_affine_layer(spks)
        h, _ = self._encode(token, token_len, streaming)
        B, T2, C = h.shape
        feat = feat[:, :T2]
        feat_len = feat_len.clamp_max(T2)
        if draws is None:
            draws = FlowDraws.draw_rows(gen, B, T2, C, self.cfg.cfm.training_cfg_rate, rows)
        conds = prompt_prefix_cond(feat, feat_len, draws)
        mask = make_non_pad_mask(feat_len, T2).to(h.dtype)
        loss, _ = self.decoder.compute_loss(feat, mask, h, spks, conds, draws, streaming)
        return {"loss": loss, "denom": mask.sum().float() * C}

    @torch.no_grad()
    def inference(self, token, token_len, prompt_feat, embedding, n_timesteps: int = 10,
                  noise: Optional[torch.Tensor] = None,
                  prompt_feat_len: Optional[torch.Tensor] = None,
                  streaming: bool = False,
                  chunk_anchor: Optional[torch.Tensor] = None) -> torch.Tensor:
        """token [B, Tp+Tg] (prompt ++ generated), prompt_feat [B, P, 80] with
        P = ratio * prompt token count, embedding [B, spk_embed_dim]
        -> mel [B, ratio*T - P, 80].

        With `prompt_feat_len` [B] (ragged batched serving: each row's prompt
        right-padded to a shared P) the conditioning is zeroed past each
        row's prompt and the whole mel [B, ratio*T, 80] is returned; the
        caller keeps row b's [prompt_feat_len[b], ratio*token_len[b]).
        `chunk_anchor` [B] (prompt tokens a row) anchors the streaming chunk
        grid at the prompt/generation boundary, in the encoder and, for the
        stream family, in the estimator."""
        spks = embedding / embedding.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        spks = self.spk_embed_affine_layer(spks)
        if chunk_anchor is not None:
            chunk_anchor = torch.as_tensor(chunk_anchor, device=token.device).reshape(-1)
        h, _ = self._encode(token, token_len, streaming, chunk_anchor)
        P, T2 = prompt_feat.shape[1], h.shape[1]
        conds = torch.zeros((h.shape[0], T2, self.cfg.output_size), dtype=h.dtype,
                            device=h.device)
        conds[:, :P] = prompt_feat.to(h.dtype)
        if prompt_feat_len is not None:
            keep = (torch.arange(T2, device=h.device)[None, :]
                    < prompt_feat_len.to(h.device)[:, None])
            conds = conds.masked_fill(~keep[..., None], 0.0)
        mask = make_non_pad_mask(token_len * self.cfg.token_mel_ratio, T2).to(h.dtype)
        feat = self.decoder(h, mask, spks, conds, n_timesteps=n_timesteps, noise=noise,
                            streaming=streaming, exact_pad_mask=True,
                            chunk_anchor=None if chunk_anchor is None
                            else chunk_anchor * self.cfg.token_mel_ratio)
        return feat if prompt_feat_len is not None else feat[:, P:]


# --------------------------------------------------------------------------
# CosyVoice v1: MaskedDiffWithXvec (length-regulated, non-causal CFM with a
# flow cache)
# --------------------------------------------------------------------------

def interp_linear(x: torch.Tensor, new_len: int) -> torch.Tensor:
    """F.interpolate(mode='linear', align_corners=False) along T of [B, T, C]."""
    T = x.shape[1]
    pos = (torch.arange(new_len, device=x.device, dtype=torch.float32) + 0.5) * T / new_len - 0.5
    lo = pos.floor().long().clamp(0, T - 1)
    hi = (lo + 1).clamp(0, T - 1)
    w = (pos - lo).clamp(0.0, 1.0)[None, :, None].to(x.dtype)
    return x[:, lo] * (1 - w) + x[:, hi] * w


class InterpolateRegulator(nn.Module):
    """Linear interpolation to the mel rate, then n_stages x (conv3 ->
    GroupNorm -> mish) and a 1x1 conv (reference flow/length_regulator.py;
    its `model.{3i}` conv / `model.{3i+1}` norm / `model.{3n}` head)."""

    def __init__(self, channels: int, n_stages: int = 4, groups: int = 1):
        super().__init__()
        layers = []
        for _ in range(n_stages):
            layers += [Conv1d(channels, channels, 3, padding=1), GroupNorm(groups, channels),
                       nn.Identity()]
        self.model = nn.ModuleList(layers + [Conv1d(channels, channels, 1)])
        self.n_stages = n_stages

    def _model(self, x):
        for i in range(self.n_stages):
            x = mish(self.model[3 * i + 1](self.model[3 * i](x)))
        return self.model[3 * self.n_stages](x)

    def forward(self, x, ylens, out_len: int):
        """x [B, T, C] -> [B, out_len, C], zero past ylens [B]."""
        mask = make_non_pad_mask(ylens, out_len).to(x.dtype)[..., None]
        return self._model(interp_linear(x, out_len)) * mask

    def inference(self, x1, x2, mel_len1: int, mel_len2: int, input_frame_rate: int = 50,
                  sample_rate: int = 22050):
        """The prompt part x1 and the generated part x2 interpolated apart;
        past 40 tokens, x2's first and last 20 tokens each become a fixed
        `edge` of frames and the middle the rest, to keep the edges clean."""
        if x2.shape[1] > 40:
            edge = int(20 / input_frame_rate * sample_rate / 256)
            x2 = torch.cat([interp_linear(x2[:, :20], edge),
                            interp_linear(x2[:, 20:-20], mel_len2 - 2 * edge),
                            interp_linear(x2[:, -20:], edge)], dim=1)
        else:
            x2 = interp_linear(x2, mel_len2)
        x = torch.cat([interp_linear(x1, mel_len1), x2], dim=1) if x1.shape[1] else x2
        return self._model(x)


class ConditionalCFM(CausalConditionalCFM):
    """The v1 CFM: fresh gaussian noise each call, and a flow cache that pins
    the noise and mu of the prompt's frames and of the last 34 frames across
    the chunks of a stream."""

    def forward(self, mu, mask, spks, cond, noise: torch.Tensor, n_timesteps: int = 10,
                temperature: float = 1.0, prompt_len: int = 0, flow_cache=None):
        """mu [B, T, 80], mask [B, T] float, noise [B, T, 80] (the call's
        fresh draw); flow_cache None or (z, mu) [B, Lc, 80] -> (mel [B, T,
        80], the new flow cache)."""
        z = noise.to(device=mu.device, dtype=mu.dtype) * temperature
        if flow_cache is not None:
            n = min(flow_cache[0].shape[1], mu.shape[1])
            z, mu = z.clone(), mu.clone()
            z[:, :n] = flow_cache[0][:, :n]
            mu[:, :n] = flow_cache[1][:, :n]
        cache = (torch.cat([z[:, :prompt_len], z[:, -34:]], dim=1),
                 torch.cat([mu[:, :prompt_len], mu[:, -34:]], dim=1))
        return self.solve_euler(z, n_timesteps, mu, mask, spks, cond), cache


@dataclass(frozen=True)
class FlowV1Config:
    """The CosyVoice-300M flow (the reference's cosyvoice.yaml)."""

    input_size: int = 512
    output_size: int = 80
    spk_embed_dim: int = 192
    vocab_size: int = 4096
    input_frame_rate: int = 25
    encoder: ConformerConfig = field(default_factory=lambda: ConformerConfig(
        dim=512, heads=8, linear_units=2048, num_blocks=6, input_size=512))
    cfm: CFMConfig = field(default_factory=CFMConfig)
    estimator: EstimatorConfig = field(default_factory=lambda: EstimatorConfig(
        in_channels=320, out_channels=80, causal=False, channels=(256, 256),
        n_blocks=4, num_mid_blocks=12, num_heads=8, attention_head_dim=64))
    regulator_stages: int = 4


class MaskedDiffWithXvec(nn.Module):
    """The CosyVoice v1 flow model: tokens -> mel at 22.05 kHz / 256 hop."""

    def __init__(self, cfg: FlowV1Config = FlowV1Config()):
        super().__init__()
        self.cfg = cfg
        self.input_embedding = nn.Embedding(cfg.vocab_size, cfg.input_size)
        self.spk_embed_affine_layer = Dense(cfg.spk_embed_dim, cfg.output_size)
        self.encoder = ConformerEncoder(cfg.encoder)
        self.encoder_proj = Dense(cfg.encoder.dim, cfg.output_size)
        self.length_regulator = InterpolateRegulator(cfg.output_size, cfg.regulator_stages)
        self.decoder = ConditionalCFM(cfg.cfm, cfg.estimator)

    def forward(self, token, token_len, feat, feat_len, embedding,
                gen: Optional[torch.Generator] = None,
                draws: Optional[FlowDraws] = None, rows: Optional[tuple] = None) -> dict:
        """Training loss: token [B, Tt], feat [B, Tf, 80] the target mel,
        embedding [B, spk] -> {"loss", "denom"}; the encoder's rows
        interpolated to Tf.  Draws from `gen` (rows: FlowDraws.draw_rows), or
        the given `draws`."""
        spks = embedding / embedding.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        spks = self.spk_embed_affine_layer(spks)
        mask = make_non_pad_mask(token_len, token.shape[1])
        emb = self.input_embedding(token.clamp_min(0)) * mask[..., None]
        h, _ = self.encoder(emb, token_len)
        h = self.length_regulator(self.encoder_proj(h), feat_len, feat.shape[1])
        B, T2, C = h.shape
        if draws is None:
            draws = FlowDraws.draw_rows(gen, B, T2, C, self.cfg.cfm.training_cfg_rate, rows)
        conds = prompt_prefix_cond(feat, feat_len, draws)
        fmask = make_non_pad_mask(feat_len, T2).to(h.dtype)
        loss, _ = self.decoder.compute_loss(feat, fmask, h, spks, conds, draws)
        return {"loss": loss, "denom": fmask.sum().float() * C}

    @torch.no_grad()
    def inference(self, token, token_len, prompt_feat, embedding, noise: torch.Tensor,
                  prompt_token_len: int = 0, mel_len2: int = 0, n_timesteps: int = 10,
                  flow_cache=None, sample_rate: int = 22050):
        """token [1, T] (prompt ++ generated), prompt_feat [1, P, 80],
        embedding [1, spk_embed_dim], noise [1, P + mel_len2, 80] (the CFM's
        fresh draw); mel_len2 generated mel frames (the caller's token count
        / fr * sr / 256) -> (mel [1, mel_len2, 80], the new flow cache)."""
        cfg = self.cfg
        spks = embedding / embedding.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        spks = self.spk_embed_affine_layer(spks)
        mask = make_non_pad_mask(token_len, token.shape[1])
        emb = self.input_embedding(token.clamp_min(0)) * mask[..., None]
        h, _ = self.encoder(emb, token_len)
        h = self.encoder_proj(h)
        P = prompt_feat.shape[1]
        h = self.length_regulator.inference(h[:, :prompt_token_len], h[:, prompt_token_len:],
                                            P, mel_len2, cfg.input_frame_rate, sample_rate)
        conds = torch.zeros((h.shape[0], P + mel_len2, cfg.output_size), dtype=h.dtype,
                            device=h.device)
        conds[:, :P] = prompt_feat.to(h.dtype)
        mel_mask = torch.ones(h.shape[:2], dtype=h.dtype, device=h.device)
        mel, cache = self.decoder(h, mel_mask, spks, conds, noise, n_timesteps=n_timesteps,
                                  prompt_len=P, flow_cache=flow_cache)
        return mel[:, P:], cache
