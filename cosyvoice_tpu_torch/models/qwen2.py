"""Qwen2 transformer body with a preallocated KV cache.

Port of cosyvoice_tpu/models/qwen2.py (Qwen2-0.5B for CosyVoice2: hidden
896, 24 layers, 14 query / 2 KV heads, head_dim 64, intermediate 4864, rope
theta 1e6, RMSNorm eps 1e-6).  Module and parameter names follow the
Hugging Face Qwen2 state_dict (`layers.{i}.self_attn.q_proj.weight`, ...).

With `fused_cache_update` the cache is packed [B, T_max, KH*D]; prefill
writes it and attends over the current tokens only, and every one-token
decode step goes through the `lm_decode_attention` kernel, which also appends
the new K/V to the cache in place (at one shared position, or at per-row
positions for the continuous-batching engine).  Without it the cache is head-major
[B, KH, T_max, D] and attention is plain PyTorch.  Cache writes are in place
(the JAX package returns new buffers).

Training forwards (no cache, grad on) take the config's `block_attention`
route (ops/block_attention.py) and its `remat` policy through
torch.utils.checkpoint, as the JAX package's flax remat does.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from cosyvoice_tpu_torch.ops.block_attention import block_attention
from cosyvoice_tpu_torch.ops.kernels.int4_matmul import int4_matmul, int4_matmul_plain
from cosyvoice_tpu_torch.ops.kernels.lm_decode_attention import lm_decode_attention
from cosyvoice_tpu_torch.ops.masks import NEG_INF
from cosyvoice_tpu_torch.parallel.collectives import (ModelGroup, ParallelEmbedding,
                                                      copy_to_model, reduce_from_model)


@dataclass(frozen=True)
class Qwen2Config:
    vocab_size: int = 151936
    hidden_size: int = 896
    num_layers: int = 24
    num_heads: int = 14
    num_kv_heads: int = 2
    head_dim: int = 64
    intermediate_size: int = 4864
    rope_theta: float = 1e6
    rms_norm_eps: float = 1e-6
    # the HF export's setting (the speech LMs read no output head of the body)
    tie_word_embeddings: bool = True
    # weight-only quantization of the 7 per-layer projections: "none" |
    # "int8" | "int4" (packed, group-wise scales; the int4_matmul kernel) |
    # "int4xla" (nibble values as int8, group-wise scales; PyTorch ops)
    quant: str = "none"
    quant_group: int = 128  # int4 / int4xla scale group size along the input dim
    # packed [B, T, KH*D] cache + the lm_decode_attention kernel for decode
    fused_cache_update: bool = False
    # training (cache-less forwards with grad): recompute in the backward
    # through torch.utils.checkpoint, either the attention-score chain only
    # ("scores": the [.., T, T] scores and probabilities are not kept) or the
    # whole layer ("all", or any other value, as in the JAX package)
    remat: bool = False
    remat_policy: str = "scores"
    # cache-less T > 1 forwards through ops/block_attention.py (the flash
    # recurrence over key blocks; nothing quadratic in T kept for backward)
    block_attention: bool = False
    attention_block: int = 256


class KVCache:
    """Per-layer cache buffers plus the number of filled positions `pos`: an
    int shared by every row (lm_generate), or an int32 [B] tensor of per-row
    frontiers for one-token decode steps (the continuous-batching engine)."""

    def __init__(self, k: list, v: list, pos: int = 0):
        self.k, self.v, self.pos = k, v, pos

    @staticmethod
    def create(cfg: Qwen2Config, batch: int, max_len: int, dtype, device) -> "KVCache":
        if cfg.fused_cache_update:
            shape = (batch, max_len, cfg.num_kv_heads * cfg.head_dim)
        else:
            shape = (batch, cfg.num_kv_heads, max_len, cfg.head_dim)
        return KVCache([torch.zeros(shape, dtype=dtype, device=device)
                        for _ in range(cfg.num_layers)],
                       [torch.zeros(shape, dtype=dtype, device=device)
                        for _ in range(cfg.num_layers)])


class QDense(nn.Module):
    """Linear with optional weight-only quantization.

    int8: `weight` int8 [out, in] plus a per-output-channel `scale`.  The
    order is the JAX package's: cast the weight to x.dtype, take the product
    in x.dtype, then multiply by the scale in x.dtype (any other order drifts
    greedy tokens).
    int4: `weight` int8 [in/2, out], two input rows per byte, and a
    group-wise `scale` [in/g, out] (g = min(group, in)).  Calls of up to 512
    rows (decode, prefill) go through the int4_matmul kernel; larger ones
    through its plain unpack-and-matmul, as the JAX package routes them.
    int4xla: `weight` int8 [in, out] holding nibble values in [-7, 7] (the
    JAX kernel's layout) and a group-wise `scale` [in/g, out].  The JAX
    package's order: a per-group product in x.dtype, then the contraction
    with the scales in x.dtype (two einsums; no Pallas kernel there, so
    none here).  The JAX package's cast to its native int4 type is an XLA
    layout trick and has no counterpart."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 quant: str = "none", group: int = 128):
        super().__init__()
        if quant not in ("none", "int8", "int4", "int4xla"):
            raise ValueError(f"unknown quant {quant!r} (none|int8|int4|int4xla)")
        self.quant = quant
        if quant == "int8":
            self.register_buffer("weight", torch.zeros(out_features, in_features,
                                                       dtype=torch.int8))
            self.register_buffer("scale", torch.ones(out_features))
        elif quant == "int4":
            g = min(group, in_features)
            self.register_buffer("weight", torch.zeros(in_features // 2, out_features,
                                                       dtype=torch.int8))
            self.register_buffer("scale", torch.ones(in_features // g, out_features))
        elif quant == "int4xla":
            g = min(group, in_features)
            self.register_buffer("weight", torch.zeros(in_features, out_features,
                                                       dtype=torch.int8))
            self.register_buffer("scale", torch.ones(in_features // g, out_features))
        else:
            self.weight = nn.Parameter(torch.randn(out_features, in_features)
                                       * in_features ** -0.5)
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def tp_spec(self, attr: str, weight_spec: tuple) -> Optional[tuple]:
        """The tensor-parallel spec of this module's `attr`, given the rules'
        spec of a torch [out, in] weight; None where the rules hold as they
        are (the float and int8 layouts).  int4 and int4xla keep flax's
        [in(/2), out] weight and [in/g, out] scale, so a column-parallel
        projection (out sharded) shards dim 1 of both and a row-parallel
        one (in sharded) dim 0 of both."""
        if self.quant not in ("int4", "int4xla"):
            return None
        if not weight_spec:
            return ()
        column = weight_spec[0] == "model"
        if attr == "bias":
            return ("model",) if column else ()
        return (None, "model") if column else ("model", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant == "int4":
            x2 = x.reshape(-1, x.shape[-1])
            mm = int4_matmul if x2.shape[0] <= 512 else int4_matmul_plain
            y = mm(x2.contiguous(), self.weight, self.scale).reshape(*x.shape[:-1], -1)
        elif self.quant == "int4xla":
            G, out = self.scale.shape
            w = self.weight.to(x.dtype).reshape(G, -1, out)
            p = torch.einsum("bgi,gio->bgo", x.reshape(-1, G, w.shape[1]), w)
            y = torch.einsum("bgo,go->bo", p, self.scale.to(x.dtype))
            y = y.reshape(*x.shape[:-1], out)
        else:
            y = F.linear(x, self.weight.to(x.dtype))
            if self.quant == "int8":
                y = y * self.scale.to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * weight.float()).to(x.dtype)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float, dtype
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [B, T] -> cos/sin [B, T, head_dim] (HF half-rotation layout),
    angles in fp32."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    inv = torch.as_tensor(inv_freq, dtype=torch.float32, device=positions.device)
    ang = positions[..., None].float() * inv
    cos = torch.cat([torch.cos(ang), torch.cos(ang)], dim=-1)
    sin = torch.cat([torch.sin(ang), torch.sin(ang)], dim=-1)
    return cos.to(dtype), sin.to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, T, H, D]; rotate_half convention."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, :, None, :] + rot * sin[:, :, None, :]


class Qwen2Layer(nn.Module):
    """Under tensor parallelism (Qwen2Model.shard_) `cfg` holds the rank's
    local head and intermediate counts, and `tp_attn` / `tp_mlp` the model
    group of a sharded attention / MLP: q/k/v and gate/up are
    column-parallel, o and down row-parallel with one all-reduce each."""

    tp_attn = None
    tp_mlp = None

    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        self.cfg = cfg
        H, KH, HD, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.hidden_size
        self.input_layernorm = RMSNorm(D, cfg.rms_norm_eps)
        self.post_attention_layernorm = RMSNorm(D, cfg.rms_norm_eps)
        q, g = cfg.quant, cfg.quant_group
        self.self_attn = nn.ModuleDict({
            "q_proj": QDense(D, H * HD, True, q, g),
            "k_proj": QDense(D, KH * HD, True, q, g),
            "v_proj": QDense(D, KH * HD, True, q, g),
            "o_proj": QDense(H * HD, D, False, q, g)})
        self.mlp = nn.ModuleDict({
            "gate_proj": QDense(D, cfg.intermediate_size, False, q, g),
            "up_proj": QDense(D, cfg.intermediate_size, False, q, g),
            "down_proj": QDense(cfg.intermediate_size, D, False, q, g)})

    def forward(self, x, cos, sin, attn_bias, layer_cache=None, cache_pos=None):
        """x [B, T, D]; attn_bias [B, 1, T, Tk] additive (causal + pad);
        layer_cache: optional (ck, cv) buffers, written at cache_pos."""
        cfg = self.cfg
        H, KH, HD = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        B, T, _ = x.shape
        g = H // KH
        att = self.self_attn
        h = copy_to_model(self.input_layernorm(x), self.tp_attn)
        q = apply_rope(att["q_proj"](h).reshape(B, T, H, HD), cos, sin)
        k = apply_rope(att["k_proj"](h).reshape(B, T, KH, HD), cos, sin)
        v = att["v_proj"](h).reshape(B, T, KH, HD)

        if layer_cache is not None and cfg.fused_cache_update and T == 1:
            ck, cv = layer_cache
            qp = q.reshape(B, KH, g, HD).transpose(1, 2).reshape(B, g, KH * HD)
            op, _, _ = lm_decode_attention(
                qp.contiguous(), k.reshape(B, 1, KH * HD).to(ck.dtype).contiguous(),
                v.reshape(B, 1, KH * HD).to(cv.dtype).contiguous(), ck, cv,
                attn_bias[:, 0, 0, :].float().contiguous(), cache_pos, HD,
                1.0 / math.sqrt(HD))
            o = op.reshape(B, g, KH, HD).transpose(1, 2).reshape(B, T, H * HD).to(x.dtype)
        else:
            kt, vt = k.transpose(1, 2), v.transpose(1, 2)   # [B, KH, T, HD]
            bias = attn_bias
            k_all, v_all = kt, vt
            if layer_cache is not None and cfg.fused_cache_update:
                # prefill: the cache's FIRST write, so the current tokens are
                # the whole valid cache; attend over them only
                ck, cv = layer_cache
                ck[:, cache_pos:cache_pos + T] = k.reshape(B, T, KH * HD).to(ck.dtype)
                cv[:, cache_pos:cache_pos + T] = v.reshape(B, T, KH * HD).to(cv.dtype)
                bias = attn_bias[..., :T]
            elif layer_cache is not None:
                ck, cv = layer_cache
                if isinstance(cache_pos, torch.Tensor) and cache_pos.ndim == 1:
                    # per-row frontier: every row appends its token at its own position
                    if T != 1:
                        raise ValueError("per-row cache positions take one token a row")
                    rows, p = torch.arange(B, device=ck.device), cache_pos.long()
                    ck[rows, :, p] = kt[:, :, 0].to(ck.dtype)
                    cv[rows, :, p] = vt[:, :, 0].to(cv.dtype)
                else:
                    ck[:, :, cache_pos:cache_pos + T] = kt.to(ck.dtype)
                    cv[:, :, cache_pos:cache_pos + T] = vt.to(cv.dtype)
                k_all, v_all = ck.to(x.dtype), cv.to(x.dtype)
            if cfg.block_attention and layer_cache is None and T > 1:
                o = block_attention(q.transpose(1, 2), k_all, v_all, bias,
                                    1.0 / math.sqrt(HD), cfg.attention_block)
                o = o.transpose(1, 2).reshape(B, T, H * HD)
            elif (cfg.remat and cfg.remat_policy == "scores" and layer_cache is None
                  and torch.is_grad_enabled()):
                # the backward recomputes the score chain from q, k, v, bias
                o = checkpoint(_attend, q, k_all, v_all, bias, use_reentrant=False)
            else:
                o = _attend(q, k_all, v_all, bias)
        x = x + reduce_from_model(att["o_proj"](o), self.tp_attn)
        h = copy_to_model(self.post_attention_layernorm(x), self.tp_mlp)
        mlp = self.mlp
        y = mlp["down_proj"](F.silu(mlp["gate_proj"](h)) * mlp["up_proj"](h))
        return x + reduce_from_model(y, self.tp_mlp)


def _attend(q, k_all, v_all, bias):
    """Materialized-softmax GQA attention: q [B, T, H, HD], k_all / v_all
    [B, KH, Tk, HD], bias [B, 1, T, Tk] -> [B, T, H * HD]; fp32 scores."""
    B, T, H, HD = q.shape
    KH = k_all.shape[1]
    qg = q.reshape(B, T, KH, H // KH, HD)
    scores = torch.einsum("bikgd,bkjd->bkgij", qg.float(), k_all.float()) / math.sqrt(HD)
    scores = scores + bias[:, :, None, :, :].float()
    attn = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgij,bkjd->bikgd", attn, v_all).reshape(B, T, H * HD)


class Qwen2Model(nn.Module):
    """Decoder-only body driven by input embeddings.  Tensor parallelism
    (parallel/mesh.py) asks it which blocks shard (`tp_blocks`) and, once
    it slices them, hands it the model group (`shard_`)."""

    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = ParallelEmbedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(Qwen2Layer(cfg) for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def _tp_split(self, size: int) -> tuple[bool, bool, bool]:
        """(embedding, attention, mlp): which blocks shard over `size` ranks.
        A rank holds whole heads, so attention shards only when both head
        counts divide; the embedding and the MLP when their widths do.  Under
        int4 / int4xla a row-parallel projection (o_proj, down_proj) takes
        whole scale groups a rank (and so, packed int4, whole bytes): its
        block stays whole where its input width over `size` is not a
        multiple of the group (int4_matmul has no group offset).  Qwen2-0.5B
        at 2 ranks: the MLP shards (4864 / 2 = 19 x 128), attention not
        (896 / 2 = 3.5 x 128)."""
        c = self.cfg

        def rows_split(width: int) -> bool:
            if width % size:
                return False
            if c.quant not in ("int4", "int4xla"):
                return True
            return (width // size) % min(c.quant_group, width) == 0

        return (c.vocab_size % size == 0,
                c.num_heads % size == 0 and c.num_kv_heads % size == 0
                and rows_split(c.num_heads * c.head_dim),
                rows_split(c.intermediate_size))

    def tp_blocks(self, size: int) -> list[str]:
        """The submodules (names relative to the body) that run sharded over
        `size` ranks."""
        embed, attn, mlp = self._tp_split(size)
        blocks = ["embed_tokens"] if embed else []
        for i in range(len(self.layers)):
            blocks += [f"layers.{i}.self_attn"] * attn + [f"layers.{i}.mlp"] * mlp
        return blocks

    def shard_(self, tp: ModelGroup) -> None:
        """Run as this rank's part of the model group `tp`: the blocks of
        tp_blocks(tp.size) take the group, and the config (the body's and
        each layer's) the local head and intermediate counts; int4 and
        int4xla shards run K5 / the int4xla einsums on the local blocks."""
        embed, attn, mlp = self._tp_split(tp.size)
        c, n = self.cfg, tp.size
        local = dataclasses.replace(
            c, num_heads=c.num_heads // n if attn else c.num_heads,
            num_kv_heads=c.num_kv_heads // n if attn else c.num_kv_heads,
            intermediate_size=c.intermediate_size // n if mlp else c.intermediate_size)
        self.cfg = local
        if embed:
            self.embed_tokens.tp = tp
        for layer in self.layers:
            layer.cfg = local
            layer.tp_attn = tp if attn else None
            layer.tp_mlp = tp if mlp else None

    def forward(self, embeds: torch.Tensor, positions: torch.Tensor,
                attn_bias: torch.Tensor, cache: Optional[KVCache] = None):
        """embeds [B, T, D], positions [B, T], attn_bias [B, 1, T, Tk].

        With a cache, K/V are written at cache.pos and cache.pos advances by
        T (a [B] cache.pos: per row, T == 1).  With fused_cache_update a
        multi-token call must be the cache's first write (cache.pos == 0).
        Returns (hidden [B, T, D], cache)."""
        cfg = self.cfg
        if cache is not None and cfg.fused_cache_update and embeds.shape[1] > 1 \
                and cache.pos != 0:
            raise ValueError("packed-cache prefill must be the cache's first write")
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, embeds.dtype)
        x = embeds
        remat_all = (cfg.remat and cfg.remat_policy != "scores" and cache is None
                     and torch.is_grad_enabled())
        for i, layer in enumerate(self.layers):
            if remat_all:
                x = checkpoint(layer, x, cos, sin, attn_bias, use_reentrant=False)
                continue
            lc = (cache.k[i], cache.v[i]) if cache is not None else None
            x = layer(x, cos, sin, attn_bias, lc, cache.pos if cache is not None else None)
        if cache is not None:
            cache.pos = cache.pos + embeds.shape[1]
        return self.norm(x), cache


def causal_prefill_bias(T: int, max_len: int, lens: Optional[torch.Tensor] = None,
                        batch: int = 1, dtype=torch.float32, device=None) -> torch.Tensor:
    """[B, 1, T, max_len] additive bias: causal over [0, T), NEG_INF beyond,
    and keys >= lens[b] masked for right-padded rows."""
    q = torch.arange(T, device=device)[:, None]
    k = torch.arange(max_len, device=device)[None, :]
    ok = (k <= q)[None].expand(batch, T, max_len)
    if lens is not None:
        ok = ok & (k[None] < lens.to(device)[:, None, None])
    return torch.where(ok, 0.0, NEG_INF).to(dtype)[:, None]
