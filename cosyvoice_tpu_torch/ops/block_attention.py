"""Blockwise (flash-structure) attention for training forwards, with its
backward.  Port of cosyvoice_tpu/ops/block_attention.py.

The naive training attention keeps a [B, H, T, T] score and probability
tensor a layer for the backward; at packed rows of 2048 tokens those are
most of the step's memory.  This op runs the flash recurrence over key
blocks (a running max and normalizer) and its backward re-derives each
block's probabilities from the saved log-sum-exp, so nothing quadratic in T
is kept: the saved tensors are q, k, v, bias, out and lse.  The JAX package
writes it in XLA (a `lax.scan` under `jax.custom_vjp`), not in Pallas, so
the port is plain PyTorch: a loop over key blocks inside a
`torch.autograd.Function`.

GQA without repeating k/v: q [B, H, T, D] is viewed as [B, KH, g, T, D] and
the einsums broadcast over the group axis.  The key axis is padded to a
block multiple with NEG_INF bias; accumulation is fp32 whatever the input
dtype.  The bias must be finite (NEG_INF = -1e9): a row whose every key is
masked then takes the uniform distribution over the padded key blocks, as
the JAX op does (over the S real keys only where S is a block multiple).
"""
from __future__ import annotations

import torch

from cosyvoice_tpu_torch.ops.masks import NEG_INF


def _pad_blocks(k, v, bias, block: int):
    """Pad the key axis of k, v [B, KH, S, D] and bias [..., S] to a block
    multiple (the new keys masked by NEG_INF)."""
    S = k.shape[2]
    pad = -S % block
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        bias = torch.nn.functional.pad(bias, (0, pad), value=NEG_INF)
    return k, v, bias


def _bias_block(bias, j: int, block: int, KH: int, g: int):
    """Block j of bias [B, 1|H, T, Sp] as [B, 1|KH, 1|g, T, block] fp32."""
    B, hb, T, _ = bias.shape
    bj = bias[..., j * block:(j + 1) * block].float()
    return bj.reshape(B, 1, 1, T, block) if hb == 1 else bj.reshape(B, KH, g, T, block)


class _BlockAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, sm_scale: float, block: int):
        B, H, T, D = q.shape
        KH = k.shape[1]
        g = H // KH
        S, Sb = k.shape[2], bias.shape[-1]
        k, v, bias = _pad_blocks(k, v, bias, block)
        qg = q.reshape(B, KH, g, T, D).float()
        m = torch.full((B, KH, g, T), -1e30, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, KH, g, T, D), dtype=torch.float32, device=q.device)
        for j in range(k.shape[2] // block):
            kj = k[:, :, j * block:(j + 1) * block].float()
            vj = v[:, :, j * block:(j + 1) * block].float()
            s = torch.einsum("bkgtd,bkcd->bkgtc", qg, kj) * sm_scale \
                + _bias_block(bias, j, block, KH, g)
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bkgtc,bkcd->bkgtd", p, vj)
            m = m_new
        out = (acc / l[..., None]).reshape(B, H, T, D).to(q.dtype)
        lse = m + torch.log(l)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.sm_scale, ctx.block, ctx.S, ctx.Sb = sm_scale, block, S, Sb
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, lse = ctx.saved_tensors
        sm_scale, block = ctx.sm_scale, ctx.block
        B, H, T, D = q.shape
        KH = k.shape[1]
        g = H // KH
        hb = bias.shape[1]
        want_bias = ctx.needs_input_grad[3]
        qg = q.reshape(B, KH, g, T, D).float()
        df = dout.reshape(B, KH, g, T, D).float()
        delta = (df * out.reshape(B, KH, g, T, D).float()).sum(-1)
        dq = torch.zeros_like(qg)
        dks, dvs, dbs = [], [], []
        for j in range(k.shape[2] // block):
            kj = k[:, :, j * block:(j + 1) * block].float()
            vj = v[:, :, j * block:(j + 1) * block].float()
            s = torch.einsum("bkgtd,bkcd->bkgtc", qg, kj) * sm_scale \
                + _bias_block(bias, j, block, KH, g)
            p = torch.exp(s - lse[..., None])
            dvs.append(torch.einsum("bkgtc,bkgtd->bkcd", p, df))
            dp = torch.einsum("bkgtd,bkcd->bkgtc", df, vj)
            ds = p * (dp - delta[..., None])
            dq = dq + torch.einsum("bkgtc,bkcd->bkgtd", ds, kj) * sm_scale
            dks.append(torch.einsum("bkgtc,bkgtd->bkcd", ds, qg) * sm_scale)
            if want_bias:
                dbs.append(ds.sum(dim=(1, 2))[:, None] if hb == 1
                           else ds.reshape(B, H, T, block))
        dk = torch.cat(dks, dim=2)[:, :, :ctx.S].to(k.dtype)
        dv = torch.cat(dvs, dim=2)[:, :, :ctx.S].to(v.dtype)
        db = torch.cat(dbs, dim=-1)[..., :ctx.Sb].to(bias.dtype) if want_bias else None
        return dq.reshape(B, H, T, D).to(q.dtype), dk, dv, db, None, None


def block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                    sm_scale: float, block_size: int = 256) -> torch.Tensor:
    """q [B, H, T, D]; k, v [B, KH, S, D] (H = KH * groups); bias [B, 1 or
    H, T, S] additive and finite.  Returns [B, H, T, D] in q's dtype;
    differentiable in q, k, v and bias."""
    return _BlockAttention.apply(q, k, v, bias, float(sm_scale), int(block_size))


def naive_attention(q, k, v, bias, sm_scale: float) -> torch.Tensor:
    """The materialized-softmax attention block_attention replaces (the
    Qwen2 layer's plain route): fp32 scores and softmax, GQA by broadcast."""
    B, H, T, D = q.shape
    KH = k.shape[1]
    qg = q.reshape(B, KH, H // KH, T, D).float()
    s = torch.einsum("bkgtd,bkcd->bkgtc", qg, k.float()) * sm_scale
    s = s + (bias[:, :, None] if bias.shape[1] == 1
             else bias.reshape(B, KH, H // KH, T, -1)).float()
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bkgtc,bkcd->bkgtd", p, v).reshape(B, H, T, D)
