"""Non-causal multi-head self-attention with per-row prefix key lengths (the
DiT blocks of the flow estimator).

`dit_attention_packed` / `dit_attention` call the PyTorch operators
`torch.ops.cosyvoice.dit_attention_packed` / `dit_attention` (registered
here, ops/kernels/operators.py): on CUDA tensors they launch the kernel in
`csrc/dit_attention.cu` (bf16 on the tensor cores, fp32 on the SIMT units),
on CPU tensors they run `dit_attention_plain`.  Port of
cosyvoice_tpu/ops/pallas/dit_attention.py; unlike the TPU kernel, any T
works (no 128-row alignment).
"""
from __future__ import annotations

import torch

from cosyvoice_tpu_torch.ops.kernels import build
from cosyvoice_tpu_torch.ops.kernels.operators import define

# kernel launches so far (plain integer; callers may reset it to 0)
launches = 0
LOG2E = 1.4426950408889634


def dit_attention_plain(q, k, v, lengths, sm_scale: float) -> torch.Tensor:
    """q/k/v [B, T, H, D] (any strides) -> o [B, T, H, D] in q.dtype.

    Keys j >= lengths[b] are excluded; a row with no keys gives zeros.  The
    TPU kernel's rounding points: q * (sm_scale * log2 e) rounded to q.dtype,
    scores in fp32, exp2 against the row max, p rounded to q.dtype before
    p @ v, fp32 sums, the divide floored at 1e-30 (in fp32 the roundings are
    the identity)."""
    T = q.shape[1]
    qs = (q.float() * (sm_scale * LOG2E)).to(q.dtype).float()
    s = torch.einsum("bihd,bjhd->bhij", qs, k.float())
    valid = torch.arange(T, device=q.device)[None, :] < lengths.to(q.device)[:, None]
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhij,bjhd->bihd", p.to(q.dtype).float(), v.float())
    return (o / l.transpose(1, 2)).to(q.dtype)


def _launch(q, k, v, out, lengths, B, T, H, D, in_strides, out_strides, sm_scale,
            name):
    global launches
    if D != 64:
        raise ValueError(f"{name}: kernel takes head_dim 64, got {D}")
    if out.dtype == torch.bfloat16 and (any(p % 16 for p in (q, k, v))
                                        or any(s % 8 for s in in_strides)):
        raise ValueError(f"{name}: bf16 q/k/v must be 16-byte aligned with strides "
                         "that are multiples of 8")
    lengths = lengths.to(device=out.device, dtype=torch.int32).contiguous()
    if lengths.shape != (B,):
        raise ValueError(f"{name}: lengths must be [B={B}], got {tuple(lengths.shape)}")
    rc = build.library().cvt_dit_attention(
        q, k, v, out.data_ptr(), lengths.data_ptr(), B, T, H, D, *in_strides,
        *out_strides, float(sm_scale), build.dtype_code(out), build.stream_of(out))
    build.check_launch(rc, name)
    launches += 1


def _packed_plain(qkv, lengths, sm_scale: float, head_dim: int) -> torch.Tensor:
    B, T, HD3 = qkv.shape
    HD = HD3 // 3
    q, k, v = (qkv[..., i * HD:(i + 1) * HD].reshape(B, T, HD // head_dim, head_dim)
               for i in range(3))
    return dit_attention_plain(q, k, v, lengths, sm_scale).reshape(B, T, HD)


def _packed_kernel(qkv, lengths, sm_scale: float, head_dim: int) -> torch.Tensor:
    B, T, HD3 = qkv.shape
    HD = HD3 // 3
    H = HD // head_dim
    build.require_cuda("dit_attention_packed", qkv)
    out = torch.empty((B, T, HD), dtype=qkv.dtype, device=qkv.device)
    base, isz = qkv.data_ptr(), qkv.element_size()
    _launch(base, base + HD * isz, base + 2 * HD * isz, out, lengths, B, T, H,
            head_dim, (T * HD3, HD3), (T * HD, HD), sm_scale, "dit_attention_packed")
    return out


def _packed_fake(qkv, lengths, sm_scale, head_dim):
    B, T, HD3 = qkv.shape
    return qkv.new_empty((B, T, HD3 // 3))


_PACKED = define("dit_attention_packed(Tensor qkv, Tensor lengths, float sm_scale, "
                 "int head_dim) -> Tensor", _packed_plain, _packed_kernel, _packed_fake)


def _unpacked_kernel(q, k, v, lengths, sm_scale: float) -> torch.Tensor:
    B, T, H, D = q.shape
    build.require_cuda("dit_attention", q, k, v)
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("dit_attention: q, k and v must share one dtype")
    out = torch.empty_like(q)
    strides = (T * H * D, H * D)
    _launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out, lengths, B, T, H, D,
            strides, strides, sm_scale, "dit_attention")
    return out


_UNPACKED = define("dit_attention(Tensor q, Tensor k, Tensor v, Tensor lengths, "
                   "float sm_scale) -> Tensor", dit_attention_plain, _unpacked_kernel,
                   lambda q, k, v, lengths, sm_scale: torch.empty_like(
                       q, memory_format=torch.contiguous_format))


def dit_attention_packed(qkv: torch.Tensor, lengths: torch.Tensor, sm_scale: float,
                         head_dim: int = 64) -> torch.Tensor:
    """Attention read straight out of the packed [B, T, 3*H*D] projection
    (lane order q | k | v, heads minor).  Returns o [B, T, H*D]."""
    HD3 = qkv.shape[-1]
    if HD3 % (3 * head_dim):
        raise ValueError(f"dit_attention_packed: last dim {HD3} is not 3*H*{head_dim}")
    if build.needs_autograd("dit_attention_packed", qkv):
        return _packed_plain(qkv, lengths, sm_scale, head_dim)
    return _PACKED(qkv, lengths, float(sm_scale), int(head_dim))


def dit_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lengths: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """q/k/v [B, T, H, D] -> o [B, T, H, D]; keys j >= lengths[b] excluded."""
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("dit_attention: q, k and v must share one shape")
    if build.needs_autograd("dit_attention", q, k, v):
        return dit_attention_plain(q, k, v, lengths, sm_scale)
    return _UNPACKED(q, k, v, lengths, float(sm_scale))
