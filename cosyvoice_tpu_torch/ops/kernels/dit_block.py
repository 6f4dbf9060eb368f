"""One whole DiT block of the flow estimator in one call: LayerNorm, packed qkv
projection, H-head self-attention over per-row prefix key lengths, out
projection + bias + residual, LayerNorm, tanh-GELU FFN + residual.

`dit_block_fused` calls the PyTorch operator `torch.ops.cosyvoice.dit_block`
(registered here, ops/kernels/operators.py): on CUDA tensors it launches the kernels in `csrc/dit_block.cu` (three
launches on one stream, counted as one; in bf16 the attention launch is K2's
kernel, `csrc/dit_attention.cu`), on CPU tensors it runs `dit_block_plain`,
the same function in plain PyTorch.  Port
of cosyvoice_tpu/ops/pallas/dit_block.py: the weights keep its layout (wqkv
[dim, 3*inner] with lanes q | k | v and heads minor, wo [inner, dim], wi
[dim, ff], wo2 [ff, dim]) and its rounding points; the softmax is exact and
max-subtracted where the TPU kernel clamped exp2 at 108.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from cosyvoice_tpu_torch.ops.kernels import build
from cosyvoice_tpu_torch.ops.kernels.operators import define
from cosyvoice_tpu_torch.ops.kernels.fused_norm import layer_norm_plain

# kernel launches so far (plain integer; callers may reset it to 0)
launches = 0

LOG2E = 1.4426950408889634


def supports(T: int, heads: int, head_dim: int, dim: int, ff: int) -> bool:
    """The blocks the estimator routes to K4: T a multiple of 128 (the TPU
    kernel's alignment, which the estimator's padding gives) and widths the
    CUDA kernel takes (`widths_supported`).  The kernel itself takes any T."""
    return T % 128 == 0 and widths_supported(heads, head_dim, dim, ff)


def widths_supported(heads: int, head_dim: int, dim: int, ff: int) -> bool:
    """The widths the CUDA kernel takes: head_dim 64, dim 128 or 256, inner
    and ff multiples of 128; the wrapper refuses others on the GPU."""
    return (head_dim == 64 and dim in (128, 256) and heads * head_dim % 128 == 0
            and ff % 128 == 0)


ROWS_A, ROWS_C = 64, 96    # rows a block of the bf16 route's phases A and C
QKV_COLS = 384             # qkv columns a phase A block
SLAB, STAGES, CHUNK = 64, 2, 128   # weight slab rows, ring slots, mid/qkv chunk


def plan(B: int, T: int, dim: int, heads: int, head_dim: int, ff: int) -> dict:
    """The bf16 route's three launches at x [B, T, dim] (csrc/dit_block.cu
    launch_tc): each one's grid, threads a block and shared memory in bytes
    (dynamic for A and C, which the kernel sizes the same way; static for
    K2's attention kernel)."""
    inner = heads * head_dim
    bf = 2
    return {
        "ln_qkv": dict(grid=(-(-T // ROWS_A), 3 * inner // QKV_COLS, B), threads=256,
                       rows=ROWS_A, cols=QKV_COLS,
                       smem=(ROWS_A * (dim + 8) + STAGES * SLAB * (CHUNK + 8)) * bf),
        "attention": dict(grid=(-(-T // 64), heads, B), threads=128, rows=64,
                          smem=(64 * 72 + 2 * 2 * 64 * 72) * bf),
        # x1, h2 and a mid chunk of the tile's rows, and a ring of slots that
        # each hold an o slab [rows, SLAB] beside a weight slab [SLAB, dim]
        "out_ffn": dict(grid=(-(-T // ROWS_C), B), threads=384, rows=ROWS_C,
                        smem=(ROWS_C * (2 * (dim + 8) + CHUNK + 8)
                              + STAGES * (ROWS_C * (SLAB + 8) + SLAB * (dim + 8))) * bf),
    }


def random_block_weights(dim: int, heads: int, head_dim: int, ff: int, dtype,
                         generator: torch.Generator, device) -> tuple:
    """Seeded random block parameters in dit_block_fused's order: matrices
    ~ N(0, 1/in) in `dtype` (so every product stays O(1)), fp32 norm scales
    1 + 0.1 N(0, 1) and biases 0.1 N(0, 1): inputs for holding the kernel
    against its plain version at real widths."""
    inner = heads * head_dim

    def mat(k, n):
        return (torch.randn(k, n, generator=generator, device=device) * k ** -0.5).to(dtype)

    def vec(n, mean=0.0):
        return torch.randn(n, generator=generator, device=device) * 0.1 + mean

    return (vec(dim, 1.0), vec(dim), mat(dim, 3 * inner), mat(inner, dim), vec(dim),
            vec(dim, 1.0), vec(dim), mat(dim, ff), vec(ff), mat(ff, dim), vec(dim))


def dit_block_plain(x, lengths, g1, b1, wqkv, wo, bo, g3, b3, wi, bi, wo2, bo2,
                    sm_scale: float, heads: int, head_dim: int,
                    return_attention: bool = False):
    """Plain version; arguments and result as `dit_block_fused`."""
    dt = x.dtype
    B, T, _ = x.shape
    inner = heads * head_dim

    def mm(a, w):           # fp32 accumulation of working-type operands
        return a.float() @ w.float()

    h = layer_norm_plain(x, g1, b1).to(dt)
    qkv = mm(h, wqkv).to(dt)
    q, k, v = (qkv[..., i * inner:(i + 1) * inner].float().reshape(B, T, heads, head_dim)
               for i in range(3))
    q = (q * (sm_scale * LOG2E)).to(dt).float()
    s = torch.einsum("bihd,bjhd->bhij", q, k)
    valid = torch.arange(T, device=x.device)[None, :] < lengths.to(x.device)[:, None]
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = (torch.einsum("bhij,bjhd->bhid", p.to(dt).float(), v) / l).to(dt)
    o = o.permute(0, 2, 1, 3).reshape(B, T, inner)
    x1 = (x.float() + (mm(o, wo) + bo.float()).to(dt).float()).to(dt)
    h2 = layer_norm_plain(x1, g3, b3).to(dt)
    mid = F.gelu(mm(h2, wi) + bi.float(), approximate="tanh").to(dt)
    y = (x1.float() + (mm(mid, wo2) + bo2.float()).to(dt).float()).to(dt)
    return (y, o) if return_attention else y


def _kernel(x, lengths, g1, b1, wqkv, wo, bo, g3, b3, wi, bi, wo2, bo2, sm_scale: float,
            heads: int, head_dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(y, o): the block's output and its attention output."""
    global launches
    args = (g1, b1, wqkv, wo, bo, g3, b3, wi, bi, wo2, bo2)
    B, T, dim = x.shape
    inner, ff = heads * head_dim, wi.shape[-1]
    build.require_cuda("dit_block_fused", x, lengths, *args)
    if not all(w.dtype == x.dtype for w in (wqkv, wo, wi, wo2)):
        raise TypeError("dit_block_fused: the weights must be in x.dtype, got "
                        f"{[str(w.dtype) for w in (wqkv, wo, wi, wo2)]} for {x.dtype}")
    if any(t.data_ptr() % 16 for t in (x, wqkv, wo, wi, wo2)):
        raise ValueError("dit_block_fused: x and the weights must start 16-byte aligned")
    if not B * T or not widths_supported(heads, head_dim, dim, ff):
        raise ValueError(f"dit_block_fused: the kernel does not take x{tuple(x.shape)} "
                         f"with {heads}x{head_dim} heads and ff {ff} "
                         "(see widths_supported())")
    qkv = torch.empty((B, T, 3 * inner), dtype=x.dtype, device=x.device)
    o = torch.empty((B, T, inner), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    rc = build.library().cvt_dit_block(
        x.data_ptr(), lengths.data_ptr(), g1.data_ptr(), b1.data_ptr(), wqkv.data_ptr(),
        wo.data_ptr(), bo.data_ptr(), g3.data_ptr(), b3.data_ptr(), wi.data_ptr(),
        bi.data_ptr(), wo2.data_ptr(), bo2.data_ptr(), qkv.data_ptr(), o.data_ptr(),
        y.data_ptr(), B, T, dim, heads, head_dim, ff, float(sm_scale * LOG2E),
        build.dtype_code(x), build.stream_of(x))
    build.check_launch(rc, "dit_block_fused")
    launches += 1
    return y, o


def _plain(x, lengths, g1, b1, wqkv, wo, bo, g3, b3, wi, bi, wo2, bo2, sm_scale: float,
           heads: int, head_dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    return dit_block_plain(x, lengths, g1, b1, wqkv, wo, bo, g3, b3, wi, bi, wo2, bo2,
                           sm_scale, heads, head_dim, return_attention=True)


def _fake(x, lengths, g1, b1, wqkv, wo, bo, g3, b3, wi, bi, wo2, bo2, sm_scale, heads,
          head_dim):
    B, T, _ = x.shape
    return x.new_empty(x.shape), x.new_empty((B, T, heads * head_dim))


_OP = define("dit_block(Tensor x, Tensor lengths, Tensor g1, Tensor b1, Tensor wqkv, "
             "Tensor wo, Tensor bo, Tensor g3, Tensor b3, Tensor wi, Tensor bi, Tensor wo2, "
             "Tensor bo2, float sm_scale, int heads, int head_dim) -> (Tensor, Tensor)",
             _plain, _kernel, _fake)


def dit_block_fused(x: torch.Tensor, lengths: torch.Tensor, g1, b1, wqkv, wo, bo, g3, b3,
                    wi, bi, wo2, bo2, sm_scale: float, heads: int, head_dim: int,
                    return_attention: bool = False):
    """x [B, T, dim] (fp32 or bf16), lengths [B] int32 -> y [B, T, dim].

    Keys j >= lengths[b] are masked for every query of row b (the pad mask
    must be prefix-contiguous); rows i >= lengths[b] are computed over the
    same keys and left for the caller to mask.  g1/b1/g3/b3/bo/bo2 [dim],
    bi [ff]; wqkv [dim, 3*inner], wo [inner, dim], wi [dim, ff], wo2 [ff, dim]
    in x.dtype.  With `return_attention`, returns (y, o): o [B, T, inner] is
    the attention output before the out projection, heads minor, so the
    attention branch can be held on its own."""
    B, T, dim = x.shape
    inner, ff = heads * head_dim, wi.shape[-1]
    shapes = {"wqkv": (wqkv, (dim, 3 * inner)), "wo": (wo, (inner, dim)),
              "wi": (wi, (dim, ff)), "wo2": (wo2, (ff, dim)), "bi": (bi, (ff,)),
              "lengths": (lengths, (B,)),
              **{n: (v, (dim,)) for n, v in (("g1", g1), ("b1", b1), ("bo", bo),
                                               ("g3", g3), ("b3", b3), ("bo2", bo2))}}
    bad = {n: tuple(t.shape) for n, (t, want) in shapes.items() if tuple(t.shape) != want}
    if bad:
        raise ValueError(f"dit_block_fused: x{tuple(x.shape)} with {heads}x{head_dim} "
                         f"heads and ff {ff} does not take {bad}")
    args = (g1, b1, wqkv, wo, bo, g3, b3, wi, bi, wo2, bo2)
    if build.needs_autograd("dit_block_fused", x, *args):
        return dit_block_plain(x, lengths, *args, sm_scale, heads, head_dim, return_attention)
    # the kernel's operand types: fp32 vectors, int32 lengths on x's device
    g1, b1, bo, g3, b3, bi, bo2 = (v.float().contiguous() for v in (g1, b1, bo, g3, b3,
                                                                     bi, bo2))
    lengths = lengths.to(device=x.device, dtype=torch.int32).contiguous()
    y, o = _OP(x, lengths, g1, b1, wqkv, wo, bo, g3, b3, wi, bi, wo2, bo2, float(sm_scale),
               int(heads), int(head_dim))
    return (y, o) if return_attention else y
