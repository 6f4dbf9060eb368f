"""Packed-int4 weight-only matmul `x @ dequant(W)` for the LM's projections.

Layout (the JAX package's): `w_packed` int8 [in/2, out], byte i holds input
row 2i in its low nibble and row 2i+1 in its high nibble, both two's
complement; `scale` fp32 [in/group, out], group-wise along the input dim.
The dequantised weight is rounded to x.dtype before the product,
`x.dtype(nibble) * x.dtype(scale)`, and the product accumulates in fp32 and
is cast to x.dtype once.

`int4_matmul` launches the CUDA kernel in `csrc/int4_matmul.cu` for CUDA
tensors (one-row decode calls as a split-K GEMV whose partial sums and
arrival counters the wrapper keeps, one set per device and stream) and
runs `int4_matmul_plain`, the same function in plain PyTorch, for CPU
tensors.  Port of cosyvoice_tpu/ops/pallas/int4_matmul.py.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from cosyvoice_tpu_torch.ops.kernels import build

# kernel launches so far (plain integer; callers may reset it to 0)
launches = 0
# the split route's scratch, per (device, raw stream) (build.scratch_for)
_scratch: dict = {}


@functools.lru_cache(maxsize=None)
def plan(rows: int, IN: int, OUT: int, group: int) -> dict:
    """How the kernel launches for these shapes (csrc/int4_matmul.cu
    plan_for): the route, columns a tile, packed rows a split, splits, blocks
    and threads a block."""
    out = (ctypes.c_int * 6)()
    rc = build.library().cvt_int4_matmul_plan(rows, IN, OUT, group // 2, out)
    build.check_launch(rc, "int4_matmul plan")
    return dict(route="split" if out[0] else "prefill", cols=out[1], split_rows=out[2],
                splits=out[3], blocks=out[4], threads=out[5])


def pack_int4(w: torch.Tensor) -> torch.Tensor:
    """[in, out] integer values in [-8, 7] -> [in/2, out] int8 packed bytes."""
    if w.shape[0] % 2:
        raise ValueError("packed int4 needs an even input dim")
    lo = w[0::2].to(torch.int32) & 0xF
    hi = w[1::2].to(torch.int32) & 0xF
    return (lo | (hi << 4)).to(torch.uint8).view(torch.int8).contiguous()


def unpack_int4(w_packed: torch.Tensor, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (even rows, odd rows) [in/2, out] as signed nibble values in `dtype`."""
    p = w_packed.to(torch.int32) & 0xFF
    lo = ((p << 28) >> 28).to(dtype)
    hi = ((p << 24) >> 28).to(dtype)
    return lo, hi


def int4_matmul_plain(x: torch.Tensor, w_packed: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """Plain version (twin of `int4_matmul_xla`); x [..., in] -> [..., out]."""
    lo, hi = unpack_int4(w_packed, x.dtype)
    g2 = w_packed.shape[0] // scale.shape[0]
    sfull = torch.repeat_interleave(scale.to(x.dtype), g2, dim=0)   # [in/2, out]
    acc = x[..., 0::2].float() @ (lo * sfull).float()
    acc = acc + x[..., 1::2].float() @ (hi * sfull).float()
    return acc.to(x.dtype)


def int4_matmul(x: torch.Tensor, w_packed: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """y [rows, out] = x [rows, in] @ dequant(w_packed [in/2, out], scale
    [in/group, out]); x float32 or bfloat16."""
    global launches
    rows, IN = x.shape
    IN2, OUT = w_packed.shape
    n_g = scale.shape[0]
    if (IN != 2 * IN2 or scale.shape != (n_g, OUT) or n_g == 0 or IN2 % n_g
            or w_packed.dtype != torch.int8):
        raise ValueError("int4_matmul: inconsistent shapes "
                         f"x{tuple(x.shape)} w{tuple(w_packed.shape)} "
                         f"scale{tuple(scale.shape)} ({w_packed.dtype})")
    if x.device.type == "cpu":
        return int4_matmul_plain(x, w_packed, scale)
    build.require_cuda("int4_matmul", x, w_packed, scale)
    if scale.dtype != torch.float32:
        raise TypeError("int4_matmul: scale must be float32")
    if OUT % 2:
        raise ValueError(f"int4_matmul: kernel takes an even out dim, got {OUT}")
    out = torch.empty((rows, OUT), dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    p = plan(rows, IN, OUT, IN // n_g)
    stream = build.stream_of(x)
    work = counters = None
    if p["route"] == "split":
        if w_packed.data_ptr() % 16:
            raise ValueError("int4_matmul: packed weights must be 16-byte aligned")
        counters, work = build.scratch_for(_scratch, x.device, stream,
                                           OUT // p["cols"], p["splits"] * OUT)
    rc = build.library().cvt_int4_matmul(
        x.data_ptr(), w_packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
        0 if work is None else work.data_ptr(),
        0 if counters is None else counters.data_ptr(),
        rows, IN, OUT, IN2 // n_g, build.dtype_code(x), stream)
    build.check_launch(rc, "int4_matmul")
    launches += 1
    return out
