"""LayerNorm over the last axis (+ optional fused mish) with flax's fp32
fast-variance statistics: the flow estimator's serving LayerNorm.

`fused_layer_norm` calls the PyTorch operator
`torch.ops.cosyvoice.fused_layer_norm` (registered here,
ops/kernels/operators.py): on CUDA tensors it
launches the kernel in `csrc/fused_norm.cu`, on CPU tensors it runs
`layer_norm_plain`.  Port of cosyvoice_tpu/ops/pallas/fused_norm.py.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from cosyvoice_tpu_torch.ops.kernels import build
from cosyvoice_tpu_torch.ops.kernels.operators import define

# kernel launches so far (plain integer; callers may reset it to 0)
launches = 0


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5, act: str = "none") -> torch.Tensor:
    """y = (x - E[x]) * rsqrt(max(E[x^2] - E[x]^2, 0) + eps) * scale + bias in
    fp32 (not torch.nn.LayerNorm's two-pass variance); output dtype is
    promote(x, scale, bias)."""
    out_dtype = _out_dtype(x, scale, bias)
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    if act == "mish":
        y = y * torch.tanh(F.softplus(y))
    return y.to(out_dtype)


def _out_dtype(x, scale, bias):
    return torch.promote_types(torch.promote_types(x.dtype, scale.dtype), bias.dtype)


def _kernel(x, scale, bias, eps: float, act: str) -> torch.Tensor:
    global launches
    C = x.shape[-1]
    build.require_cuda("fused_layer_norm", x, scale, bias)
    if not (x.dtype == scale.dtype == bias.dtype):
        raise TypeError("fused_layer_norm: x, scale and bias must share one dtype, got "
                        f"{x.dtype}/{scale.dtype}/{bias.dtype}")
    if C % 32 or C > 1024:
        raise ValueError(f"fused_layer_norm: kernel takes C % 32 == 0 and C <= 1024, got {C}")
    y = torch.empty_like(x)
    rc = build.library().cvt_fused_layer_norm(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        x.numel() // C, C, float(eps), int(act == "mish"), build.dtype_code(x),
        build.stream_of(x))
    build.check_launch(rc, "fused_layer_norm")
    launches += 1
    return y


_OP = define("fused_layer_norm(Tensor x, Tensor scale, Tensor bias, float eps, str act) "
             "-> Tensor", layer_norm_plain, _kernel,
             lambda x, scale, bias, eps, act: x.new_empty(x.shape,
                                                          dtype=_out_dtype(x, scale, bias)))


def fused_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5, act: str = "none") -> torch.Tensor:
    """LayerNorm over the last axis of x [..., C] (+ optional fused mish)."""
    if act not in ("none", "mish"):
        raise ValueError(f"fused_layer_norm: act must be none|mish, got {act}")
    C = x.shape[-1]
    if scale.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"fused_layer_norm: scale/bias must be [{C}]")
    if build.needs_autograd("fused_layer_norm", x, scale, bias):
        return layer_norm_plain(x, scale, bias, eps, act)
    return _OP(x, scale, bias, float(eps), act)
