"""Fused anti-aliased Snake/SnakeBeta activation: 2x Kaiser-sinc upsample ->
snake -> 12-tap lowpass -> 2x decimate in one pass over x (BigVGAN's AAAct).

`snake_aa` launches the CUDA kernel in `csrc/snake_aa.cu` for CUDA tensors
and runs `snake_aa_plain` for CPU tensors.  Port of
cosyvoice_tpu/ops/pallas/snake_aa.py::snake_aa_pallas.  It computes what
that kernel computes, which is not the composite `ops/resample.py::
anti_alias_activation`: here x is clamped to [0, T-1] and the upsampled
samples u outside [0, 2T) are computed (and activated) from the clamped x,
where the composite replicates u itself, so the first and last ~6 outputs
differ by design.  With the 12 taps h = kaiser_sinc_filter1d(0.25, 0.3, 12):

    u[n] = 2 * sum_j h[j] * x[(n + 15 - j) / 2 - 5]   (6 taps j of n's parity)
    y[i] = sum_{j<12} h[j] * snake(u[2i + j - 5])

fp32 in, fp32 out (the JAX kernel's VMEM scratch and output are fp32).
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional

import torch
import torch.nn.functional as F

from cosyvoice_tpu_torch.ops.kernels import build
from cosyvoice_tpu_torch.ops.resample import kaiser_sinc_filter1d

KS = 12          # filter taps
PAD = 6          # clamped x rows each side: u is needed at n in [-6, 2T + 6)

# kernel launches so far (plain integer; callers may reset it to 0)
launches = 0


@lru_cache(maxsize=None)
def taps() -> tuple:
    """The 12 fp32 taps, exactly as numpy computes them."""
    return tuple(float(v) for v in kaiser_sinc_filter1d(0.25, 0.3, KS))


def snake_aa_plain(x: torch.Tensor, alpha: torch.Tensor,
                   beta: Optional[torch.Tensor] = None,
                   logscale: bool = True) -> torch.Tensor:
    """x [B, T, C] -> y [B, T, C] fp32: the kernel's function in PyTorch.
    Pads x by clamped indices, takes both polyphase halves of the upsample
    over the padded signal without cropping, applies snake at every u, then
    the stride-2 12-tap lowpass.  beta None uses snake with alpha."""
    B, T, C = x.shape
    h = torch.tensor(taps(), dtype=torch.float32, device=x.device)
    idx = torch.arange(-PAD, T + PAD, device=x.device).clamp(0, T - 1)
    xp = x.float().transpose(1, 2)[:, :, idx].reshape(B * C, 1, T + 2 * PAD)
    # u[2a] = 2 sum_r h[11 - 2r] x[a - 3 + r], u[2a + 1] = 2 sum_r h[10 - 2r] x[a - 2 + r]
    # for a in [-3, T + 3), i.e. n in [-6, 2T + 6)
    u_even = 2.0 * F.conv1d(xp, h[1::2].flip(0).view(1, 1, 6))[..., :T + PAD]
    u_odd = 2.0 * F.conv1d(xp, h[0::2].flip(0).view(1, 1, 6))[..., 1:T + PAD + 1]
    u = torch.stack([u_even, u_odd], dim=-1).reshape(B, C, 2 * T + 2 * PAD)
    a = alpha.float()
    b = a if beta is None else beta.float()
    if logscale:
        a, b = torch.exp(a), torch.exp(b)
    s = torch.sin(a[None, :, None] * u)
    s = u + (1.0 / (b[None, :, None] + 1e-9)) * s * s
    # y[i] = sum_j h[j] s[2i + j - 5]; s index 0 is n = -6
    y = F.conv1d(s[..., 1:].reshape(B * C, 1, -1), h.view(1, 1, KS), stride=2)
    return y.reshape(B, C, T).transpose(1, 2).contiguous()


def snake_aa(x: torch.Tensor, alpha: torch.Tensor, beta: Optional[torch.Tensor] = None,
             logscale: bool = True) -> torch.Tensor:
    """Anti-aliased Snake (beta None) or SnakeBeta over x [B, T, C] with
    per-channel alpha, beta [C]; returns fp32 [B, T, C]."""
    global launches
    B, T, C = x.shape
    if alpha.shape != (C,) or (beta is not None and beta.shape != (C,)):
        raise ValueError(f"snake_aa: alpha/beta must be [{C}]")
    if T < 1:
        raise ValueError("snake_aa: T must be >= 1")
    if x.device.type == "cpu":
        return snake_aa_plain(x, alpha, beta, logscale)
    params = (alpha,) if beta is None else (alpha, beta)
    build.require_cuda("snake_aa", x, *params)
    if any(t.dtype != torch.float32 for t in (x, *params)):
        raise TypeError("snake_aa: the kernel takes float32 x, alpha and beta, got "
                        f"{[t.dtype for t in (x, *params)]}")
    y = torch.empty_like(x)
    h = (ctypes.c_float * KS)(*taps())
    rc = build.library().cvt_snake_aa(
        x.data_ptr(), alpha.data_ptr(), None if beta is None else beta.data_ptr(),
        y.data_ptr(), ctypes.addressof(h), B, T, C, int(logscale), build.stream_of(x))
    build.check_launch(rc, "snake_aa")
    launches += 1
    return y
