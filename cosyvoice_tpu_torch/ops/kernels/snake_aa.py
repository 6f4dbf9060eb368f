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

x is a logical [B, T, C] (the JAX kernel's shape) in either of two memory
layouts (`memory_layout`): channels-last (x contiguous, the TPU kernel's) or
channels-first (x.transpose(1, 2) contiguous, what BigVGAN's convolutions
give); y comes back with x's strides on both routes, so BigVGAN pays no copy.
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
CHANNELS_LAST, CHANNELS_FIRST = "channels_last", "channels_first"
# csrc/snake_aa.cu's launch geometry: warps a block, outputs a channels-last
# run, outputs a channels-first chunk (32 lanes x 8), and the most runs or
# chunks a warp's segment takes
WARPS = 8
RUN = 8
CHUNK = 256
MAX_RUNS = 8
MAX_CHUNKS = 8
# the least warps a launch should have, per SM: four waves of 32 resident
# warps, so that the last wave's tail stays small and enough loads are in
# flight to cover HBM latency
WARPS_PER_SM = 128

# kernel launches so far (plain integer; callers may reset it to 0)
launches = 0


def memory_layout(x: torch.Tensor) -> str:
    """x's memory layout as snake_aa takes it: CHANNELS_LAST where x [B, T, C]
    is contiguous, else CHANNELS_FIRST where x.transpose(1, 2) is (T = 1 or
    C = 1 makes both true: either is right, and channels-last is taken).
    Raises ValueError on any other stride pattern."""
    if x.dim() != 3:
        raise ValueError(f"snake_aa: x must be [B, T, C], got {tuple(x.shape)}")
    if x.is_contiguous():
        return CHANNELS_LAST
    if x.transpose(1, 2).is_contiguous():
        return CHANNELS_FIRST
    raise ValueError("snake_aa: x must be contiguous channels-last [B, T, C] or "
                     "channels-first (x.transpose(1, 2) contiguous), got strides "
                     f"{x.stride()} for shape {tuple(x.shape)}")


def _segments(units: int, T: int, step: int, most: int, target: int) -> int:
    """Runs (or chunks) of `step` outputs a warp's segment: the most, halved
    while `units` rows of T would give fewer than `target` warps."""
    n = most
    while n > 1 and units * -(-T // (step * n)) < target:
        n //= 2
    return n


def plan(B: int, T: int, C: int, layout: str, sms: int = 132) -> dict:
    """csrc/snake_aa.cu's launch for x [B, T, C] in `layout` on `sms` SMs:
    seg_len outputs a warp along T, the grid of WARPS-warp blocks, the
    segments a row and the warps launched.  channels-last: warps of 32
    channels, grid (channel groups, blocks of WARPS segments, B);
    channels-first: a warp a (row, segment), grid (blocks of WARPS warps,).
    `vector`: T admits the 16-byte route (the wrapper also needs the
    pointers 16-byte aligned)."""
    target = WARPS_PER_SM * sms
    if layout == CHANNELS_LAST:
        groups = -(-C // 32)
        seg = RUN * _segments(B * groups, T, RUN, MAX_RUNS, target)
        segs = -(-T // seg)
        grid = (groups, -(-segs // WARPS), B)
        warps = groups * B * segs
        vector = False
    elif layout == CHANNELS_FIRST:
        seg = CHUNK * _segments(B * C, T, CHUNK, MAX_CHUNKS, target)
        segs = -(-T // seg)
        warps = B * C * segs
        grid = (-(-warps // WARPS), 1, 1)
        vector = T % 4 == 0
    else:
        raise ValueError(f"snake_aa: unknown layout {layout}")
    return dict(layout=layout, seg_len=seg, segments=segs, warps=warps, grid=grid,
                threads=32 * WARPS, vector=vector)


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
    the stride-2 12-tap lowpass.  beta None uses snake with alpha.  Takes x
    in any memory layout; y is a channels-first view."""
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
    return y.reshape(B, C, T).transpose(1, 2)


def snake_aa(x: torch.Tensor, alpha: torch.Tensor, beta: Optional[torch.Tensor] = None,
             logscale: bool = True) -> torch.Tensor:
    """Anti-aliased Snake (beta None) or SnakeBeta over x [B, T, C] with
    per-channel alpha, beta [C]; returns fp32 [B, T, C] with x's strides
    (x channels-last or channels-first, see `memory_layout`)."""
    global launches
    lay = memory_layout(x)
    B, T, C = x.shape
    if alpha.shape != (C,) or (beta is not None and beta.shape != (C,)):
        raise ValueError(f"snake_aa: alpha/beta must be [{C}]")
    if T < 1:
        raise ValueError("snake_aa: T must be >= 1")
    if x.device.type == "cpu":
        return torch.empty_like(x, dtype=torch.float32).copy_(
            snake_aa_plain(x, alpha, beta, logscale))
    params = (alpha,) if beta is None else (alpha, beta)
    # the memory of x as a contiguous tensor, for the device and layout checks
    build.require_cuda("snake_aa", x if lay == CHANNELS_LAST else x.transpose(1, 2), *params)
    if any(t.dtype != torch.float32 for t in (x, *params)):
        raise TypeError("snake_aa: the kernel takes float32 x, alpha and beta, got "
                        f"{[t.dtype for t in (x, *params)]}")
    y = torch.empty_like(x)                 # x's strides: x is dense in either layout
    p = plan(B, T, C, lay, torch.cuda.get_device_properties(x.device).multi_processor_count)
    vec = p["vector"] and x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    h = (ctypes.c_float * KS)(*taps())
    rc = build.library().cvt_snake_aa(
        x.data_ptr(), alpha.data_ptr(), None if beta is None else beta.data_ptr(),
        y.data_ptr(), ctypes.addressof(h), B, T, C, int(logscale), int(lay == CHANNELS_FIRST),
        int(vec), p["seg_len"], *p["grid"], build.stream_of(x))
    build.check_launch(rc, "snake_aa")
    launches += 1
    return y


def sin2_mismatches(device="cuda") -> int:
    """How many floats z with |z| < 105615 (both signs) get other bits from
    the kernel's branch-free copy of sinf's fast path, squared, than from
    sinf(z)^2 (csrc/snake_aa.cu sin2): 0 on a toolkit whose sinf it copies."""
    count = torch.zeros(1, dtype=torch.int64, device=device)
    build.check_launch(build.library().cvt_snake_aa_sin2_mismatches(
        count.data_ptr(), build.stream_of(count)), "snake_aa sin2 check")
    return int(count.item())
