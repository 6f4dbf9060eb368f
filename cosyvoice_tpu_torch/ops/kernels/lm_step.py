"""Whole-step B=1 Qwen2 decode: every layer of one decode step in one kernel.

`lm_step` launches the cooperative CUDA kernel in `csrc/lm_step.cu` for CUDA
tensors (one block an SM; `plan` cuts every phase into one item a block, and
the wrapper keeps the split-K partials per device and stream) and runs
`lm_step_plain`, the same function in plain PyTorch, for CPU tensors.  The weights are the int8 projections of the Qwen2 body stacked
per layer in the JAX package's [in, out] layout (`pack_step_weights`); the
cache is stacked [L, C, KH*D] (`cache_to_step_layout`).  Both versions write
the step's new k/v into the cache at row `pos` in place (the JAX package
returns them for the caller to scatter).  Port of
cosyvoice_tpu/ops/pallas/lm_step.py.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from cosyvoice_tpu_torch.ops.kernels import build

_LOG2E = 1.4426950408889634
# kernel launches so far (plain integer; callers may reset it to 0)
launches = 0
# split-K partials and the residual stream, per (device, raw stream) (build.scratch_for)
_scratch: dict = {}

THREADS = 512                  # a block of the kernel; one block an SM
HEAD_DIM = 64                  # the one head width the kernel instantiates
_TILES = (16, 32, 64, 128, 256)
_ATTN_STRIDE = 2 + HEAD_DIM    # a chunk's attention partial: max, sum, acc


def _gemv_plan(K: int, N: int, nm: int, sms: int) -> dict:
    """Column tile x input-row split of a GEMV phase of nm int8 [K, N]
    matrices with at most `sms` items, minimising the largest item's bytes
    (then the splits, whose partials the next phase reads)."""
    best = None
    for tc in _TILES:
        if N % tc or tc * nm > 512 or N // tc > sms:
            continue
        rows = -(-K // min(sms // (N // tc), K))
        splits = -(-K // rows)
        key = (nm * rows * tc, splits)
        if best is None or key < best[0]:
            best = (key, dict(cols=tc, splits=splits, rows=rows, items=N // tc * splits,
                              item_bytes=nm * rows * tc))
    if best is None:
        raise ValueError(f"lm_step: no tiling of a [{K}, {N}] GEMV fits {sms} blocks")
    return best[1]


@functools.lru_cache(maxsize=None)
def plan(H: int, I: int, nq: int, nkv: int, C: int, sms: int, itemsize: int = 2) -> dict:
    """How the kernel cuts a step for these widths on `sms` SMs (one block
    each): per GEMV phase (qkv, o, gate_up, down) its column tile, input-row
    splits and rows a split; the attention's keys a chunk (32, doubled until
    nkv x chunks of the whole cache fit the grid); each phase's shared-memory
    region (its share: weights, or a chunk's K and V rows of `itemsize`-byte
    values padded by 16 bytes, then the fp32 vectors the phase reads) and
    the kernel's dynamic shared memory, which the kernel computes the same
    way (csrc/lm_step.cu check_plan)."""
    QKVW = (nq + 2 * nkv) * HEAD_DIM
    p = {"qkv": _gemv_plan(H, QKVW, 1, sms), "o": _gemv_plan(nq * HEAD_DIM, H, 1, sms),
         "gate_up": _gemv_plan(H, I, 2, sms), "down": _gemv_plan(I, H, 1, sms)}
    chunk = 32
    while nkv * -(-C // chunk) > sms:
        chunk *= 2
    if p["o"]["rows"] > THREADS:
        raise ValueError(f"lm_step: {p['o']['rows']} o-proj rows a block exceed {THREADS}")
    chunks = -(-C // chunk)
    grp = nq // nkv
    attn_bytes = 2 * chunk * (HEAD_DIM * itemsize + 16)
    # each phase's region holds its share and, behind it, the fp32 vectors
    # the phase reads: norm weights and the residual's scales (qkv,
    # gate_up), the rows' gate and up scales from a 16-byte boundary (down),
    # the group's qkv scales and biases (attention)
    side = {"qkv": 2 * H, "o": 0, "gate_up": 2 * H,
            "down": 2 * -(-(p["down"]["rows"] + 4) // 4) * 4}
    region = {k: -(-v["item_bytes"] // 16) * 16 + 4 * side[k] for k, v in p.items()}
    region["attention"] = attn_bytes + 4 * 2 * (grp + 2) * HEAD_DIM
    region = {k: -(-region[k] // 16) * 16 for k in ("qkv", "attention", "o", "gate_up", "down")}
    red = max(v["cols"] * (2 if k == "gate_up" else 1) for k, v in p.items())
    vec = max(H, p["o"]["rows"] + (p["o"]["rows"] // HEAD_DIM + 2) * (chunks + 1),
              p["down"]["rows"], 2 * grp * HEAD_DIM + 3 * HEAD_DIM + grp * chunk)
    smem = sum(region.values()) + 4 * (THREADS // 32 * red + vec)
    floats = (p["qkv"]["splits"] * QKVW + nq * chunks * _ATTN_STRIDE + p["o"]["splits"] * H
              + p["gate_up"]["splits"] * 2 * I + p["down"]["splits"] * H + 2 * H)
    return dict(p, attention=dict(chunk=chunk, chunks=chunks, items=nkv * chunks,
                                  item_bytes=attn_bytes),
                blocks=sms, threads=THREADS, region_bytes=region, smem_bytes=smem,
                scratch_floats=floats)


def _plan_args(p: dict):
    gemv = [p[k] for k in ("qkv", "o", "gate_up", "down")]
    vals = ([g["cols"] for g in gemv] + [g["splits"] for g in gemv]
            + [g["rows"] for g in gemv] + [p["attention"]["chunk"]])
    return (ctypes.c_int * len(vals))(*vals)


class StepWeights(NamedTuple):
    """Per-layer stacks [L, ...]: int8 kernels [in, out], fp32 scales, biases
    and norm weights."""

    wqkv: torch.Tensor   # [L, H, (nq + 2 nkv) * hd] int8
    sqkv: torch.Tensor   # [L, (nq + 2 nkv) * hd]
    bqkv: torch.Tensor   # [L, (nq + 2 nkv) * hd]
    wo: torch.Tensor     # [L, nq * hd, H] int8
    so: torch.Tensor     # [L, H]
    wg: torch.Tensor     # [L, H, I] int8
    sg: torch.Tensor     # [L, I]
    wu: torch.Tensor     # [L, H, I] int8
    su: torch.Tensor     # [L, I]
    wd: torch.Tensor     # [L, I, H] int8
    sd: torch.Tensor     # [L, H]
    n1: torch.Tensor     # [L, H] input_layernorm
    n2: torch.Tensor     # [L, H] post_attention_layernorm


def pack_step_weights(state_dict: dict, num_layers: int) -> StepWeights:
    """Stack the int8 layers of a Qwen2 body state_dict (QDense(quant="int8"),
    keys `layers.{i}.self_attn.q_proj.weight`, ...) into StepWeights (load time)."""
    def stk(name, key, transpose=False):
        ts = [state_dict[f"layers.{i}.{name}.{key}"] for i in range(num_layers)]
        ts = [t.t() if transpose else t.float() for t in ts]
        return torch.stack(ts).contiguous()

    att = {p: f"self_attn.{p}" for p in ("q_proj", "k_proj", "v_proj", "o_proj")}
    mlp = {p: f"mlp.{p}" for p in ("gate_proj", "up_proj", "down_proj")}
    qkv = [att[p] for p in ("q_proj", "k_proj", "v_proj")]
    return StepWeights(
        wqkv=torch.cat([stk(n, "weight", True) for n in qkv], dim=2).contiguous(),
        sqkv=torch.cat([stk(n, "scale") for n in qkv], dim=1).contiguous(),
        bqkv=torch.cat([stk(n, "bias") for n in qkv], dim=1).contiguous(),
        wo=stk(att["o_proj"], "weight", True), so=stk(att["o_proj"], "scale"),
        wg=stk(mlp["gate_proj"], "weight", True), sg=stk(mlp["gate_proj"], "scale"),
        wu=stk(mlp["up_proj"], "weight", True), su=stk(mlp["up_proj"], "scale"),
        wd=stk(mlp["down_proj"], "weight", True), sd=stk(mlp["down_proj"], "scale"),
        n1=stk("input_layernorm", "weight"), n2=stk("post_attention_layernorm", "weight"))


def random_step_weights(L: int, H: int, I: int, nq: int, nkv: int, hd: int,
                        generator: torch.Generator, device) -> StepWeights:
    """Seeded random int8 step weights (uniform in [-127, 127]) whose scales,
    ~1 / (73 sqrt(in)), keep every projection's output O(1): inputs for
    holding the kernel against its plain version at real widths."""
    def w(k, n):
        return torch.randint(-127, 128, (L, k, n), generator=generator, device=device,
                             dtype=torch.int8)

    def s(k, n):
        return (torch.rand(L, n, generator=generator, device=device) + 0.5) / (73.0 * k ** 0.5)

    def r(n, mean):
        return torch.randn(L, n, generator=generator, device=device) * 0.1 + mean

    QKVW = (nq + 2 * nkv) * hd
    return StepWeights(wqkv=w(H, QKVW), sqkv=s(H, QKVW), bqkv=r(QKVW, 0.0),
                       wo=w(nq * hd, H), so=s(nq * hd, H), wg=w(H, I), sg=s(H, I),
                       wu=w(H, I), su=s(H, I), wd=w(I, H), sd=s(I, H),
                       n1=r(H, 1.0), n2=r(H, 1.0))


def cache_to_step_layout(k_list, v_list, cache_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-layer B=1 caches, head-major [1, KH, T, D] or packed [1, T, KH*D],
    -> stacked [L, cache_len, KH*D] (heads packed along the last dim)."""
    def one(c):
        r = c[0].transpose(0, 1).reshape(c.shape[2], -1) if c.ndim == 4 else c[0]
        if r.shape[0] < cache_len:
            r = torch.cat([r, r.new_zeros(cache_len - r.shape[0], r.shape[1])])
        return r[:cache_len]

    return (torch.stack([one(c) for c in k_list]).contiguous(),
            torch.stack([one(c) for c in v_list]).contiguous())


def _rms(x, g, eps):
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * g.float()).to(x.dtype)


def _dq(h, w, s, b=None):
    """QDense int8: fp32-accumulated dot -> h.dtype -> * scale [+ bias] in h.dtype."""
    y = (h.float() @ w.float()).to(h.dtype)
    y = y * s.to(h.dtype)
    return y if b is None else y + b.to(h.dtype)


def lm_step_plain(w: StepWeights, x, kc, vc, pos: int, cos, sin, *, nq: int, nkv: int,
                  hd: int, eps: float = 1e-6):
    """Plain version (twin of `lm_step_xla`); arguments as `lm_step`."""
    L = w.wqkv.shape[0]
    dt = x.dtype
    grp = nq // nkv
    qscale = 1.0 / math.sqrt(hd) * _LOG2E
    cos, sin = cos.reshape(-1).float(), sin.reshape(-1).float()
    half = hd // 2

    def rope(t):
        tf = t.float()
        rot = torch.cat([-tf[:, half:], tf[:, :half]], dim=1)
        return tf * cos + rot * sin

    xr = x
    for l in range(L):
        h = _rms(xr, w.n1[l], eps)
        qkv = _dq(h, w.wqkv[l], w.sqkv[l], w.bqkv[l])[0]
        qh = rope(qkv[:nq * hd].reshape(nq, hd))
        kh = rope(qkv[nq * hd:(nq + nkv) * hd].reshape(nkv, hd))
        vh = qkv[(nq + nkv) * hd:].reshape(nkv, hd).float()
        kc[l, pos] = kh.reshape(-1).to(kc.dtype)
        vc[l, pos] = vh.reshape(-1).to(vc.dtype)
        o_parts = []
        for hh in range(nkv):
            sl = slice(hh * hd, (hh + 1) * hd)
            q7 = (qh[hh * grp:(hh + 1) * grp] * qscale).to(dt).float()
            s = q7 @ kc[l, :pos, sl].float().t()                       # [grp, pos]
            s_new = q7 @ kh[hh].to(dt).float()                          # [grp]
            m = torch.maximum(s.amax(dim=1), s_new) if pos else s_new
            pc = torch.exp2(s - m[:, None])
            pn = torch.exp2(s_new - m)
            denom = pc.sum(dim=1) + pn
            oh = pc.to(vc.dtype).float() @ vc[l, :pos, sl].float()
            oh = (oh + pn[:, None] * vh[hh]) / denom[:, None]
            o_parts.append(oh.to(dt))
        xr = xr + _dq(torch.cat(o_parts).reshape(1, nq * hd), w.wo[l], w.so[l])
        h2 = _rms(xr, w.n2[l], eps)
        g = _dq(h2, w.wg[l], w.sg[l])
        u = _dq(h2, w.wu[l], w.su[l])
        gf = g.float()
        xr = xr + _dq((gf * torch.sigmoid(gf)).to(dt) * u, w.wd[l], w.sd[l])
    return xr


def _raise_for(rc: int) -> None:
    if rc == -1:
        raise RuntimeError("lm_step: the device does not support cooperative launches "
                           "(cudaDevAttrCooperativeLaunch is 0)")
    if rc == -2:
        raise RuntimeError("lm_step: the grid exceeds the blocks the device can hold at "
                           "once (cudaErrorCooperativeLaunchTooLarge)")
    if rc == -3:
        raise RuntimeError("lm_step: the kernel refused the launch plan for these widths")
    build.check_launch(rc, "lm_step")


def lm_step(w: StepWeights, x: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor, pos: int,
            cos: torch.Tensor, sin: torch.Tensor, *, nq: int, nkv: int, hd: int,
            eps: float = 1e-6) -> torch.Tensor:
    """One whole B=1 decode step through all L layers.

    x        [1, H] the step's input embedding (float32 or bfloat16)
    kc, vc   [L, C, nkv*hd] stacked caches in x's dtype; rows < pos are the
             context, row pos is WRITTEN IN PLACE with this step's k/v
    pos      number of valid cache rows (0 <= pos < C)
    cos, sin [hd] float32 RoPE at position pos
    returns  y [1, H], the last layer's output before the final norm
    """
    global launches
    L, H, QKVW = w.wqkv.shape
    I = w.wg.shape[2]
    C = kc.shape[1]
    KHD = nkv * hd
    if (x.shape != (1, H) or QKVW != (nq + 2 * nkv) * hd or nq % nkv
            or kc.shape != (L, C, KHD) or vc.shape != kc.shape
            or cos.numel() != hd or sin.numel() != hd):
        raise ValueError(f"lm_step: inconsistent shapes x{tuple(x.shape)} "
                         f"wqkv{tuple(w.wqkv.shape)} kc{tuple(kc.shape)} "
                         f"nq={nq} nkv={nkv} hd={hd}")
    if not 0 <= pos < C:
        raise ValueError(f"lm_step: pos {pos} outside the cache of {C} rows")
    if x.device.type == "cpu":
        return lm_step_plain(w, x, kc, vc, pos, cos, sin, nq=nq, nkv=nkv, hd=hd, eps=eps)
    build.require_cuda("lm_step", x, kc, vc, cos, sin, *w)
    if not x.dtype == kc.dtype == vc.dtype:
        raise TypeError("lm_step: x and the caches must share one dtype")
    if any(t.dtype != torch.int8 for t in (w.wqkv, w.wo, w.wg, w.wu, w.wd)) or any(
            t.dtype != torch.float32 for t in (cos, sin, w.sqkv, w.bqkv, w.so, w.sg,
                                               w.su, w.sd, w.n1, w.n2)):
        raise TypeError("lm_step: int8 kernels with float32 scales, biases, norms "
                        "and RoPE tables expected")
    if hd != HEAD_DIM or H % 64 or I % 64:
        raise ValueError(f"lm_step: kernel takes head_dim 64 and widths that are "
                         f"multiples of 64, got hd={hd} H={H} I={I}")
    if any(t.data_ptr() % 16 for t in (x, kc, vc, w.wqkv, w.wo, w.wg, w.wu, w.wd)):
        raise ValueError("lm_step: x, the caches and the int8 kernels must start "
                         "16-byte aligned")
    p = plan(H, I, nq, nkv, C, torch.cuda.get_device_properties(x.device).multi_processor_count,
             x.element_size())
    stream = build.stream_of(x)
    _, work = build.scratch_for(_scratch, x.device, stream, 0, p["scratch_floats"])
    y = x.clone()
    rc = build.library().cvt_lm_step(
        y.data_ptr(), kc.data_ptr(), vc.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        *(t.data_ptr() for t in w), work.data_ptr(), _plan_args(p),
        L, H, I, nq, nkv, C, int(pos), float(eps), float(1.0 / math.sqrt(hd) * _LOG2E),
        build.dtype_code(x), stream)
    _raise_for(rc)
    launches += 1
    return y


def sync_probe(n_syncs: int, device) -> int:
    """Launch `n_syncs` grid barriers, nothing else, on the grid `lm_step`
    launches (one block of THREADS threads an SM), to time the barriers'
    share of a step; returns the grid's block count.  Not counted in
    `launches`."""
    grid = ctypes.c_int(0)
    probe = torch.empty(0, device=device)
    rc = build.library().cvt_lm_step_sync_probe(n_syncs, ctypes.byref(grid),
                                                build.stream_of(probe))
    _raise_for(rc)
    return grid.value


def int8_to_float(t: torch.Tensor) -> torch.Tensor:
    """float32 copy of a CUDA int8 tensor through the kernel's own int8 ->
    fp32 conversion (byte permutes into a float's mantissa, no I2F), to hold
    that conversion to exactness; numel a multiple of 4."""
    build.require_cuda("lm_step int8_to_float", t)
    if t.dtype != torch.int8 or t.numel() % 4:
        raise ValueError("int8_to_float: an int8 tensor of 4k elements expected")
    out = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    build.check_launch(build.library().cvt_lm_step_int8_to_float(
        t.data_ptr(), out.data_ptr(), t.numel(), build.stream_of(t)), "lm_step int8_to_float")
    return out
