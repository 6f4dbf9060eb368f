#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of CosyVoice2 on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repo root; needs one CUDA GPU
    python3 chip_smoke.py --profile  # also profile one more request

Phases, each printing JSON lines:
  1. device  - the card's name and power limit (nvidia-smi);
  2. build   - compile the port's CUDA kernels from cosyvoice_tpu_torch/csrc;
  3. kernels - hold each kernel against its plain PyTorch version (fp32, bf16):
     K1 at B = 4 with per-row frontiers and at B = 1 on each side of the
     split kernel's chunk boundaries (pos 0, 1, chunk - 1, chunk, chunk + 1,
     Tc - 1 at three cache lengths), the cache equal after each call; K2 at
     T = 640, 1152 and 700 with lengths 0, 1, 63, 64, 65 and T, packed and
     unpacked (bf16 bar: K2_BF16_ULPS ulps at max |plain| of each (batch
     row, head));
  4. reference - a small stack on the GPU (kernels) against the same stack on
     the CPU (plain versions): greedy tokens exact, waveform within 1e-2;
  5. main path - build the full-width serving stack (Qwen2-0.5B int8 LM over
     the packed decode cache, bf16 flow with fused attention/norm, bf16 HiFT)
     on seeded random weights and answer 3 zero-shot requests through
     CosyVoice2.inference_zero_shot; every kernel must launch;
  6. fused_step - the main path's int8 LM (same weights) with greedy
     sampling from the first request's prompt, 200 steps, through
     lm_generate (K1 in every layer) and lm_generate_fused_step (one K6
     launch a step): ms/token of each, K6 launches (must equal the decode
     steps), the free-running token match and the teacher-forced argmax
     agreement of K6 against the K1 path;
  7. int4    - one full-width zero-shot request with the LM quantized to
     packed int4 (group 128) from the same seeded bf16 weights: latency,
     RTF, LM ms/token, K5 launches (must be > 0), a finite waveform, and
     the teacher-forced argmax agreement with the bf16 LM;
  8. batched - BatchedSynthesizer.synthesize_batch over 8 zero-shot requests
     (the main path's weights and prompt, decode caps spread over 100-200
     tokens) with the estimator's fused_block on: one warm-up batch, then
     one timed batch: wall time, LM / flow / HiFT seconds, seconds of audio,
     aggregate RTF, peak memory, K4 launches (must be 56 DiT blocks x 10
     Euler steps) and K1 launches, and the mel difference between
     fused_block on and off for the same flow inputs;
  9. engine  - ServingEngine.generate, 16 requests through 8 slots (staggered
     admission, slot reuse): on a small fp32 stack (greedy tokens must equal
     a B=1 lm_generate of each request), then on the main path's int8 LM
     with greedy sampling (K1's per-row pos mode): tokens/s, segments, K1
     launches and the share of requests equal to a B=1 lm_generate (no gate
     at full width in bf16: a batch-dependent order of sums can flip a
     near-tied argmax);
 10. bigvgan - the BigVGAN token->wav vocoder at the full width of the
     recipe (examples/tts_vc/cosyvoice2/conf/cosyvoice2_bigvgan_tts.yaml:
     two 512-d conformer encoders, rates [8, 5, 3, 2], 1536 initial
     channels) on seeded random weights, every anti-aliased activation
     through K7 (snake_aa) on the convolutions' channels-first memory: 4
     rows of 250/200/150/100 tokens (10/8/6/4 s of 24 kHz audio), one
     warm-up and one timed forward: wall time, seconds of audio, RTF, peak
     memory, K7 launches (must be 73: 4 stages x 3 resblocks x 6, plus
     activation_post; 18/18/18/19 by stage shape) and the layout of each
     input, a finite wav in [-1, 1], K7's device time and share (every
     kernel named snake_aa*; must be > 0) beside the copy kernels' device
     time and launches a forward, and the wav difference and the wall time
     with the composite activations instead (printed only: the first and
     last ~6 samples of each activation differ by design);
 11. stream  - one full-width zero-shot request streamed through
     CosyVoice2.inference_zero_shot(stream=True) with the main path's
     weights, greedy sampling and a 200-token cap, after one warm-up
     stream: first-chunk latency, per-chunk seconds (each split into
     frontend, LM prefill, flow, HiFT and decode/host), wall, RTF, the chunk
     lengths (must follow the hop-50 / lookahead-3 / 8-frame-cache formula),
     the token count (must equal a non-streaming greedy decode's) and the
     K1/K2/K3 launches (each must be > 0);
 12. timing  - at the main path's shapes: each kernel against its plain
     version on the same inputs, then the kernel, the plain version and the
     one PyTorch call that computes the same function, timed (CUDA events);
     K1 also at the engine's shape (B = 8, cache 384, per-row frontiers)
     beside SDPA with a boolean key mask;
     K4 at the batched phase's flow shape, beside the port's unfused block;
     K7 fp32 at the recipe's four stage shapes with x channels-first (the
     path's layout) and channels-last (nested), beside the composite
     anti_alias_activation (no one PyTorch call computes K7) and, at the
     third stage, the layout copy AAAct no longer makes;
     K5 one row a projection shape and a decode step's 168 launches, beside
     torch._weight_int4pack_mm (PyTorch's group-wise int4 matmul, zero
     points 0) on the same inputs.  Every row and yardstick also gets its
     device time (dev_time: the median of three CUDA-graph replays, all
     three printed).
Phase 3 also holds K3 on both of its routes (K3_CASES), K5 (int4_matmul;
its decode route's block count at K5_MIN_BLOCKS) and K6 (lm_step) against
their plain versions at the shapes phases 6 and 7 give them (K5 at 1, 3, 8
and 200 rows), K6's launch plan (at most one item a block a phase, a grid of
one block an SM, two launches bit-identical), K4 (dit_block) at the
estimator's full width with ragged lengths and a ragged T, and K7 (snake_aa)
at the recipe's first and last stage shapes and its edge cases in both
layouts, and its copy of sinf's fast path against sinf over every float
below 105615.  The timing
phase's K6 row adds its grid, plan, barrier share (sync_dev_ms: its 5 x L
grid barriers alone) and hbm_share (bytes / device time / 3.35 TB/s); the K4
row its launches' device times by kernel (phase_ms: LN1 + qkv, K2's
attention kernel, out-proj + LN3 + FFN) and K2 alone at the block's qkv
shape (k2_dev_ms).
The last line is {"ok": true, "device": {...}}.  Any failure exits non-zero.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12            # dense bf16 tensor-core peak
FP32_FLOPS = 67e12             # fp32 outside the tensor cores (K7's work)
# K7's fp32 operations per output: two upsampled samples of 6 taps and a
# snake (~20 with its sin) each, then the 12-tap decimation
K7_FLOPS_PER_OUTPUT = 2 * (6 * 2 + 20) + 12 * 2
# the recipe's four stage shapes, where the bigvgan phase runs K7: 4 rows of
# up to 250 tokens after the two 2x encoders and rates 8, 8*5, 8*5*3 and
# 8*5*3*2, with 1536 / 2^(i+1) channels
K7_STAGES = ((4, 8000, 768), (4, 40000, 384), (4, 120000, 192), (4, 240000, 96))
# K7 cases of phase 3 (each in both layouts): the recipe's first and last
# stage shapes, then T = 1, T = 5 with C = 3 (both edges clamp), beta absent,
# linear-scale alpha/beta, and C not a multiple of the channels-last route's
# 32-channel warp (T = 5, 130: the channels-first route's scalar loads)
K7_CASES = (((4, 8000, 768), True, True), ((4, 240000, 96), True, True),
            ((1, 1, 40), True, True), ((2, 5, 3), False, True), ((3, 700, 3), True, False),
            ((1, 130, 100), False, False))
# (atol, rtol) of a kernel against its plain version.  Both compute in fp32.
# fp32: they differ only in the order of the sums (~1e-6 at these shapes).
# bf16: both round one fp32 result to bf16 once, so they may differ by one
# bf16 ulp of |y| (<= 2**-7 |y|) and, near zero, by the fp32 difference.
CHECK_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-4, 2.0 ** -7)}
# K6 (lm_step) bar: max |kernel - plain| <= rel * max |plain| over the output
# hidden state and every layer's new k/v.  fp32: the two differ only in the
# order of fp32 sums (measured 1e-6 of max |y| at 24 layers).  bf16: both
# round every intermediate the way the JAX step does, but a sum that lands
# next to a bf16 rounding boundary can round the other way in one of them,
# and 24 random layers carry and grow that ulp: measured 2.6e-2 of max |y|
# (5.5 ulps of |y| ~ 13) on an H100, so the bar is twice that.
K6_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 6e-2}
# the LM's projection shapes (in, out) at Qwen2-0.5B width: q/o, k/v, gate/up, down
K5_SHAPES = ((896, 896), (896, 128), (896, 4864), (4864, 896))
# the projections of one decode step of a layer: q, k, v, o, gate, up, down
K5_STEP = ((896, 896), (896, 128), (896, 128), (896, 896), (896, 4864), (896, 4864),
           (4864, 896))
# K5's row counts in phase 3: decode (1 row, the split route) and 3, 8 and
# 200 rows (the 8-row prefill kernel)
K5_ROWS = (1, 3, 8, 200)
# the least blocks K5's decode route may launch at one row: one an SM at the
# three wide shapes; 896 -> 128 has only 57 KB of packed weights
K5_MIN_BLOCKS = {(896, 896): 132, (896, 128): 56, (896, 4864): 132, (4864, 896): 132}
# K3 cases of phase 3 (rows, C, x's offset in elements from a 16-byte boundary)
K3_CASES = ((2304, 256, 0), (1281, 256, 0), (37, 1024, 0), (37, 64, 0), (37, 96, 0),
            (100, 256, 1))
# K4 (dit_block) bar in bf16, on y and, on its own, on the attention output o
# (before the out projection; y is dominated by the residual, so a partial
# attention fault could hide in it): max |kernel - plain| <= K4_BF16_ULPS
# bf16 ulps at max |plain| of that tensor.  Both round at the TPU kernel's
# points, but a sum taken in another order (or p rounded against the online
# softmax's running max) can land across a bf16 rounding boundary, so o and
# the residual sums x1 and y may each move by one ulp.  fp32: CHECK_TOL.
K4_BF16_ULPS = 2
# K2 (dit_attention) bar in bf16: |kernel - plain| <= K2_BF16_ULPS bf16 ulps
# at the max |plain| of each (batch row, head) over its valid rows.  Both
# round q * sm_scale * log2 e and p to bf16 (the TPU kernel's points), but the
# kernel rounds p against the online softmax's running max and the plain
# version against the row max, so a p may round apart, a difference relative
# to the row and head's own magnitude; where the terms of an output cancel,
# that moves it by more than the elementwise CHECK_TOL allows a small |o|
# (each such check prints the share of elements outside CHECK_TOL).  fp32:
# CHECK_TOL.
K2_BF16_ULPS = 2
# K1's shape in the engine and batched phases: 8 rows of a 384-row cache with
# per-row frontiers spread over 100-380
K1_BATCH_POS = (100, 140, 180, 220, 260, 300, 340, 380)
# the batched phase: new-text lengths of 5-10 bytes give decode caps of 100-200
BATCH_TEXTS = ("Hello", "Hi there", "Good night", "See you", "Thank you", "Go ahead",
               "Next one", "Hi you")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def timed(stage: dict, key: str, fn):
    """fn, adding its synchronised host time to stage[key] on every call."""
    def run(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        stage[key] += time.perf_counter() - t0
        return out
    return run


def time_ms(fn, iters: int = 50) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rand_init_(module: torch.nn.Module, seed: int) -> None:
    """Seeded fan-in-scaled random weights: matrices and conv kernels
    ~ N(0, 1/sqrt(fan_in)), embedding tables ~ N(0, 0.02), 1-D non-bias
    params (norm scales, snake alphas) = 1, biases = 0."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.ndim >= 2:
                std = 0.02 if "embed" in name else (p.numel() // p.shape[0]) ** -0.5
                p.copy_(torch.randn(p.shape, generator=g, device="cuda") * std)
            elif "bias" not in name:
                p.fill_(1.0)
            else:
                p.zero_()


def check(name, dtype, got, want, phase="kernels"):
    """got against want within CHECK_TOL; every value finite."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    finite = bool(torch.isfinite(got).all())
    atol, rtol = CHECK_TOL[dtype]
    ok = bool(torch.allclose(got, want, atol=atol, rtol=rtol)) and finite
    emit({"phase": phase, "check": name, "dtype": str(dtype).split(".")[1],
          "max_abs_err": err, "atol": atol, "rtol": rtol, "finite": finite, "ok": ok})
    if not ok:
        raise AssertionError(f"{name} ({dtype}) disagrees with its plain version: {err}")
    return err


def check_attention(name, dtype, got, want, lengths, phase="kernels") -> float:
    """K2's [B, T, H, D] output against its plain version on the valid rows
    (t < lengths[b]): within CHECK_TOL (fp32), or (bf16) within K2_BF16_ULPS
    bf16 ulps at the max |plain| of each (batch row, head); every value
    finite."""
    got, want = got.float(), want.float()
    valid = (torch.arange(got.shape[1], device=got.device)[None, :]
             < lengths[:, None])[:, :, None, None].expand_as(got)
    diff = torch.where(valid, (got - want).abs(), 0.0)
    err = float(diff.max())
    finite = bool(torch.isfinite(got).all())
    atol, rtol = CHECK_TOL[dtype]
    outside = float((diff > atol + rtol * want.abs())[valid].float().mean())
    if dtype == torch.bfloat16:
        top = torch.where(valid, want.abs(), 0.0).amax(dim=(1, 3), keepdim=True)
        limit = K2_BF16_ULPS * torch.where(top > 0, torch.exp2(torch.floor(torch.log2(top)) - 7),
                                           0.0)
        live = limit > 0
        ok = bool((diff <= limit).all())
        bar = dict(bf16_ulps=K2_BF16_ULPS, limit_min=float(limit[live].min()),
                   limit_max=float(limit[live].max()),
                   worst_err_over_limit=float((diff.amax(dim=(1, 3), keepdim=True)
                                               / limit)[live].max()),
                   outside_check_tol=outside)
    else:
        ok, bar = outside == 0.0, dict(atol=atol, rtol=rtol)
    ok = ok and finite
    emit({"phase": phase, "check": name, "dtype": str(dtype).split(".")[1],
          "max_abs_err": err, **bar, "finite": finite, "ok": ok})
    if not ok:
        raise AssertionError(f"{name} ({dtype}) disagrees with its plain version: {err}")
    return err


def check_k1(K1, dtype, q, kn, vn, ck, cv, bias, pos, name="lm_decode_attention",
             phase="kernels") -> float:
    """One K1 step against its plain version on copies of the cache: the
    output within CHECK_TOL, the cache (with its appended rows) equal."""
    ck2, cv2 = ck.clone(), cv.clone()
    o, _, _ = K1.lm_decode_attention(q, kn, vn, ck, cv, bias, pos, 64, 0.125)
    o_ref, _, _ = K1.lm_decode_attention_plain(q, kn, vn, ck2, cv2, bias, pos, 64, 0.125)
    err = check(name, dtype, o, o_ref, phase=phase)
    if not (torch.equal(ck, ck2) and torch.equal(cv, cv2)):
        raise AssertionError(f"{name}: the cache differs from the plain version's")
    return err


def kernel_checks(K1, K2, K3) -> dict:
    """Each kernel against its plain version on the edge cases the main path
    may give it; returns the max error per kernel (bf16)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        r = lambda *s: torch.randn(*s, generator=g, device=dev).to(dtype)
        # K1: per-row frontiers incl. pos 0, pad bias, in-place append
        B, T, KHD = 4, 512, 128
        bias = torch.where(torch.rand(B, T, generator=g, device=dev) < 0.1, -1e9, 0.0)
        pos = torch.tensor([0, 17, 300, 511], dtype=torch.int32, device=dev)
        e = [check_k1(K1, dtype, r(B, 7, KHD), r(B, 1, KHD), r(B, 1, KHD), r(B, T, KHD),
                      r(B, T, KHD), bias, pos)]
        # K1 at B = 1 on each side of the split kernel's 32-key chunk
        # boundaries, at the main path's cache length (12 splits) and at 4096
        # and 8448 (128 and 264 splits: the merge's long loops), one cache
        # written step after step
        c = K1.CHUNK
        for Tc in (384, 4096, 8448):
            ck, cv = r(1, Tc, KHD), r(1, Tc, KHD)
            bias = torch.where(torch.rand(1, Tc, generator=g, device=dev) < 0.1, -1e9, 0.0)
            for p in (0, 1, c - 1, c, c + 1, Tc - 1):
                e.append(check_k1(K1, dtype, r(1, 7, KHD), r(1, 1, KHD), r(1, 1, KHD), ck, cv,
                                  bias, p, name=f"lm_decode_attention_Tc{Tc}_pos{p}"))
        errs["lm_decode_attention"] = max(e)
        # K2: T = 640, 1152 and 700 (a ragged query tail), lengths around the
        # 64-key tile and a length-0 row (valid rows only), packed and not
        e = []
        for Tq in (640, 1152, 700):
            qkv = r(6, Tq, 3 * 512)
            lens = torch.tensor([0, 1, 63, 64, 65, Tq], dtype=torch.int32, device=dev)
            q3, k3, v3 = (qkv[..., i * 512:(i + 1) * 512].reshape(6, Tq, 8, 64)
                          for i in range(3))
            o_ref = K2.dit_attention_plain(q3, k3, v3, lens, 0.125)
            o = K2.dit_attention_packed(qkv, lens, 0.125, 64).reshape(6, Tq, 8, 64)
            e.append(check_attention(f"dit_attention_T{Tq}", dtype, o, o_ref, lens))
            if o[0].abs().max() != 0:
                raise AssertionError("dit_attention: the length-0 row is not zero")
            o_un = K2.dit_attention(q3.contiguous(), k3.contiguous(), v3.contiguous(), lens,
                                    0.125)
            e.append(check_attention(f"dit_attention_unpacked_T{Tq}", dtype, o_un, o_ref,
                                     lens))
        errs["dit_attention"] = max(e)
        # K3: LayerNorm with and without the fused mish, on both routes: the
        # vector route at the estimator's width (an odd row count leaves a
        # warp's second row absent) and at C = 1024; the element route at
        # C = 64 and 96 and for an x that is not 16-byte aligned
        e = []
        for N, C, off in K3_CASES:
            x = (r(N * C + off) * 3)[off:].view(N, C)
            w, b = r(C), r(C)
            for act in ("none", "mish"):
                name = f"fused_layer_norm_{N}x{C}{'_unaligned' if off else ''}_{act}"
                e.append(check(name, dtype, K3.fused_layer_norm(x, w, b, 1e-5, act),
                               K3.layer_norm_plain(x, w, b, 1e-5, act)))
        errs["fused_layer_norm"] = max(e)
    return errs


def bf16_ulp(v: float) -> float:
    """The spacing of bf16 numbers at magnitude v (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(v)) - 7) if v > 0 else 0.0


def check_block(name, dtype, got, want, phase="kernels") -> float:
    """K4 against its plain version, each given as (y, o): y and the attention
    output o each finite and within CHECK_TOL (fp32) or K4_BF16_ULPS bf16
    ulps at its own max |plain| (bf16).  Returns the error of y."""
    parts, ok = {}, True
    for part, g, w in (("y", got[0], want[0]), ("attention", got[1], want[1])):
        g, w = g.float(), w.float()
        err = float((g - w).abs().max())
        finite = bool(torch.isfinite(g).all())
        if dtype == torch.float32:
            atol, rtol = CHECK_TOL[dtype]
            within, bar = bool(torch.allclose(g, w, atol=atol, rtol=rtol)), dict(atol=atol,
                                                                                 rtol=rtol)
        else:
            limit = K4_BF16_ULPS * bf16_ulp(float(w.abs().max()))
            within, bar = err <= limit, dict(limit=limit, bf16_ulps=K4_BF16_ULPS)
        parts[part] = dict(max_abs_err=err, **bar, finite=finite, ok=within and finite)
        ok = ok and within and finite
    emit({"phase": phase, "check": name, "dtype": str(dtype).split(".")[1], **parts, "ok": ok})
    if not ok:
        raise AssertionError(f"{name} ({dtype}) disagrees with its plain version: {parts}")
    return parts["y"]["max_abs_err"]


def block_checks(K4) -> float:
    """K4 against its plain version at the estimator's full width (dim 256,
    8 x 64 heads, ff 1024) in fp32 and bf16: the batched phase's shape
    [16, 640], T = 1152 (a multiple of 128 that is not a power of two) and
    T = 600 (a ragged last row tile), each with one L = T row, one L = 0 row
    and ragged rows; every row is compared.  Returns the largest bf16
    error."""
    g = torch.Generator(device="cuda").manual_seed(8)
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for B, T in ((16, 640), (4, 1152), (4, 600)):
            lens = [T, 0] + [int(T * (1 - 0.06 * i)) for i in range(1, B - 1)]
            x = torch.randn(B, T, 256, generator=g, device="cuda").to(dtype)
            w = K4.random_block_weights(256, 8, 64, 1024, dtype, g, "cuda")
            L = torch.tensor(lens, dtype=torch.int32, device="cuda")
            kw = dict(sm_scale=0.125, heads=8, head_dim=64, return_attention=True)
            e = check_block(f"dit_block_{B}x{T}", dtype, K4.dit_block_fused(x, L, *w, **kw),
                            K4.dit_block_plain(x, L, *w, **kw))
            if dtype == torch.bfloat16:
                err = max(err, e)
    return err


def step_inputs(K6, dtype, seed: int, L: int = 24, C: int = 384, pos: int = 364) -> dict:
    """One full-width B=1 decode step's inputs for K6: seeded random int8 step
    weights at Qwen2-0.5B widths, x, caches [L, C, 128], RoPE at pos."""
    from cosyvoice_tpu_torch.models.qwen2 import rope_cos_sin

    g = torch.Generator(device="cuda").manual_seed(seed)
    w = K6.random_step_weights(L, 896, 4864, 14, 2, 64, g, "cuda")
    x = torch.randn(1, 896, generator=g, device="cuda").to(dtype)
    kc, vc = (torch.randn(L, C, 128, generator=g, device="cuda").to(dtype) for _ in range(2))
    cos, sin = (t[0, 0] for t in rope_cos_sin(torch.tensor([[pos]], device="cuda"), 64,
                                              1e6, torch.float32))
    return dict(w=w, x=x, kc=kc, vc=vc, pos=pos, cos=cos, sin=sin)


def run_step(K6, inp: dict, plain: bool = False, kc=None, vc=None):
    fn = K6.lm_step_plain if plain else K6.lm_step
    return fn(inp["w"], inp["x"], inp["kc"] if kc is None else kc,
              inp["vc"] if vc is None else vc, inp["pos"], inp["cos"], inp["sin"],
              nq=14, nkv=2, hd=64)


def check_step(K6, inp: dict, dtype, phase="kernels") -> float:
    """K6 against its plain version: the output hidden state and every
    layer's new k/v row; the rest of the cache must stay untouched."""
    kc2, vc2 = inp["kc"].clone(), inp["vc"].clone()
    y = run_step(K6, inp)
    y_ref = run_step(K6, inp, plain=True, kc=kc2, vc=vc2)
    pos, rel = inp["pos"], K6_REL_TOL[dtype]
    errs, ok = {}, True
    for name, got, want in (("y", y, y_ref), ("new_k", inp["kc"][:, pos], kc2[:, pos]),
                            ("new_v", inp["vc"][:, pos], vc2[:, pos])):
        got, want = got.float(), want.float()
        errs[name] = float((got - want).abs().max())
        ok &= errs[name] <= rel * float(want.abs().max())
    rest = [c[:, r] for c in (inp["kc"], kc2, inp["vc"], vc2)
            for r in (slice(0, pos), slice(pos + 1, None))]
    untouched = all(torch.equal(rest[i], rest[i + 2]) for i in (0, 1, 4, 5))
    emit({"phase": phase, "check": "lm_step", "dtype": str(dtype).split(".")[1],
          "max_abs_err": errs, "max_abs_plain": float(y_ref.float().abs().max()),
          "rel_tol": rel, "cache_rest_untouched": untouched, "ok": ok and untouched})
    if not (ok and untouched):
        raise AssertionError(f"lm_step ({dtype}) disagrees with its plain version: {errs}")
    return max(errs.values())


def step_plan(K6, C: int, dev) -> dict:
    """K6's launch plan for a full-width step with a C-row cache on this card."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return K6.plan(896, 4864, 14, 2, C, sms)


def quant_kernel_checks(K5, K6) -> dict:
    """K5's launch plan at one row (at least K5_MIN_BLOCKS blocks), then K5
    at the LM's projection shapes (K5_ROWS rows, group 128) and K6 for one
    full-width step at pos 364, each against its plain version in fp32 and
    bf16; returns the max error per kernel (bf16)."""
    g = torch.Generator(device="cuda").manual_seed(5)
    errs = {"int4_matmul": 0.0, "lm_step": 0.0}
    for (IN, OUT), need in K5_MIN_BLOCKS.items():
        p = K5.plan(1, IN, OUT, 128)
        ok = p["route"] == "split" and p["blocks"] >= need
        emit({"phase": "kernels", "check": f"int4_matmul_plan_1x{IN}x{OUT}", **p,
              "min_blocks": need, "ok": ok})
        if not ok:
            raise AssertionError(f"int4_matmul at 1x{IN}x{OUT} launches {p}")
    for dtype in (torch.float32, torch.bfloat16):
        for IN, OUT in K5_SHAPES:
            w = K5.pack_int4(torch.randint(-7, 8, (IN, OUT), generator=g, device="cuda"))
            scale = torch.rand(IN // 128, OUT, generator=g, device="cuda") * 0.02 + 1e-3
            for rows in K5_ROWS:
                x = torch.randn(rows, IN, generator=g, device="cuda").to(dtype)
                e = check(f"int4_matmul_{rows}x{IN}x{OUT}", dtype, K5.int4_matmul(x, w, scale),
                          K5.int4_matmul_plain(x, w, scale))
                errs["int4_matmul"] = max(errs["int4_matmul"], e)
        errs["lm_step"] = check_step(K6, step_inputs(K6, dtype, 6), dtype)
    # K6's plan: at most one item a block in every phase, on a grid of one
    # block an SM; two launches on the same inputs give the same bits (fixed
    # merge order)
    p = step_plan(K6, 384, "cuda")
    items = {k: p[k]["items"] for k in ("qkv", "o", "gate_up", "down", "attention")}
    inp = step_inputs(K6, torch.bfloat16, 6)
    caches = [(inp["kc"].clone(), inp["vc"].clone()) for _ in range(2)]
    y1, y2 = (run_step(K6, inp, kc=kc, vc=vc) for kc, vc in caches)
    same = bool(torch.equal(y1, y2)) and all(torch.equal(a, b) for a, b in zip(*caches))
    grid = K6.sync_probe(1, "cuda")                  # the grid lm_step launches
    ok = max(items.values()) <= p["blocks"] == grid and same
    emit({"phase": "kernels", "check": "lm_step_plan", "blocks": p["blocks"], "grid": grid,
          "items": items, "region_bytes": p["region_bytes"], "smem_bytes": p["smem_bytes"],
          "two_launches_bit_identical": same, "ok": ok})
    if not ok:
        raise AssertionError(f"lm_step plan {items} on {p['blocks']} blocks (grid {grid}), "
                             f"bit-identical: {same}")
    return errs


def snake_inputs(shape, beta: bool, logscale: bool, g):
    """x [B, T, C] ~ N(0, 1) and per-channel alpha, beta: 0.3 N under
    logscale, 1 + 0.3 N otherwise (near each init); beta None if absent."""
    C = shape[-1]
    x = torch.randn(*shape, generator=g, device="cuda")
    a, b = (torch.randn(C, generator=g, device="cuda") * 0.3 + (0.0 if logscale else 1.0)
            for _ in range(2))
    return x, a, (b if beta else None), logscale


def channels_first(x: torch.Tensor) -> torch.Tensor:
    """x [B, T, C] with the same values in channels-first memory, as
    BigVGAN's convolutions leave it (x.transpose(1, 2) contiguous)."""
    return x.transpose(1, 2).contiguous().transpose(1, 2)


def snake_checks(K7) -> float:
    """K7 against its plain version, fp32, every sample (edges included),
    on the full-width stage shapes and the edge cases of K7_CASES, each with
    x channels-last and channels-first (y must come back with x's strides);
    then the kernel's copy of sinf's fast path against sinf itself, bit for
    bit, over every float below 105615."""
    g = torch.Generator(device="cuda").manual_seed(10)
    err = 0.0
    for shape, beta, logscale in K7_CASES:
        x, a, b, ls = snake_inputs(shape, beta, logscale, g)
        want = K7.snake_aa_plain(x, a, b, ls)
        for layout, xx in ((K7.CHANNELS_LAST, x), (K7.CHANNELS_FIRST, channels_first(x))):
            name = ("snake_aa_" + "x".join(map(str, shape)) + ("" if beta else "_nobeta")
                    + ("" if logscale else "_linear") + "_" + layout)
            y = K7.snake_aa(xx, a, b, ls)
            if y.stride() != xx.stride():
                raise AssertionError(f"{name}: y strides {y.stride()}, x {xx.stride()}")
            err = max(err, check(name, torch.float32, y, want))
    mismatches = K7.sin2_mismatches("cuda")
    emit({"phase": "kernels", "check": "snake_aa_sin2_equals_sinf", "mismatches": mismatches,
          "ok": mismatches == 0})
    if mismatches:
        raise AssertionError(f"snake_aa: sin2 differs from sinf on {mismatches} floats")
    return err


def small_stack(device: str):
    """A small fp32 stack whose widths the kernels take (head_dim 64, C % 32 == 0)."""
    from cosyvoice_tpu_torch.models.conformer import ConformerConfig
    from cosyvoice_tpu_torch.models.flow import (CausalMaskedDiffWithXvec, EstimatorConfig,
                                                 FlowConfig)
    from cosyvoice_tpu_torch.models.hift import HiFTConfig, HiFTGenerator
    from cosyvoice_tpu_torch.models.llm import LMConfig, Qwen2LM, SamplingConfig
    from cosyvoice_tpu_torch.models.qwen2 import Qwen2Config
    from cosyvoice_tpu_torch.runtime.model import CosyVoice2Model

    torch.manual_seed(0)
    llm = Qwen2LM(LMConfig(128, 128, 64, sampling=SamplingConfig(method="greedy"),
                           qwen=Qwen2Config(vocab_size=300, hidden_size=128, num_layers=2,
                                            num_heads=4, num_kv_heads=2, head_dim=64,
                                            intermediate_size=256, rope_theta=10000.0,
                                            fused_cache_update=True)))
    flow = CausalMaskedDiffWithXvec(FlowConfig(
        64, 80, 24, 67, encoder=ConformerConfig(64, 4, 128, 1, 64, static_chunk_size=50),
        estimator=EstimatorConfig(in_channels=320, channels=64, n_blocks=1,
                                  num_mid_blocks=1, num_heads=2, attention_head_dim=64,
                                  fused_attention=True, fused_norm=True, approx_gelu=True)))
    hift = HiFTGenerator(HiFTConfig(base_channels=64, nb_harmonics=2, f0_cond_channels=32,
                                    resblock_kernel_sizes=(3,),
                                    resblock_dilation_sizes=((1, 3),)), deterministic=True)
    return CosyVoice2Model(llm=llm, flow=flow, hift=hift, max_decode_tokens=60, device=device)


def reference_check() -> dict:
    """The same small stack and inputs on the GPU (kernels) and on the CPU
    (plain versions): greedy tokens exact, waveform within 1e-2."""
    rng = np.random.default_rng(3)
    inputs = dict(text_tokens=rng.integers(0, 256, 20), prompt_text_len=5,
                  llm_prompt_speech_token=rng.integers(0, 64, 25),
                  flow_prompt_speech_token=rng.integers(0, 64, 25),
                  prompt_speech_feat=rng.standard_normal((50, 80)).astype(np.float32),
                  flow_embedding=rng.standard_normal(24).astype(np.float32))
    out = {}
    for device in ("cuda", "cpu"):
        model = small_stack(device)
        tokens = model.llm_generate(inputs["text_tokens"], 5,
                                    inputs["llm_prompt_speech_token"], None)
        wav = next(model.tts(**inputs, gen=torch.Generator().manual_seed(0)))["tts_speech"]
        out[device] = (tokens, wav)
    (tok_g, wav_g), (tok_c, wav_c) = out["cuda"], out["cpu"]
    err = float(np.abs(wav_g - wav_c).max()) if wav_g.shape == wav_c.shape else float("inf")
    res = {"phase": "reference", "tokens": len(tok_g), "tokens_equal": bool(
        np.array_equal(tok_g, tok_c)), "wav_samples": len(wav_g), "wav_max_abs_err": err,
        "tol": 1e-2}
    emit(res)
    if not res["tokens_equal"] or not err <= 1e-2 or not np.isfinite(wav_g).all():
        raise AssertionError(f"GPU stack disagrees with the CPU stack: {res}")
    return res


def full_width_stack():
    """The full-width serving stack (LMConfig/FlowConfig/HiFTConfig defaults)
    on seeded random weights."""
    import dataclasses

    from cosyvoice_tpu_torch.models.flow import CausalMaskedDiffWithXvec, FlowConfig
    from cosyvoice_tpu_torch.models.hift import HiFTConfig, HiFTGenerator
    from cosyvoice_tpu_torch.models.llm import LMConfig, Qwen2LM
    from cosyvoice_tpu_torch.utils.quant import quantize_qwen_int8

    lm_cfg, fcfg = LMConfig(), FlowConfig()
    with torch.device("cuda"):      # build the modules on the card directly
        fp = Qwen2LM(lm_cfg)
        rand_init_(fp, 12345)
        state = quantize_qwen_int8(fp.to(torch.bfloat16).state_dict())
        del fp
        llm = Qwen2LM(dataclasses.replace(lm_cfg, qwen=dataclasses.replace(
            lm_cfg.qwen, quant="int8", fused_cache_update=True))).to(torch.bfloat16)
        llm.load_state_dict(state, strict=True)
        del state
        flow = CausalMaskedDiffWithXvec(dataclasses.replace(
            fcfg, encoder_dtype="bfloat16", estimator=dataclasses.replace(
                fcfg.estimator, dtype="bfloat16", fused_attention=True, fused_norm=True,
                approx_gelu=True)))
        rand_init_(flow, 12346)
        flow.encoder.to(torch.bfloat16)
        flow.decoder.estimator.to(torch.bfloat16)
        hift = HiFTGenerator(dataclasses.replace(HiFTConfig(), dtype="bfloat16",
                                                 approx_sin=True))
        rand_init_(hift, 12347)
        hift.to(torch.bfloat16)
    return llm, flow, hift


def main_path(K1, K2, K3, smi: str, profile: bool) -> dict:
    from cosyvoice_tpu_torch.runtime.api import CosyVoice2
    from cosyvoice_tpu_torch.runtime.frontend import CosyVoiceFrontEnd
    from cosyvoice_tpu_torch.runtime.model import CosyVoice2Model
    from cosyvoice_tpu_torch.tokenizer.text import ByteTokenizer

    t0 = time.perf_counter()
    llm, flow, hift = full_width_stack()
    model = CosyVoice2Model(llm=llm, flow=flow, hift=hift, max_decode_tokens=200,
                            device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def seeded(wav):
        return np.random.default_rng(int(np.abs(wav).sum() * 1e3) % (1 << 32))

    frontend = CosyVoiceFrontEnd(
        tokenizer=ByteTokenizer(),
        speech_tokenizer=lambda wav: seeded(wav).integers(0, 6561, len(wav) * 25 // 16000),
        spk_embedder=lambda wav: seeded(wav).standard_normal(192).astype(np.float32))
    cv = CosyVoice2(frontend=frontend, model=model)
    decodes, prompts, stage = [], [], {"lm_s": 0.0, "flow_s": 0.0, "hift_s": 0.0}

    def recording_generate(text_tokens, prompt_text_len, prompt_speech, gen):
        tokens = generate(text_tokens, prompt_text_len, prompt_speech, gen)
        decodes.append((len(text_tokens), len(prompt_speech), len(tokens)))
        prompts.append((np.asarray(text_tokens), np.asarray(prompt_speech)))
        return tokens

    generate = timed(stage, "lm_s", model.llm_generate)
    model.llm_generate = recording_generate
    model._flow_chunk = timed(stage, "flow_s", model._flow_chunk)
    model._vocode = timed(stage, "hift_s", model._vocode)
    t = np.arange(48000) / 16000.0
    prompt = (0.3 * np.sin(2 * np.pi * 220 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
              + 0.01 * np.random.default_rng(0).standard_normal(len(t))).astype(np.float32)
    texts = ["Hello there.", "The quick brown fox jumps over the lazy dog.",
             "The port runs the whole zero-shot path on the card, one kernel at a time."]

    def request(i, text):
        for key in stage:
            stage[key] = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wavs = [o["tts_speech"] for o in cv.inference_zero_shot(
            text, "A short prompt.", prompt, gen=torch.Generator().manual_seed(i))]
        torch.cuda.synchronize()
        latency = time.perf_counter() - t0
        n_tok = decodes[-1][2]
        wav = np.concatenate(wavs)
        if len(wavs) != 1 or wav.shape != (n_tok * 2 * 480,) or not np.isfinite(wav).all() \
                or n_tok == 0:
            raise AssertionError(f"request {i}: wav {wav.shape} for {n_tok} tokens")
        return {"text_bytes": len(text.encode()), "speech_tokens": n_tok,
                "wav_samples": len(wav), "latency_s": latency,
                "rtf": latency / (len(wav) / 24000.0), **stage,
                "lm_ms_per_token": stage["lm_s"] * 1e3 / n_tok}

    for mod in (K1, K2, K3):
        mod.launches = 0
    torch.cuda.reset_peak_memory_stats()
    requests = [request(i, text) for i, text in enumerate(texts)]
    launches = {"lm_decode_attention": K1.launches, "dit_attention": K2.launches,
                "fused_layer_norm": K3.launches}
    res = {"phase": "main_path", "card": smi, "setup_s": setup_s, "requests": requests,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30, "launches": launches}
    emit(res)
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if profile:
        profile_request(lambda: request(len(texts), texts[-1]))
    res.update(last_decode=decodes[-1], first_prompt=prompts[0], first_text=texts[0],
               prompt_wav=prompt, stack=(llm, flow, hift, frontend))
    return res


def teacher_forced_argmax(lm, step_w, text, psp, forced, cache_len: int, fused: bool):
    """Feed `forced` token by token after the prefill, through the K1 decode
    path (forward_hidden at T=1) or one K6 launch a step; -> the argmax of
    the logits after each fed token."""
    from cosyvoice_tpu_torch.models.qwen2 import (KVCache, causal_prefill_bias, rms_norm,
                                                  rope_cos_sin)
    from cosyvoice_tpu_torch.ops.kernels.lm_step import cache_to_step_layout, lm_step
    from cosyvoice_tpu_torch.ops.masks import NEG_INF

    q, dev = lm.cfg.qwen, text.device
    emb, seq_len = lm.prefill_embeds(text, torch.tensor([text.shape[1]], device=dev), psp,
                                     torch.tensor([psp.shape[1]], device=dev))
    Tp = emb.shape[1]
    cache = KVCache.create(q, 1, cache_len, emb.dtype, dev)
    _, cache = lm.forward_hidden(emb, torch.arange(Tp, device=dev)[None],
                                 causal_prefill_bias(Tp, cache_len, seq_len, 1, emb.dtype, dev),
                                 cache)
    kc, vc = cache_to_step_layout(cache.k, cache.v, cache_len)
    slot = torch.arange(cache_len, device=dev)
    out = []
    for t, tok in enumerate(forced.tolist()):
        pos = Tp + t
        e = lm.speech_emb(torch.tensor([[tok]], device=dev))
        if fused:
            cos, sin = rope_cos_sin(torch.tensor([[pos]], device=dev), q.head_dim,
                                    q.rope_theta, torch.float32)
            y = lm_step(step_w, e[0], kc, vc, pos, cos[0, 0], sin[0, 0], nq=q.num_heads,
                        nkv=q.num_kv_heads, hd=q.head_dim, eps=q.rms_norm_eps)
            h = rms_norm(y, lm.body.norm.weight, q.rms_norm_eps)[None]
        else:
            bias = torch.where(slot <= pos, 0.0, NEG_INF).to(emb.dtype)[None, None, None]
            h, cache = lm.forward_hidden(e, torch.tensor([[pos]], device=dev), bias, cache)
        out.append(lm.decode_logits(h)[0, 0].argmax())
    return torch.stack(out)


@torch.no_grad()
def fused_step_phase(llm, prompt, K1, K6, smi: str, n: int = 200) -> dict:
    """The main path's int8 LM (its weights, shared) with greedy sampling,
    from the first request's prompt, n steps (EOS masked throughout):
    lm_generate (K1 in every layer) against lm_generate_fused_step (K6)."""
    from cosyvoice_tpu_torch.models.llm import (Qwen2LM, SamplingConfig, lm_generate,
                                                lm_generate_fused_step, lm_step_supported)
    from cosyvoice_tpu_torch.ops.kernels.lm_step import pack_step_weights
    from cosyvoice_tpu_torch.runtime.model import round_up

    cfg = dataclasses.replace(llm.cfg, sampling=SamplingConfig(method="greedy"))
    if not lm_step_supported(cfg.qwen):
        raise AssertionError(f"the main path's LM is not one lm_step takes: {cfg.qwen}")
    with torch.device("cuda"):
        lm = Qwen2LM(cfg)
    lm.load_state_dict(llm.state_dict(), strict=True, assign=True)
    lm.eval()
    step_w = pack_step_weights(lm.body.state_dict(), cfg.qwen.num_layers)
    text_tokens, prompt_speech = prompt
    text = torch.as_tensor(text_tokens, dtype=torch.long, device="cuda")[None]
    psp = torch.as_tensor(prompt_speech, dtype=torch.long, device="cuda")[None]
    cache_len = round_up(2 + text.shape[1] + psp.shape[1] + n, 128)
    lens = [torch.tensor([v], device="cuda") for v in (text.shape[1], psp.shape[1], n, n)]
    args = (text, lens[0], psp, lens[1], lens[2], lens[3], None)
    decode_logits, heads = lm.decode_logits, [0]

    def counting_head(h):       # one call per sampled token: decode steps + 1
        heads[0] += 1
        return decode_logits(h)

    lm.decode_logits = counting_head
    runs = {}
    for name, fn in (("k1_path", lambda: lm_generate(lm, *args, max_steps=n,
                                                     cache_len=cache_len)),
                     ("fused_step", lambda: lm_generate_fused_step(
                         lm, step_w, *args, max_steps=n, cache_len=cache_len))):
        K1.launches = K6.launches = heads[0] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, cnt = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        count = int(cnt[0])
        runs[name] = dict(tokens=count, decode_steps=heads[0] - 1, s=wall,
                          ms_per_token=wall * 1e3 / max(count, 1),
                          k1_launches=K1.launches, k6_launches=K6.launches,
                          out=out[0, :count].cpu())
    lm.decode_logits = decode_logits
    a, b = runs["k1_path"]["out"], runs["fused_step"]["out"]
    m = min(len(a), len(b))
    differ = torch.nonzero(a[:m] != b[:m]).flatten()
    match = int(differ[0]) if len(differ) else m
    tf = [teacher_forced_argmax(lm, step_w, text, psp, a[:-1], cache_len, fused)
          for fused in (False, True)]
    agree = float((tf[0] == tf[1]).float().mean())
    for r in runs.values():
        del r["out"]
    res = {"phase": "fused_step", "card": smi, "steps": n, "runs": runs,
           "free_running_match_tokens": match, "teacher_forced_steps": len(tf[0]),
           "teacher_forced_agreement": agree, "agreement_gate": 0.9,
           "k6_launches": runs["fused_step"]["k6_launches"]}
    emit(res)
    fs = runs["fused_step"]
    if fs["k6_launches"] != fs["decode_steps"] or fs["decode_steps"] < 1:
        raise AssertionError(f"K6 launched {fs['k6_launches']} times for "
                             f"{fs['decode_steps']} decode steps")
    del step_w, lm
    return res


@torch.no_grad()
def int4_phase(res_main: dict, K5, smi: str) -> dict:
    """One full-width zero-shot request (the main path's first) with the LM
    quantized to packed int4 at group 128 from the same seeded bf16 weights;
    then the teacher-forced argmax agreement of the int4 LM with the bf16 LM
    over the request's generated tokens."""
    from cosyvoice_tpu_torch.models.llm import LMConfig, Qwen2LM
    from cosyvoice_tpu_torch.models.qwen2 import causal_prefill_bias
    from cosyvoice_tpu_torch.runtime.api import CosyVoice2
    from cosyvoice_tpu_torch.runtime.model import CosyVoice2Model
    from cosyvoice_tpu_torch.utils.quant import quantize_qwen_int4

    _, flow, hift, frontend = res_main["stack"]
    lm_cfg = LMConfig()
    with torch.device("cuda"):
        fp = Qwen2LM(lm_cfg)
        rand_init_(fp, 12345)           # the seed full_width_stack() draws the LM from
        fp = fp.to(torch.bfloat16).eval()
        llm4 = Qwen2LM(dataclasses.replace(lm_cfg, qwen=dataclasses.replace(
            lm_cfg.qwen, quant="int4", quant_group=128, fused_cache_update=True)))
    llm4.load_state_dict(quantize_qwen_int4(fp.state_dict(), group_size=128), strict=True,
                         assign=True)
    model = CosyVoice2Model(llm=llm4, flow=flow, hift=hift, max_decode_tokens=200,
                            device="cuda")
    cv = CosyVoice2(frontend=frontend, model=model)
    generate, got, lm_s = model.llm_generate, [], [0.0]

    def timed_generate(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens = generate(*a)
        torch.cuda.synchronize()
        lm_s[0] += time.perf_counter() - t0
        got.append(tokens)
        return tokens

    model.llm_generate = timed_generate
    K5.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wavs = [o["tts_speech"] for o in cv.inference_zero_shot(
        res_main["first_text"], "A short prompt.", res_main["prompt_wav"],
        gen=torch.Generator().manual_seed(0))]
    torch.cuda.synchronize()
    latency = time.perf_counter() - t0
    k5_launches = K5.launches
    wav = np.concatenate(wavs)
    n_tok = len(got[-1])

    text_tokens, prompt_speech = res_main["first_prompt"]
    seq = np.concatenate([prompt_speech, got[-1]])
    text = torch.as_tensor(text_tokens, dtype=torch.long, device="cuda")[None]
    sp = torch.as_tensor(seq, dtype=torch.long, device="cuda")[None]

    def tf_argmax(m):
        emb, seq_len = m.prefill_embeds(text, torch.tensor([text.shape[1]], device="cuda"), sp,
                                        torch.tensor([sp.shape[1]], device="cuda"))
        T = emb.shape[1]
        h, _ = m.forward_hidden(emb, torch.arange(T, device="cuda")[None],
                                causal_prefill_bias(T, T, seq_len, 1, emb.dtype, "cuda"))
        # the predictions of the n_tok generated tokens
        return m.decode_logits(h)[0, T - n_tok - 1:T - 1].argmax(-1)

    agree = float((tf_argmax(llm4) == tf_argmax(fp)).float().mean()) if n_tok else 0.0
    res = {"phase": "int4", "card": smi, "speech_tokens": n_tok, "wav_samples": len(wav),
           "latency_s": latency, "rtf": latency / max(len(wav) / 24000.0, 1e-9),
           "lm_s": lm_s[0], "lm_ms_per_token": lm_s[0] * 1e3 / max(n_tok, 1),
           "k5_launches": k5_launches, "wav_finite": bool(np.isfinite(wav).all()),
           "teacher_forced_agreement_vs_bf16": agree}
    emit(res)
    if not k5_launches or not res["wav_finite"] or n_tok == 0 \
            or wav.shape != (n_tok * 2 * 480,):
        raise AssertionError(f"int4 request failed: {res}")
    return res


def dit_blocks(flow) -> list:
    from cosyvoice_tpu_torch.models.flow import DiTBlock

    return [m for m in flow.modules() if isinstance(m, DiTBlock)]


def set_fused_block(flow, on: bool) -> None:
    """Route every DiT block of `flow` through K4 (on) or through K2, K3 and
    cuBLAS (off), the same weights either way."""
    for blk in dit_blocks(flow):
        blk.fused_block = on


@torch.no_grad()
def batched_phase(res_main: dict, K1, K4, smi: str) -> dict:
    """BatchedSynthesizer over 8 zero-shot requests at full width with the
    main path's weights and prompt, every DiT block through K4: a warm-up
    batch, then a timed one; then the same flow inputs through the unfused
    blocks, for the mel difference K4 makes."""
    from cosyvoice_tpu_torch.runtime.model import CosyVoice2Model
    from cosyvoice_tpu_torch.runtime.serving import BatchedSynthesizer, TTSRequest

    llm, flow, hift, frontend = res_main["stack"]
    synth = BatchedSynthesizer(CosyVoice2Model(llm=llm, flow=flow, hift=hift,
                                               max_decode_tokens=200, device="cuda"))
    reqs = []
    for text in BATCH_TEXTS:
        mi = frontend.frontend_zero_shot(text, "A short prompt.", res_main["prompt_wav"])
        reqs.append(TTSRequest(
            text_tokens=np.concatenate([mi["prompt_text"], mi["text"]]),
            prompt_text_len=len(mi["prompt_text"]),
            prompt_speech_tokens=mi["llm_prompt_speech_token"],
            prompt_feat=mi["prompt_speech_feat"], embedding=mi["flow_embedding"]))
    stage, seen = {"lm_s": 0.0, "flow_s": 0.0, "hift_s": 0.0}, {}

    def timed_seen(key, fn):
        def run(*args):
            seen[key] = (args, fn(*args))
            return seen[key][1]
        return timed(stage, key, run)

    flow_batch = synth.flow_batch
    synth.generate = timed_seen("lm_s", synth.generate)
    synth.flow_batch = timed_seen("flow_s", flow_batch)
    synth.vocode_batch = timed_seen("hift_s", synth.vocode_batch)
    set_fused_block(flow, True)
    synth.synthesize_batch(reqs, gen=torch.Generator().manual_seed(0))      # warm-up
    for key in stage:
        stage[key] = 0.0
    K1.launches = K4.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wavs = synth.synthesize_batch(reqs, gen=torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k4, k1 = K4.launches, K1.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    tokens = seen["lm_s"][1]
    mel_on, tls, pfl = seen["flow_s"][1]
    set_fused_block(flow, False)
    mel_off = flow_batch(reqs, tokens)[0]
    diff = max(float((mel_on[i, p:2 * n] - mel_off[i, p:2 * n]).abs().max())
               for i, (n, p) in enumerate(zip(tls, pfl)))
    n_blocks = len(dit_blocks(flow))
    audio_s = sum(len(w) for w in wavs) / 24000.0
    # the flow's CFG batch: 2B rows, mel frames padded to 128, per-row lengths
    T_pad = -(-mel_on.shape[1] // 128) * 128
    lens = [2 * n for n in tls] * 2
    res = {"phase": "batched", "card": smi, "requests": len(reqs),
           "speech_tokens": [len(t) for t in tokens], "wall_s": wall, **stage,
           "audio_s": audio_s, "rtf": wall / max(audio_s, 1e-9), "peak_mem_gb": peak,
           "k4_launches": k4, "k4_launches_expected": n_blocks * 10, "k1_launches": k1,
           "flow_cfg_rows": 2 * len(reqs), "flow_frames_padded": T_pad,
           "mel_max_abs_diff_fused_block_on_vs_off": diff,
           "mel_max_abs": float(mel_off.abs().max())}
    emit(res)
    ok = all(np.isfinite(w).all() and w.shape == (len(t) * 2 * 480,)
             for w, t in zip(wavs, tokens))
    if k4 != n_blocks * 10 or not ok or not np.isfinite(diff) or not k1:
        raise AssertionError(f"batched phase failed: {res}")
    res["block_shape"] = (2 * len(reqs), T_pad, lens)
    return res


@torch.no_grad()
def engine_phase(res_main: dict, K1, smi: str) -> dict:
    """ServingEngine.generate, 16 requests of mixed lengths through 8 slots, on
    the small fp32 stack (greedy tokens must equal a B=1 lm_generate of each
    request) and on the main path's int8 LM with greedy sampling."""
    from cosyvoice_tpu_torch.models.llm import Qwen2LM, SamplingConfig, lm_generate
    from cosyvoice_tpu_torch.runtime.engine import GenRequest, ServingEngine

    rng = np.random.default_rng(11)

    def run(lm, reqs, **kw) -> dict:
        segments = [0]
        K1.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = ServingEngine(lm, device="cuda", **kw).generate(
            reqs, on_segment=lambda: segments.__setitem__(0, segments[0] + 1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1 = K1.launches
        t = lambda *a: torch.as_tensor(np.asarray(a), dtype=torch.long, device="cuda")
        equal, first_diff = 0, []
        for r, toks in zip(reqs, got):
            n, mo = len(r.text), kw["max_out"]
            mn = r.min_len if r.min_len is not None else int(2 * n)
            mx = min(r.max_len if r.max_len is not None else 20 * n, mo)
            out, cnt = lm_generate(lm, t(r.text), t(n), t(r.prompt_speech),
                                   t(len(r.prompt_speech)), t(mn), t(mx), None, max_steps=mo,
                                   cache_len=kw["cache_len"])
            ref = out[0, :int(cnt[0])].cpu().numpy()
            equal += int(np.array_equal(toks, ref))
            # tokens before the first difference (the whole length if none)
            diff = np.nonzero(toks[:len(ref)] != ref[:len(toks)])[0]
            first_diff.append(int(diff[0]) if len(diff) else min(len(toks), len(ref)))
        n_tok = sum(len(g) for g in got)
        return dict(requests=len(reqs), slots=kw["num_slots"], tokens=n_tok, wall_s=wall,
                    tokens_per_s=n_tok / wall, segments=segments[0], k1_launches=k1,
                    equal_to_lm_generate=equal, share_equal=equal / len(reqs),
                    tokens_before_first_difference=first_diff,
                    request_tokens=[len(g) for g in got])

    small = small_stack("cuda").llm
    small_reqs = [GenRequest(text=rng.integers(0, 256, 2 + i % 11),
                             prompt_speech=rng.integers(0, 64, (i * 7) % 26))
                  for i in range(16)]
    small_run = run(small, small_reqs, num_slots=8, cache_len=256, max_out=96,
                    segment_steps=16, text_bucket=8, speech_bucket=8)
    llm = res_main["stack"][0]
    cfg = dataclasses.replace(llm.cfg, sampling=SamplingConfig(method="greedy"))
    with torch.device("cuda"):
        lm = Qwen2LM(cfg)
    lm.load_state_dict(llm.state_dict(), strict=True, assign=True)
    # decode caps of 100-200 tokens, as in the batched phase; the longest
    # request needs 3 + 32 text + 128 speech + 200 cache rows <= 384
    full_reqs = [GenRequest(text=rng.integers(0, 256, 6 + (i * 5) % 25),
                            prompt_speech=rng.integers(0, 6561, 20 + (i * 11) % 56),
                            max_len=100 + (i * 13) % 101)
                 for i in range(16)]
    full_run = run(lm, full_reqs, num_slots=8, cache_len=384, max_out=200, segment_steps=50,
                   text_bucket=32, speech_bucket=64)
    res = {"phase": "engine", "card": smi, "small_fp32": small_run, "full_width_int8": full_run,
           "gate": "small_fp32 share_equal == 1 (exact greedy parity); full width: printed"}
    emit(res)
    if small_run["share_equal"] != 1.0 or not full_run["tokens"] or not full_run["k1_launches"]:
        raise AssertionError(f"engine phase failed: {res}")
    return res


@torch.no_grad()
def bigvgan_phase(K7, smi: str) -> dict:
    """BigVGAN at the recipe's full width on seeded random weights, every
    AAAct through K7: a warm-up forward and a timed one over 4 rows of
    250/200/150/100 tokens, the timed one counting K7's launches by stage
    shape and the memory layout each AAAct hands K7 (forward hooks); then
    the device time of K7 and of the copy kernels (torch.profiler), and the
    same input through the composite activations (warm-up, timed): the wall
    time and the wav difference."""
    from cosyvoice_tpu_torch.models.bigvgan import RECIPE, AAAct, BigVGAN

    cfg = dataclasses.replace(RECIPE, use_pallas_act=True)
    with torch.device("cuda"):
        model = BigVGAN(cfg)
    rand_init_(model, 12348)
    model.eval()
    lens = [250, 200, 150, 100]
    T = max(lens)
    g = torch.Generator(device="cuda").manual_seed(13)
    tlen = torch.tensor(lens, device="cuda")
    valid = torch.arange(T, device="cuda")[None] < tlen[:, None]
    token = torch.where(valid, torch.randint(0, cfg.vocab_size, (4, T), generator=g,
                                             device="cuda"), -1)
    spk = torch.randn(4, cfg.speaker_embedding_dim, generator=g, device="cuda")
    upsample = math.prod(cfg.upsample_rates) * 2 ** 2      # 2x per conformer encoder
    acts = [m for m in model.modules() if isinstance(m, AAAct)]

    def forward():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wav, mel = model(token, tlen, spk)
        torch.cuda.synchronize()
        return wav, mel, time.perf_counter() - t0

    # K7 launches by stage shape (T, C) and the layouts AAAct hands K7
    by_stage, layouts, before = {}, [], []

    def pre(module, args):
        layouts.append(K7.memory_layout(args[0]))
        before.append(K7.launches)

    def post(module, args, out):
        key = "x".join(map(str, args[0].shape[1:]))
        by_stage[key] = by_stage.get(key, 0) + K7.launches - before.pop()

    forward()                                               # warm-up
    hooks = [h for m in acts for h in (m.register_forward_pre_hook(pre),
                                       m.register_forward_hook(post))]
    K7.launches = 0
    torch.cuda.reset_peak_memory_stats()
    wav, mel, wall = forward()
    k7 = K7.launches
    for h in hooks:
        h.remove()
    peak = torch.cuda.max_memory_allocated() / 2**30
    kernels = kernel_times(lambda: model(token, tlen, spk), n=1)
    device_ms = sum(ms for ms, _ in kernels.values())
    k7_ms = sum(ms for name, (ms, _) in kernels.items()
                if kernel_key(name).startswith("snake_aa"))
    copies = {name: v for name, v in kernels.items() if "copy" in name.lower()}
    for m in acts:
        m.use_kernel = False
    forward()
    wav_off, _, wall_off = forward()
    for m in acts:
        m.use_kernel = True
    expected = len(cfg.upsample_rates) * sum(2 * len(d) for d in cfg.resblock_dilation_sizes) + 1
    audio_s = sum(lens) * upsample / 24000.0
    finite = bool(torch.isfinite(wav).all())
    res = {"phase": "bigvgan", "card": smi, "config": "cosyvoice2_bigvgan_tts.yaml",
           "rows_tokens": lens, "wav_shape": list(wav.shape), "mel_shape": list(mel.shape),
           "wall_s": wall, "audio_s": audio_s, "rtf": wall / audio_s, "peak_mem_gb": peak,
           "k7_launches": k7, "k7_launches_expected": expected,
           "k7_launches_by_stage": by_stage,
           "k7_input_layouts": {lay: layouts.count(lay) for lay in sorted(set(layouts))},
           "k7_device_ms": k7_ms, "device_ms": device_ms, "k7_device_share": k7_ms / device_ms,
           # every copy kernel of the forward (the convolutions' F.pad among
           # them): device ms and launches a forward, by kernel name
           "copy_device_ms": sum(ms for ms, _ in copies.values()),
           "copy_launches": sum(n for _, n in copies.values()),
           "copy_kernels": {name[:160]: v for name, v in copies.items()},
           "wav_finite": finite, "wav_max_abs": float(wav.abs().max()),
           "composite_wall_s": wall_off,
           "wav_max_abs_diff_kernel_vs_composite": float((wav - wav_off).abs().max())}
    emit(res)
    if (k7 != expected or len(acts) != expected or not finite or res["wav_max_abs"] > 1.0
            or tuple(wav.shape) != (4, T * upsample) or (k7 and not k7_ms)
            or sum(by_stage.values()) != k7):
        raise AssertionError(f"bigvgan phase failed: {res}")
    return res


@torch.no_grad()
def stream_phase(res_main: dict, K1, K2, K3, smi: str) -> dict:
    """One full-width zero-shot request streamed through
    inference_zero_shot(stream=True): the main path's weights with greedy
    sampling, a 200-token cap, after one warm-up stream of the same request.
    Each chunk's seconds split into frontend, LM prefill, flow and HiFT
    (synchronised host timers) and the rest: decode steps and host work."""
    from cosyvoice_tpu_torch.models.llm import Qwen2LM, SamplingConfig
    from cosyvoice_tpu_torch.runtime.api import CosyVoice2
    from cosyvoice_tpu_torch.runtime.model import CosyVoice2Model

    llm, flow, hift, frontend = res_main["stack"]
    cfg = dataclasses.replace(llm.cfg, sampling=SamplingConfig(method="greedy"))
    with torch.device("cuda"):
        lm = Qwen2LM(cfg)
    lm.load_state_dict(llm.state_dict(), strict=True, assign=True)
    model = CosyVoice2Model(llm=lm.eval(), flow=flow, hift=hift, max_decode_tokens=200,
                            device="cuda")
    cv = CosyVoice2(frontend=frontend, model=model)
    prefills, streamed = [], []
    prefill, token2wav = model._prefill, model.token2wav

    def recording_prefill(*args):
        prefills.append(args[:3])
        return prefill(*args)

    def recording_token2wav(tokens, *args, **kwargs):
        streamed.append(tokens[:kwargs.get("n_tokens")].cpu().numpy())
        return token2wav(tokens, *args, **kwargs)

    stage = dict.fromkeys(("frontend_s", "prefill_s", "flow_s", "hift_s"), 0.0)
    model.token2wav = recording_token2wav
    model._prefill = timed(stage, "prefill_s", recording_prefill)
    model._flow_chunk = timed(stage, "flow_s", model._flow_chunk)
    model._vocode = timed(stage, "hift_s", model._vocode)
    frontend.frontend_zero_shot = timed(stage, "frontend_s", frontend.frontend_zero_shot)

    def stream():
        torch.cuda.synchronize()
        t0 = last = time.perf_counter()
        chunk_s, lens, splits = [], [], []
        stage.update(dict.fromkeys(stage, 0.0))
        for out in cv.inference_zero_shot(res_main["first_text"], "A short prompt.",
                                          res_main["prompt_wav"], stream=True):
            torch.cuda.synchronize()
            now = time.perf_counter()
            chunk_s.append(now - last)
            lens.append(len(out["tts_speech"]))
            splits.append(dict(stage, decode_and_host_s=now - last - sum(stage.values())))
            stage.update(dict.fromkeys(stage, 0.0))
            last = now
        return chunk_s, lens, splits, last - t0

    stream()                                                # warm-up
    for mod in (K1, K2, K3):
        mod.launches = 0
    streamed.clear()
    chunk_s, lens, splits, wall = stream()
    del frontend.frontend_zero_shot                         # the shared frontend's own method
    launches = {"lm_decode_attention": K1.launches, "dit_attention": K2.launches,
                "fused_layer_norm": K3.launches}
    tokens = streamed[-1]
    ref = model.llm_generate(*prefills[-1], None)
    hop, la, cache, hs = model.token_hop_len, model.pre_lookahead_len, model.mel_cache_len, \
        model.hop_samples
    k, n = len(lens) - 1, len(tokens)
    want = ([(2 * (hop + la) - cache) * hs] * min(k, 1) + [2 * (hop + la) * hs] * max(k - 1, 0)
            + [((cache if k else 0) + 2 * (n - hop * k)) * hs])
    audio_s = sum(lens) / 24000.0
    res = {"phase": "stream", "card": smi, "speech_tokens": n,
           "nonstream_greedy_tokens": len(ref), "tokens_equal": bool(np.array_equal(tokens, ref)),
           "chunks": len(lens), "chunk_samples": lens, "chunk_samples_expected": want,
           "first_chunk_latency_s": chunk_s[0], "chunk_s": chunk_s, "chunk_split_s": splits,
           "wall_s": wall,
           "audio_s": audio_s, "rtf": wall / max(audio_s, 1e-9), "launches": launches}
    emit(res)
    if lens != want or n != len(ref) or not res["tokens_equal"] or not all(launches.values()):
        raise AssertionError(f"stream phase failed: {res}")
    return res


def profile_request(run) -> None:
    """One more request under torch.profiler: device kernel time by name and
    the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType

    # device-side events only: the CPU ops' entries repeat their kernels' time
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    emit({"phase": "profile", "wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
          "device_busy_share": busy_ms / (wall * 1e3),
          "top": [{"name": k[:90], "ms": ms, "calls": n} for k, ms, n in rows[:25]]})


def kernel_times(fn, n: int = 10) -> dict:
    """{CUDA event name: (device ms, launches)} per call of fn, over n calls
    under torch.profiler (after one call outside it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            ms, count = out.get(e.key, (0.0, 0.0))
            out[e.key] = (ms + e.self_device_time_total / 1e3 / n, count + e.count / n)
    return out


def kernel_key(name: str) -> str:
    """A kernel's first `*_kernel` word (else its first word): template
    instances and both of a kernel's routes share it."""
    import re

    return (re.search(r"\w+_kernel", name) or re.search(r"\w+", name)).group(0)


def device_ms_by_kernel(fn, n: int = 10) -> dict:
    """Device time per call of each CUDA kernel that fn launches, over n calls
    under torch.profiler, keyed by kernel_key; the instances that share a key
    add up, so the values sum to the device time of every CUDA event."""
    ms = {}
    for name, (t, _) in kernel_times(fn, n).items():
        ms[kernel_key(name)] = ms.get(kernel_key(name), 0.0) + t
    return ms


def device_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Device time of one call of fn: `calls` calls captured in one CUDA graph,
    CUDA events around `replays` replays of it.  No host work is in it: where
    a call's host work outlasts its kernels, time_ms measures the host and
    this the device."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):                   # allocations and scratch before the capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def dev_time(fn, prefix: str = "dev") -> dict:
    """`{prefix}_ms`: the median of three device_ms runs of fn, all three
    listed under `{prefix}_ms_runs`.  Where fn refuses stream capture (a
    cooperative launch may), the three runs are CUDA events around 50
    back-to-back calls instead, and `{prefix}_method` says "events"."""
    method = "graph"
    try:
        runs = [device_ms(fn) for _ in range(3)]
    except RuntimeError as e:
        torch.cuda.synchronize()
        method, runs = "events", [time_ms(fn, iters=50) for _ in range(3)]
        emit({"phase": "timing", "capture_refused": prefix, "error": str(e)[:200]})
    return {f"{prefix}_ms": sorted(runs)[1], f"{prefix}_ms_runs": runs,
            f"{prefix}_method": method}


def int4pack_call(x, w_packed, scale, group: int = 128):
    """PyTorch's own group-wise int4 matmul (torch._weight_int4pack_mm, the
    tinygemm kernel) set up to compute K5's function on the same inputs: the
    weights converted once to its layout (unsigned nibbles n + 8, even input
    row in the high nibble of its byte), its scales x's dtype and its zero
    points 0, so it dequantises to T(n * T(scale)) and sums in fp32, as K5
    does.  A timing yardstick only; the port never calls it.  Returns the
    call; raises where this PyTorch build lacks the op."""
    p = w_packed.to(torch.int32) & 0xFF
    lo, hi = (p & 0xF) ^ 8, ((p >> 4) & 0xF) ^ 8          # [in/2, out], n + 8
    packed = ((lo.t() << 4) | hi.t()).to(torch.uint8).contiguous()   # [out, in/2]
    wq = torch._convert_weight_to_int4pack(packed, 8)
    sz = torch.stack([scale.to(x.dtype), torch.zeros_like(scale, dtype=x.dtype)], -1)
    sz = sz.contiguous()
    return lambda: torch._weight_int4pack_mm(x, wq, group, sz)


def timing(K1, K2, K3, K4, K5, K6, K7, last_decode, flow, block_shape) -> list:
    """At the last request's shapes (bf16; K4 at the batched phase's flow
    shape; K7 fp32 at the bigvgan phase's four stage shapes, both layouts):
    each kernel against its plain version on the same inputs, then kernel,
    plain and library times."""
    from cosyvoice_tpu_torch.ops.resample import anti_alias_activation

    dev, bf = torch.device("cuda"), torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(2)
    r = lambda *s: torch.randn(*s, generator=g, device=dev).to(bf)
    n_text, n_prompt, n_tok = last_decode
    rows = []

    # K1: B=1 decode step at the final frontier of the last request
    cap = 200
    T = -(-(2 + n_text + n_prompt + cap) // 128) * 128
    pos = 2 + n_text + n_prompt + n_tok - 1
    q, kn, vn, ck, cv = r(1, 7, 128), r(1, 1, 128), r(1, 1, 128), r(1, T, 128), r(1, T, 128)
    bias = torch.zeros(1, T, device=dev)
    p = torch.tensor([pos], dtype=torch.int32, device=dev)
    k1_err = check_k1(K1, bf, q, kn, vn, ck, cv, bias, p, phase="timing")
    isz = 2
    k1_bytes = 2 * pos * 128 * isz + pos * 4 + 2 * 7 * 128 * isz + 4 * 128 * isz
    k1_flops = 4 * 7 * 128 * (pos + 1)
    # library yardstick: SDPA with GQA over the live rows plus the new one,
    # [1, 14, 1, 64] x [1, 2, pos+1, 64]; it leaves out the in-place append
    q_sd = q.reshape(1, 7, 2, 64).transpose(1, 2).reshape(1, 14, 1, 64)
    k_sd, v_sd = (torch.cat([c[:, :pos], new], dim=1).reshape(1, pos + 1, 2, 64)
                  .transpose(1, 2).contiguous() for c, new in ((ck, kn), (cv, vn)))
    k1 = lambda: K1.lm_decode_attention(q, kn, vn, ck, cv, bias, p, 64, 0.125)
    sdpa = lambda: F.scaled_dot_product_attention(q_sd, k_sd, v_sd, scale=0.125,
                                                  enable_gqa=True)
    rows.append(dict(
        name="lm_decode_attention", source="cosyvoice_tpu_torch/csrc/lm_decode_attention.cu",
        replaces="cosyvoice_tpu/ops/pallas/lm_decode_attention.py:123", shape=[1, T, pos],
        ms=time_ms(k1),
        plain_ms=time_ms(lambda: K1.lm_decode_attention_plain(q, kn, vn, ck, cv, bias, p,
                                                              64, 0.125)),
        library_ms=time_ms(sdpa), **dev_time(k1), **dev_time(sdpa, "library_dev"),
        bytes=k1_bytes, flops=k1_flops, max_abs_err=k1_err))

    # K1 at the engine's and the batched phase's shape: B = 8, cache 384,
    # per-row frontiers; the yardstick is SDPA over the whole cache plus the
    # new token with a boolean key mask that keeps the live rows of each row
    B8, T8 = len(K1_BATCH_POS), 384
    q, kn, vn, ck, cv = (r(B8, 7, 128), r(B8, 1, 128), r(B8, 1, 128), r(B8, T8, 128),
                         r(B8, T8, 128))
    bias = torch.zeros(B8, T8, device=dev)
    p8 = torch.tensor(K1_BATCH_POS, dtype=torch.int32, device=dev)
    k1b_err = check_k1(K1, bf, q, kn, vn, ck, cv, bias, p8, phase="timing")
    q_sd = q.reshape(B8, 7, 2, 64).transpose(1, 2).reshape(B8, 14, 1, 64)
    k_sd, v_sd = (torch.cat([c, new], dim=1).reshape(B8, T8 + 1, 2, 64).transpose(1, 2)
                  .contiguous() for c, new in ((ck, kn), (cv, vn)))
    j = torch.arange(T8 + 1, device=dev)[None, :]
    keymask = ((j < p8[:, None]) | (j == T8))[:, None, None, :]
    live = sum(K1_BATCH_POS)
    k1b = lambda: K1.lm_decode_attention(q, kn, vn, ck, cv, bias, p8, 64, 0.125)
    sdpa_b = lambda: F.scaled_dot_product_attention(q_sd, k_sd, v_sd, attn_mask=keymask,
                                                    scale=0.125, enable_gqa=True)
    rows.append(dict(
        name="lm_decode_attention", source="cosyvoice_tpu_torch/csrc/lm_decode_attention.cu",
        replaces="cosyvoice_tpu/ops/pallas/lm_decode_attention.py:123",
        shape=[B8, T8, list(K1_BATCH_POS)], launches_from="engine (full width, B = 8)",
        ms=time_ms(k1b), **dev_time(k1b),
        plain_ms=time_ms(lambda: K1.lm_decode_attention_plain(q, kn, vn, ck, cv, bias, p8,
                                                              64, 0.125)),
        library_ms=time_ms(sdpa_b), **dev_time(sdpa_b, "library_dev"),
        bytes=2 * live * 128 * isz + live * 4 + B8 * (2 * 7 + 4) * 128 * isz,
        flops=sum(4 * 7 * 128 * (pb + 1) for pb in K1_BATCH_POS), max_abs_err=k1b_err))

    # K2: the CFG batch of the last request's flow call, T padded to 128
    n = n_prompt + n_tok
    Tm = 2 * (-(-n // 50) * 50)
    Tp = -(-Tm // 128) * 128
    L = 2 * n
    qkv = r(2, Tp, 1536)
    lens = torch.full((2,), L, dtype=torch.int32, device=dev)
    q3, k3, v3 = (qkv[..., i * 512:(i + 1) * 512].reshape(2, Tp, 8, 64) for i in range(3))
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q3, k3, v3))
    keymask = (torch.arange(Tp, device=dev) < L)[None, None, None, :].expand(2, 1, 1, Tp)
    k2_err = check_attention(
        "dit_attention", bf, K2.dit_attention_packed(qkv, lens, 0.125, 64).reshape(2, Tp, 8, 64),
        K2.dit_attention_plain(q3, k3, v3, lens, 0.125), lens, phase="timing")
    # q and out over all Tp rows; k and v over the L live rows only
    k2_bytes = 2 * (2 * Tp * 512 + 2 * L * 512) * isz + 2 * 4
    k2 = lambda: K2.dit_attention_packed(qkv, lens, 0.125, 64)
    sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=keymask)
    rows.append(dict(
        name="dit_attention", source="cosyvoice_tpu_torch/csrc/dit_attention.cu",
        replaces="cosyvoice_tpu/ops/pallas/dit_attention.py:124", shape=[2, Tp, 1536, L],
        ms=time_ms(k2), **dev_time(k2),
        plain_ms=time_ms(lambda: K2.dit_attention_plain(q3, k3, v3, lens, 0.125)),
        library_ms=time_ms(sdpa), **dev_time(sdpa, "library_dev"),
        bytes=k2_bytes, flops=2 * 4 * 8 * Tp * L * 64, max_abs_err=k2_err))

    # K3: the estimator's LayerNorm over the CFG batch's rows
    x, w, b = r(2 * Tp, 256), r(256), r(256)
    k3_err = max(check(f"fused_layer_norm_{act}", bf, K3.fused_layer_norm(x, w, b, 1e-5, act),
                       K3.layer_norm_plain(x, w, b, 1e-5, act), phase="timing")
                 for act in ("none", "mish"))
    k3 = lambda: K3.fused_layer_norm(x, w, b, 1e-5, "none")
    ln = lambda: F.layer_norm(x, (256,), w, b, 1e-5)
    rows.append(dict(
        name="fused_layer_norm", source="cosyvoice_tpu_torch/csrc/fused_norm.cu",
        replaces="cosyvoice_tpu/ops/pallas/fused_norm.py:54", shape=[2 * Tp, 256],
        ms=time_ms(k3), **dev_time(k3),
        plain_ms=time_ms(lambda: K3.layer_norm_plain(x, w, b, 1e-5, "none")),
        library_ms=time_ms(ln), **dev_time(ln, "library_dev"),
        bytes=2 * 2 * Tp * 256 * isz + 2 * 256 * isz, flops=10 * 2 * Tp * 256,
        max_abs_err=k3_err))

    # K5: one decode row through each projection shape; the row is 896 -> 4864
    def k5_inputs(IN, OUT, rows=1):
        w = K5.pack_int4(torch.randint(-7, 8, (IN, OUT), generator=g, device=dev))
        return r(rows, IN), w, torch.rand(IN // 128, OUT, generator=g, device=dev) * 0.02 + 1e-3

    def k5_bytes(IN, OUT, rows=1):
        return IN // 2 * OUT + IN // 128 * OUT * 4 + rows * (IN + OUT) * isz

    def k5_library(x5, name):
        """torch._weight_int4pack_mm on x5, held against the plain version
        (recorded, not gated: it is a yardstick): timing keys, or the error
        where this PyTorch build has no such op."""
        try:
            lib = int4pack_call(*x5)
            got = lib()
        except (RuntimeError, AttributeError, NotImplementedError) as e:
            emit({"phase": "timing", "library_refused": name, "error": str(e)[:300]})
            return dict(library_ms=None, library_dev_ms=None, library_error=str(e)[:300])
        want = K5.int4_matmul_plain(*x5).float()
        atol, rtol = CHECK_TOL[bf]
        return dict(library_ms=time_ms(lib), **dev_time(lib, "library_dev"),
                    library_call="torch._weight_int4pack_mm (zero points 0)",
                    library_max_abs_err=float((got.float() - want).abs().max()),
                    library_within_tol=bool(torch.allclose(got.float(), want, atol=atol,
                                                           rtol=rtol)))

    # one row a projection shape; launches are the int4 request's, all four
    # shapes together
    for IN, OUT in K5_SHAPES:
        x5 = k5_inputs(IN, OUT)
        k5_err = check(f"int4_matmul_1x{IN}x{OUT}", bf, K5.int4_matmul(*x5),
                       K5.int4_matmul_plain(*x5), phase="timing")
        k5 = lambda: K5.int4_matmul(*x5)
        rows.append(dict(
            name="int4_matmul", source="cosyvoice_tpu_torch/csrc/int4_matmul.cu",
            replaces="cosyvoice_tpu/ops/pallas/int4_matmul.py:84", shape=[1, IN, OUT],
            launches_scope="the int4 request, all four shapes together",
            plan=K5.plan(1, IN, OUT, 128), ms=time_ms(k5), **dev_time(k5),
            plain_ms=time_ms(lambda: K5.int4_matmul_plain(*x5)),
            **k5_library(x5, f"int4_matmul_1x{IN}x{OUT}"),
            bytes=k5_bytes(IN, OUT), flops=2 * IN * OUT, max_abs_err=k5_err))
    # a decode step's 168 K5 launches (24 layers x K5_STEP), each on weights
    # of its own as in the int4 request: 179 MB of packed int4, more than the
    # 50 MB L2 holds, where each row above reuses one weight from the L2; the
    # library yardstick runs the same step on the same weights
    step_args = [k5_inputs(IN, OUT) for _ in range(24) for IN, OUT in K5_STEP]
    k5_step = lambda: [K5.int4_matmul(*a) for a in step_args]
    before = K5.launches
    k5_step()
    step = dict(launches=K5.launches - before, **dev_time(k5_step, "step_dev"),
                bound_ms=sum(k5_bytes(2 * a[1].shape[0], a[1].shape[1]) for a in step_args)
                / HBM_BYTES_PER_S * 1e3)
    try:
        lib_step = [int4pack_call(*a) for a in step_args]
        step.update(dev_time(lambda: [f() for f in lib_step], "library_step_dev"))
        del lib_step
    except (RuntimeError, AttributeError, NotImplementedError) as e:
        step.update(library_step_dev_ms=None, library_error=str(e)[:300])
    del step_args
    rows[-len(K5_SHAPES)]["decode_step"] = step

    # K6: one full-width step at the K1 row's frontier (pos 364 of 384 rows)
    inp = step_inputs(K6, bf, 7, C=T, pos=pos)
    k6_err = check_step(K6, inp, bf, phase="timing")
    w = inp["w"]
    n_int8 = sum(t.numel() for t in (w.wqkv, w.wo, w.wg, w.wu, w.wd))
    n_f32 = sum(t.numel() for t in (w.sqkv, w.bqkv, w.so, w.sg, w.su, w.sd, w.n1, w.n2))
    L = w.wqkv.shape[0]
    k6 = lambda: run_step(K6, inp)
    k6_ms, k6_dev = time_ms(k6), dev_time(k6)
    n_sync = 5 * L                  # five grid barriers a layer
    probe = lambda: K6.sync_probe(n_sync, dev)
    grid = probe()
    sync_ms, sync_dev = time_ms(probe), dev_time(probe, "sync_dev")
    # int8 weights + fp32 scales/biases/norms + live cache rows read + the
    # new rows written + x, y and the RoPE tables
    k6_bytes = n_int8 + 4 * n_f32 + 2 * L * (pos + 1) * 128 * isz + 2 * 896 * isz + 2 * 64 * 4
    rows.append(dict(
        name="lm_step", source="cosyvoice_tpu_torch/csrc/lm_step.cu",
        replaces="cosyvoice_tpu/ops/pallas/lm_step.py:222", shape=[L, 1, 896, T, pos],
        ms=k6_ms, **k6_dev, plain_ms=time_ms(lambda: run_step(K6, inp, plain=True), iters=10),
        library_ms=None, bytes=k6_bytes,
        flops=2 * n_int8 + L * 4 * 14 * 64 * (pos + 1), max_abs_err=k6_err,
        grid_blocks=grid, plan=step_plan(K6, T, dev), grid_syncs=n_sync, sync_ms=sync_ms,
        **sync_dev, sync_share=sync_dev["sync_dev_ms"] / k6_dev["dev_ms"],
        hbm_share=k6_bytes / (k6_dev["dev_ms"] * 1e-3) / HBM_BYTES_PER_S))
    # K4: one DiT block of the main path's estimator (its bf16 weights) over
    # the batched phase's CFG batch; the yardstick is the same block unfused
    # (K3 norms, K2 attention, cuBLAS projections): no one PyTorch call
    # computes the block
    B4, T4, lens4 = block_shape
    blk = dit_blocks(flow)[0]
    w4 = blk.fused_weights(bf)
    x4 = r(B4, T4, 256)
    L4 = torch.tensor(lens4, dtype=torch.int32, device=dev)
    kw4 = dict(sm_scale=0.125, heads=8, head_dim=64)
    k4_err = check_block("dit_block", bf,
                         K4.dit_block_fused(x4, L4, *w4, **kw4, return_attention=True),
                         K4.dit_block_plain(x4, L4, *w4, **kw4, return_attention=True),
                         phase="timing")
    dim, inner, ff = 256, 512, 1024
    blk.fused_block = False
    k4 = lambda: K4.dit_block_fused(x4, L4, *w4, **kw4)
    unfused = lambda: blk(x4, None, L4)
    # K2 alone at the block's qkv shape: the floor of K4's attention launch
    qkv4 = r(B4, T4, 3 * inner)
    k2_block = dev_time(lambda: K2.dit_attention_packed(qkv4, L4, 0.125, 64), "k2_dev")
    rows.append(dict(
        name="dit_block", source="cosyvoice_tpu_torch/csrc/dit_block.cu",
        replaces="cosyvoice_tpu/ops/pallas/dit_block.py:115", shape=[B4, T4, dim],
        ms=time_ms(k4, iters=20), **dev_time(k4),
        plain_ms=time_ms(lambda: K4.dit_block_plain(x4, L4, *w4, **kw4), iters=10),
        library_ms=None, unfused_block_ms=time_ms(unfused, iters=20),
        **dev_time(unfused, "unfused_block_dev"),
        # its three launches (LN1 + qkv, K2's attention, out-proj + LN3 + FFN)
        phase_ms=device_ms_by_kernel(lambda: K4.dit_block_fused(x4, L4, *w4, **kw4)),
        plan=K4.plan(B4, T4, dim, 8, 64, ff), k2_shape=[B4, T4, 3 * inner], **k2_block,
        # x in and y out, the weights once, the fp32 vectors, the lengths
        bytes=(2 * B4 * T4 * dim + 3 * dim * inner + inner * dim + 2 * dim * ff) * isz
        + (6 * dim + ff) * 4 + 4 * B4,
        flops=sum(2 * T4 * dim * 3 * inner + 4 * 8 * T4 * Lb * 64 + 2 * T4 * inner * dim
                  + 4 * T4 * dim * ff for Lb in lens4),
        max_abs_err=k4_err))
    # K7: one AAAct at each stage shape of the bigvgan phase, fp32, with x
    # channels-first (the convolutions' memory: the path's layout) and, nested,
    # channels-last (the TPU kernel's layout); no single PyTorch call computes
    # it, so the library column times the composite (upsample2 -> snake_beta
    # -> downsample2) on the same channels-first x
    for shape in K7_STAGES:
        x7, a7, b7, _ = snake_inputs(shape, True, True, g)
        x7cf = channels_first(x7)
        want = K7.snake_aa_plain(x7, a7, b7)
        tag = "x".join(map(str, shape))
        err_cf, err_cl = (check(f"snake_aa_{tag}_{lay}", torch.float32,
                                K7.snake_aa(xx, a7, b7), want, phase="timing")
                          for lay, xx in (("channels_first", x7cf), ("channels_last", x7)))
        del want
        k7 = lambda: K7.snake_aa(x7cf, a7, b7)
        k7_cl = lambda: K7.snake_aa(x7, a7, b7)
        composite = lambda: anti_alias_activation(x7cf, a7, b7)
        B7, T7, C7 = shape
        row = dict(
            name="snake_aa", source="cosyvoice_tpu_torch/csrc/snake_aa.cu",
            replaces="cosyvoice_tpu/ops/pallas/snake_aa.py:99", shape=list(shape),
            dtype="float32", layout="channels_first",
            plan=K7.plan(B7, T7, C7, K7.CHANNELS_FIRST, sms),
            ms=time_ms(k7, iters=20), **dev_time(k7),
            plain_ms=time_ms(lambda: K7.snake_aa_plain(x7cf, a7, b7), iters=10),
            library_ms=time_ms(composite, iters=10), **dev_time(composite, "library_dev"),
            library_call="composite anti_alias_activation (upsample2 -> snake_beta -> "
                         "downsample2)",
            channels_last=dict(plan=K7.plan(B7, T7, C7, K7.CHANNELS_LAST, sms),
                               ms=time_ms(k7_cl, iters=20), **dev_time(k7_cl),
                               max_abs_err=err_cl),
            # x read and y written once, alpha and beta once, in fp32
            bytes=2 * x7.numel() * 4 + 2 * C7 * 4, flops=K7_FLOPS_PER_OUTPUT * x7.numel(),
            peak_flops=FP32_FLOPS, max_abs_err=err_cf)
        if shape == K7_STAGES[2]:
            # the copy that AAAct made ahead of each launch until K7 took
            # channels-first x: what the path no longer pays
            copy = lambda: x7cf.contiguous()
            row.update(layout_copy_ms=time_ms(copy, iters=20),
                       **dev_time(copy, "layout_copy_dev"))
        rows.append(row)
        del x7, x7cf
        torch.cuda.empty_cache()
    for row in rows:
        row.setdefault("peak_flops", BF16_FLOPS)
        t_bytes = row["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = row["flops"] / row["peak_flops"] * 1e3
        row.update(route="cuda", bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on a GPU",
              file=sys.stderr)
        return 1
    from cosyvoice_tpu_torch.ops.kernels import build
    from cosyvoice_tpu_torch.ops.kernels import dit_attention as K2
    from cosyvoice_tpu_torch.ops.kernels import dit_block as K4
    from cosyvoice_tpu_torch.ops.kernels import fused_norm as K3
    from cosyvoice_tpu_torch.ops.kernels import int4_matmul as K5
    from cosyvoice_tpu_torch.ops.kernels import lm_decode_attention as K1
    from cosyvoice_tpu_torch.ops.kernels import lm_step as K6
    from cosyvoice_tpu_torch.ops.kernels import snake_aa as K7

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    build.library()
    ptxas = [ln.strip() for ln in build.report["ptxas"].splitlines()
             if "Used" in ln or "Compiling entry" in ln or ln.startswith("==")]
    emit({"phase": "build", "seconds": build.report["seconds"],
          "cached": build.report["cached"], "ptxas": ptxas})

    errs = kernel_checks(K1, K2, K3)
    errs.update(quant_kernel_checks(K5, K6))
    errs["dit_block"] = block_checks(K4)
    errs["snake_aa"] = snake_checks(K7)
    reference_check()
    res = main_path(K1, K2, K3, smi, profile="--profile" in sys.argv[1:])
    # later slices' paths: K6 from the fused_step phase, K5 from the int4
    # phase, K4 from the batched phase (the engine phase drives K1 per row),
    # K7 from the bigvgan phase (the stream phase drives K1-K3)
    launches = dict(res["launches"])
    launches["lm_step"] = fused_step_phase(res["stack"][0], res["first_prompt"], K1, K6,
                                           smi)["k6_launches"]
    launches["int4_matmul"] = int4_phase(res, K5, smi)["k5_launches"]
    batched = batched_phase(res, K1, K4, smi)
    launches["dit_block"] = batched["k4_launches"]
    k1_engine = engine_phase(res, K1, smi)["full_width_int8"]["k1_launches"]
    vocoder = bigvgan_phase(K7, smi)
    launches["snake_aa"] = vocoder["k7_launches"]
    stream_phase(res, K1, K2, K3, smi)
    flow = res["stack"][1]
    del res["stack"]
    rows = timing(K1, K2, K3, K4, K5, K6, K7, res["last_decode"], flow, batched["block_shape"])
    tolerance = {"lm_step": K6_REL_TOL[torch.bfloat16],
                 "dit_block": {"bf16_ulps_at_max_plain": K4_BF16_ULPS},
                 "dit_attention": {"bf16_ulps_at_max_plain_per_row_head": K2_BF16_ULPS},
                 "snake_aa": CHECK_TOL[torch.float32]}
    for row in rows:
        if row["name"] == "snake_aa":
            # the bigvgan forward's launches at this row's stage shape
            row["launches"] = vocoder["k7_launches_by_stage"].get(
                "x".join(map(str, row["shape"][1:])), 0)
        else:
            row["launches"] = k1_engine if "launches_from" in row else launches[row["name"]]
        row.update(edge_max_abs_err=errs[row["name"]],
                   tolerance=tolerance.get(row["name"], CHECK_TOL[torch.bfloat16]),
                   kernel_ms=row["ms"])
    print(smi, flush=True)
    emit({"kernels": rows, "card": smi})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
