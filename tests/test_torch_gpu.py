"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA GPU and skip without one.  They import no JAX,
so they also run where JAX is absent:
    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""
import math

import numpy as np
import pytest
import torch

from cosyvoice_tpu_torch.ops.kernels import dit_attention as K2
from cosyvoice_tpu_torch.ops.kernels import dit_block as K4
from cosyvoice_tpu_torch.ops.kernels import fused_norm as K3
from cosyvoice_tpu_torch.ops.kernels import int4_matmul as K5
from cosyvoice_tpu_torch.ops.kernels import lm_decode_attention as K1
from cosyvoice_tpu_torch.ops.kernels import lm_step as K6
from cosyvoice_tpu_torch.ops.kernels import snake_aa as K7

# the LM's projection shapes (in, out) at Qwen2-0.5B width: q/o, k/v, gate/up, down
K5_SHAPES = ((896, 896), (896, 128), (896, 4864), (4864, 896))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _assert_attention_close(got, want, lengths, dtype):
    """K2's bar on the valid rows (t < lengths[b]) of o [B, T, H, D]: fp32
    2e-5; bf16 two bf16 ulps at the max |plain| of each (batch row, head).
    Both round q and p to bf16, but the kernel rounds p against the online
    softmax's running max and the plain version against the row max, so a p
    may round apart and an output may land one ulp of its row and head's
    magnitude away (elementwise 2**-7 |o| does not hold where |o| is
    small)."""
    assert torch.isfinite(got).all()
    got, want = got.float(), want.float()
    valid = (torch.arange(got.shape[1], device=got.device)[None, :]
             < lengths[:, None])[:, :, None, None].expand_as(got)
    if dtype == torch.float32:
        torch.testing.assert_close(got[valid], want[valid], atol=2e-5, rtol=2e-5)
    else:
        diff = torch.where(valid, (got - want).abs(), 0.0)
        top = torch.where(valid, want.abs(), 0.0).amax(dim=(1, 3), keepdim=True)
        limit = 2 * torch.where(top > 0, torch.exp2(torch.floor(torch.log2(top)) - 7), 0.0)
        assert (diff <= limit).all(), float((diff - limit).max())


@pytest.mark.gpu
# (atol, rtol): both sides compute in fp32; fp32 outputs differ only in the
# order of the sums, bf16 outputs by at most one bf16 ulp of |y| (2**-7 |y|);
# K2 in bf16 by two bf16 ulps at the max |plain| of each (batch row, head)
# (_assert_attention_close).
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 2e-5, 2e-5),
                                             (torch.bfloat16, 1e-4, 2.0 ** -7)])
def test_cuda_kernels_match_plain(cuda, dtype, atol, rtol):
    """Each kernel against its plain version on the card (main-path widths)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g, device=cuda).to(dtype)
    B, T, KHD = 4, 512, 128
    q, kn, vn, ck, cv = r(B, 7, KHD), r(B, 1, KHD), r(B, 1, KHD), r(B, T, KHD), r(B, T, KHD)
    bias = torch.zeros(B, T, device=cuda)
    pos = torch.tensor([0, 17, 300, 511], dtype=torch.int32, device=cuda)
    ck2, cv2 = ck.clone(), cv.clone()
    o, _, _ = K1.lm_decode_attention(q, kn, vn, ck, cv, bias, pos, 64, 0.125)
    o_ref, _, _ = K1.lm_decode_attention_plain(q, kn, vn, ck2, cv2, bias, pos, 64, 0.125)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=atol, rtol=rtol)
    assert torch.equal(ck, ck2) and torch.equal(cv, cv2)

    qkv = r(4, 1152, 3 * 512)
    lens = torch.tensor([1152, 1000, 517, 0], dtype=torch.int32, device=cuda)
    o = K2.dit_attention_packed(qkv, lens, 0.125, 64).reshape(4, 1152, 8, 64)
    q3, k3, v3 = (qkv[..., i * 512:(i + 1) * 512].reshape(4, 1152, 8, 64) for i in range(3))
    o_ref = K2.dit_attention_plain(q3, k3, v3, lens, 0.125)
    _assert_attention_close(o, o_ref, lens, dtype)

    x, w, bb = r(2304, 256), r(256), r(256)
    for act in ("none", "mish"):
        torch.testing.assert_close(K3.fused_layer_norm(x, w, bb, 1e-5, act).float(),
                                   K3.layer_norm_plain(x, w, bb, 1e-5, act).float(),
                                   atol=atol, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 2e-5, 2e-5),
                                             (torch.bfloat16, 1e-4, 2.0 ** -7)])
def test_lm_decode_attention_split_boundaries(cuda, dtype, atol, rtol):
    """K1 at B = 1 (one query row, the split kernel's keys spread over
    ceil(Tc / 32) blocks) with pos at 0, 1, chunk - 1, chunk, chunk + 1 and
    Tc - 1, at three cache lengths (12, 128 and 264 splits); a pad bias on a
    tenth of the keys; the cache must equal the plain version's after each
    call."""
    g = torch.Generator(device=cuda).manual_seed(6)
    r = lambda *s: torch.randn(*s, generator=g, device=cuda).to(dtype)
    c = K1.CHUNK
    for Tc in (384, 4096, 8448):
        ck, cv = r(1, Tc, 128), r(1, Tc, 128)
        bias = torch.where(torch.rand(1, Tc, generator=g, device=cuda) < 0.1, -1e9, 0.0)
        ck2, cv2 = ck.clone(), cv.clone()
        for pos in (0, 1, c - 1, c, c + 1, Tc - 1):
            q, kn, vn = r(1, 7, 128), r(1, 1, 128), r(1, 1, 128)
            o, _, _ = K1.lm_decode_attention(q, kn, vn, ck, cv, bias, pos, 64, 0.125)
            o_ref, _, _ = K1.lm_decode_attention_plain(q, kn, vn, ck2, cv2, bias, pos, 64,
                                                       0.125)
            torch.testing.assert_close(o.float(), o_ref.float(), atol=atol, rtol=rtol)
            assert torch.equal(ck, ck2) and torch.equal(cv, cv2), (Tc, pos)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 2e-5, 2e-5),
                                             (torch.bfloat16, 1e-4, 2.0 ** -7)])
def test_lm_decode_attention_per_row_batch8(cuda, dtype, atol, rtol):
    """K1 at the engine's shape: B = 8, cache 384, per-row pos spread over
    100-380, three steps in a row (each appends, the next reads it back)."""
    g = torch.Generator(device=cuda).manual_seed(7)
    r = lambda *s: torch.randn(*s, generator=g, device=cuda).to(dtype)
    ck, cv = r(8, 384, 128), r(8, 384, 128)
    ck2, cv2 = ck.clone(), cv.clone()
    bias = torch.zeros(8, 384, device=cuda)
    pos = torch.tensor([100, 140, 180, 220, 260, 300, 340, 380], dtype=torch.int32,
                       device=cuda)
    for step in range(3):
        q, kn, vn = r(8, 7, 128), r(8, 1, 128), r(8, 1, 128)
        o, _, _ = K1.lm_decode_attention(q, kn, vn, ck, cv, bias, pos + step, 64, 0.125)
        o_ref, _, _ = K1.lm_decode_attention_plain(q, kn, vn, ck2, cv2, bias, pos + step, 64,
                                                   0.125)
        torch.testing.assert_close(o.float(), o_ref.float(), atol=atol, rtol=rtol)
        assert torch.equal(ck, ck2) and torch.equal(cv, cv2), step


@pytest.mark.gpu
def test_lm_decode_attention_two_streams(cuda):
    """K1 launched on two streams at once: each stream gets its own counters
    and partials, so both outputs and caches match the plain version."""
    g = torch.Generator(device=cuda).manual_seed(9)
    r = lambda *s: torch.randn(*s, generator=g, device=cuda)
    side = torch.cuda.Stream(cuda)
    cases = [(r(2, 7, 128), r(2, 1, 128), r(2, 1, 128), r(2, 4096, 128), r(2, 4096, 128))
             for _ in range(2)]
    bias = torch.zeros(2, 4096, device=cuda)
    pos = torch.tensor([4000, 2500], dtype=torch.int32, device=cuda)
    refs = [K1.lm_decode_attention_plain(q, kn, vn, ck.clone(), cv.clone(), bias, pos, 64,
                                         0.125) for q, kn, vn, ck, cv in cases]
    side.wait_stream(torch.cuda.current_stream(cuda))
    outs = []
    for i in range(20):
        q, kn, vn, ck, cv = cases[i % 2]
        if i % 2:
            with torch.cuda.stream(side):
                outs.append(K1.lm_decode_attention(q, kn, vn, ck, cv, bias, pos, 64, 0.125))
        else:
            outs.append(K1.lm_decode_attention(q, kn, vn, ck, cv, bias, pos, 64, 0.125))
    torch.cuda.synchronize(cuda)
    for i, (o, ck, cv) in enumerate(outs):
        o_ref, ck_ref, cv_ref = refs[i % 2]
        torch.testing.assert_close(o, o_ref, atol=2e-5, rtol=2e-5)
        assert torch.equal(ck, ck_ref) and torch.equal(cv, cv_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [640, 1152, 700])
def test_dit_attention_ragged(cuda, dtype, T):
    """K2 packed and unpacked at T = 640, 1152 and 700 (a ragged query tail),
    lengths 0, 1, 63, 64, 65 and T (key tiles of 64): every valid row within
    the bar, the length-0 row all zeros."""
    g = torch.Generator(device=cuda).manual_seed(8)
    lens = torch.tensor([0, 1, 63, 64, 65, T], dtype=torch.int32, device=cuda)
    qkv = torch.randn(6, T, 3 * 512, generator=g, device=cuda).to(dtype)
    q3, k3, v3 = (qkv[..., i * 512:(i + 1) * 512].reshape(6, T, 8, 64) for i in range(3))
    want = K2.dit_attention_plain(q3, k3, v3, lens, 0.125)
    for got in (K2.dit_attention_packed(qkv, lens, 0.125, 64).reshape(6, T, 8, 64),
                K2.dit_attention(q3.contiguous(), k3.contiguous(), v3.contiguous(), lens,
                                 0.125)):
        _assert_attention_close(got, want, lens, dtype)
        assert not got[0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 2e-5, 2e-5),
                                             (torch.bfloat16, 1e-4, 2.0 ** -7)])
def test_int4_matmul_matches_plain(cuda, dtype, atol, rtol):
    """K5 at the LM's four projection shapes, group 128: one row (the split
    route; 896 -> 4864 splits its 7 groups unevenly, 3 splits of 2 and one
    of 1) and 3, 8 and 200 rows (the 8-row kernel).  Same bars as above (one
    fp32 sum per output, rounded once)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    for IN, OUT in K5_SHAPES:
        w = K5.pack_int4(torch.randint(-7, 8, (IN, OUT), generator=g, device=cuda))
        scale = torch.rand(IN // 128, OUT, generator=g, device=cuda) * 0.02 + 1e-3
        for rows in (1, 3, 8, 200):
            x = torch.randn(rows, IN, generator=g, device=cuda).to(dtype)
            torch.testing.assert_close(K5.int4_matmul(x, w, scale).float(),
                                       K5.int4_matmul_plain(x, w, scale).float(),
                                       atol=atol, rtol=rtol)


@pytest.mark.gpu
def test_int4_matmul_plan_fills_the_card(cuda):
    """At one row K5's split route launches at least one block an SM at the
    three wide projections and at least 56 at 896 -> 128 (57 KB of packed
    weights); one shape splits its groups unevenly; more than one row takes
    the 8-row route."""
    for (IN, OUT), need in ((K5_SHAPES[0], 132), (K5_SHAPES[1], 56), (K5_SHAPES[2], 132),
                            (K5_SHAPES[3], 132)):
        p = K5.plan(1, IN, OUT, 128)
        assert p["route"] == "split" and p["blocks"] >= need, (IN, OUT, p)
    p = K5.plan(1, 896, 4864, 128)
    assert (896 // 2) % p["split_rows"], p
    for rows in (2, 8, 200):
        assert K5.plan(rows, 896, 4864, 128)["route"] == "prefill", rows


@pytest.mark.gpu
def test_int4_matmul_two_streams(cuda):
    """K5's decode route launched on two streams at once: each stream gets
    its own partials and counters, so both outputs match the plain version."""
    g = torch.Generator(device=cuda).manual_seed(11)
    side = torch.cuda.Stream(cuda)
    w = K5.pack_int4(torch.randint(-7, 8, (4864, 896), generator=g, device=cuda))
    scale = torch.rand(38, 896, generator=g, device=cuda) * 0.02 + 1e-3
    xs = [torch.randn(1, 4864, generator=g, device=cuda) for _ in range(2)]
    refs = [K5.int4_matmul_plain(x, w, scale) for x in xs]
    side.wait_stream(torch.cuda.current_stream(cuda))
    outs = []
    for i in range(40):
        if i % 2:
            with torch.cuda.stream(side):
                outs.append(K5.int4_matmul(xs[1], w, scale))
        else:
            outs.append(K5.int4_matmul(xs[0], w, scale))
    torch.cuda.synchronize(cuda)
    for i, y in enumerate(outs):
        torch.testing.assert_close(y, refs[i % 2], atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 2e-5, 2e-5),
                                             (torch.bfloat16, 1e-4, 2.0 ** -7)])
def test_fused_layer_norm_routes(cuda, dtype, atol, rtol):
    """K3 on its vector route (C = 256 with an odd row count, C = 1024) and
    its element route (C = 64 and 96, and an x that is not 16-byte
    aligned), with and without the mish."""
    g = torch.Generator(device=cuda).manual_seed(12)
    r = lambda *s: torch.randn(*s, generator=g, device=cuda).to(dtype)
    for N, C, off in ((1281, 256, 0), (37, 1024, 0), (37, 64, 0), (37, 96, 0), (100, 256, 1)):
        x = (r(N * C + off) * 3)[off:].view(N, C)
        w, b = r(C), r(C)
        for act in ("none", "mish"):
            torch.testing.assert_close(K3.fused_layer_norm(x, w, b, 1e-5, act).float(),
                                       K3.layer_norm_plain(x, w, b, 1e-5, act).float(),
                                       atol=atol, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 2e-5, 2e-5),
                                             (torch.bfloat16, 1e-4, 2.0 ** -7)])
@pytest.mark.parametrize("T", [947, 689])
def test_v1_estimator_shapes(cuda, dtype, atol, rtol, T):
    """K2 and K3 at the CosyVoice v1 estimator's shapes: the CFG pair (B = 2),
    an odd T at the top level (947: a 3 s prompt and 200 tokens at 22.05 kHz
    / 256 hop; 689: 200 tokens without a prompt) and ceil(T / 2) at the mid
    level, every key valid (v1's all-ones mel mask, no pad); K3 over both
    levels' rows at C = 256 with and without the mish."""
    g = torch.Generator(device=cuda).manual_seed(21)
    for rows in (T, -(-T // 2)):
        qkv = torch.randn(2, rows, 3 * 512, generator=g, device=cuda).to(dtype)
        lens = torch.full((2,), rows, dtype=torch.int32, device=cuda)
        q3, k3, v3 = (qkv[..., i * 512:(i + 1) * 512].reshape(2, rows, 8, 64) for i in range(3))
        _assert_attention_close(K2.dit_attention_packed(qkv, lens, 0.125, 64).reshape(
            2, rows, 8, 64), K2.dit_attention_plain(q3, k3, v3, lens, 0.125), lens, dtype)
        x = (torch.randn(2 * rows, 256, generator=g, device=cuda) * 3).to(dtype)
        w, b = (torch.randn(256, generator=g, device=cuda).to(dtype) for _ in range(2))
        for act in ("none", "mish"):
            torch.testing.assert_close(K3.fused_layer_norm(x, w, b, 1e-5, act).float(),
                                       K3.layer_norm_plain(x, w, b, 1e-5, act).float(),
                                       atol=atol, rtol=rtol)


def _step_case(cuda, dtype, seed, L, C, pos):
    g = torch.Generator(device=cuda).manual_seed(seed)
    H, I, nq, nkv = 896, 4864, 14, 2
    w = K6.random_step_weights(L, H, I, nq, nkv, 64, g, cuda)
    x = torch.randn(1, H, generator=g, device=cuda).to(dtype)
    kc, vc = (torch.randn(L, C, nkv * 64, generator=g, device=cuda).to(dtype)
              for _ in range(2))
    ang = pos * 1e6 ** (-torch.arange(0, 64, 2, device=cuda) / 64.0)
    return w, x, kc, vc, torch.cos(ang).repeat(2), torch.sin(ang).repeat(2)


@pytest.mark.gpu
# max |kernel - plain| / max |plain|: fp32 differs only in the order of the
# sums; in bf16 the two round intermediate values separately, and a rounding
# that flips one way in one of them moves the rest of the layer by an ulp.
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_lm_step_matches_plain(cuda, dtype, rel):
    """K6: one full-width step (Qwen2-0.5B widths, 4 layers) at pos 364 of a
    384-row cache: the output hidden state and every layer's new k/v."""
    g = torch.Generator(device=cuda).manual_seed(4)
    L, H, I, nq, nkv, C, pos = 4, 896, 4864, 14, 2, 384, 364
    w = K6.random_step_weights(L, H, I, nq, nkv, 64, g, cuda)
    x = torch.randn(1, H, generator=g, device=cuda).to(dtype)
    kc, vc = (torch.randn(L, C, nkv * 64, generator=g, device=cuda).to(dtype)
              for _ in range(2))
    ang = pos * 1e6 ** (-torch.arange(0, 64, 2, device=cuda) / 64.0)
    cos, sin = torch.cos(ang).repeat(2), torch.sin(ang).repeat(2)
    kc2, vc2 = kc.clone(), vc.clone()
    y = K6.lm_step(w, x, kc, vc, pos, cos, sin, nq=nq, nkv=nkv, hd=64)
    y_ref = K6.lm_step_plain(w, x, kc2, vc2, pos, cos, sin, nq=nq, nkv=nkv, hd=64)
    for got, want in ((y, y_ref), (kc[:, pos], kc2[:, pos]), (vc[:, pos], vc2[:, pos])):
        err = (got.float() - want.float()).abs().max()
        assert err <= rel * want.float().abs().max(), float(err)
    assert torch.equal(kc[:, :pos], kc2[:, :pos]) and torch.equal(kc[:, pos + 1:], kc2[:, pos + 1:])


@pytest.mark.gpu
# the bars of test_lm_step_matches_plain
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("C,pos", [(384, 0), (384, 1), (384, 383), (4096, 4000), (384, 17),
                                   (384, 32), (4096, 64)],
                         ids=["first_row", "second_row", "last_row", "long_cache",
                              "in_first_chunk", "chunk_boundary", "long_chunk_boundary"])
def test_lm_step_cache_frontiers(cuda, dtype, rel, C, pos):
    """K6 (4 layers at Qwen2-0.5B widths) at the cache's frontiers: the new
    token alone (pos 0), one cached row, a full 384-row cache, a 4096-row
    cache at pos 4000, a pos inside the first 32-key chunk, and the new token
    alone in a chunk of its own (pos 32; pos 64 with the 4096-row cache's
    64-key chunks); y and the new k/v within the bar, every other cache row
    untouched."""
    w, x, kc, vc, cos, sin = _step_case(cuda, dtype, 13, 4, C, pos)
    kc2, vc2 = kc.clone(), vc.clone()
    y = K6.lm_step(w, x, kc, vc, pos, cos, sin, nq=14, nkv=2, hd=64)
    y_ref = K6.lm_step_plain(w, x, kc2, vc2, pos, cos, sin, nq=14, nkv=2, hd=64)
    for got, want in ((y, y_ref), (kc[:, pos], kc2[:, pos]), (vc[:, pos], vc2[:, pos])):
        assert torch.isfinite(got).all()
        err = (got.float() - want.float()).abs().max()
        assert err <= rel * want.float().abs().max(), float(err)
    for a, b in ((kc, kc2), (vc, vc2)):
        assert torch.equal(a[:, :pos], b[:, :pos]) and torch.equal(a[:, pos + 1:], b[:, pos + 1:])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lm_step_is_deterministic(cuda, dtype):
    """K6 adds its split-K partials and attention chunks in a fixed order, so
    two launches on the same inputs give bit-identical y and cache rows."""
    w, x, kc, vc, cos, sin = _step_case(cuda, dtype, 21, 4, 384, 300)
    runs = []
    for _ in range(2):
        k2, v2 = kc.clone(), vc.clone()
        runs.append((K6.lm_step(w, x, k2, v2, 300, cos, sin, nq=14, nkv=2, hd=64), k2, v2))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.gpu
def test_lm_step_int8_conversion_is_exact(cuda):
    """K6's int8 -> fp32 conversion (byte permutes into a float's mantissa,
    no I2F) on all 256 byte values, at each of the four bytes of a word."""
    v = torch.arange(-128, 128, dtype=torch.int8, device=cuda)
    for shift in range(4):
        t = torch.roll(v, shift)
        assert torch.equal(K6.int8_to_float(t), t.float())


@pytest.mark.gpu
# fp32: the two differ only in the order of fp32 sums.  bf16: both round at
# the TPU kernel's points, but a sum taken in another order (or p rounded
# against the online softmax's running max) can land on the other side of a
# bf16 rounding boundary, so the attention output o and the residual sums x1
# and y may each differ by one bf16 ulp: max |kernel - plain| <= two bf16 ulps
# at max |plain|, for y and, on its own, for o (y is dominated by the
# residual, so an attention fault could hide in it).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim,heads,T,lens", [
    (128, 2, 256, [200, 256, 100, 0]), (256, 8, 256, [200, 256, 100, 0]),
    (256, 8, 600, [600, 0, 1, 333]),
    (256, 8, 640, [640, 0, 1] + [640 - 40 * i for i in range(1, 14)])],
    ids=["dim128", "dim256", "ragged_T600", "serving_16x640"])
def test_dit_block_matches_plain(cuda, dtype, dim, heads, T, lens):
    """K4 at ragged shapes: lengths with a full row, short rows, a length-1
    row and a length-0 row (whose attention output must be all zeros), T not
    a multiple of 64, and the batched phase's [16, 640, 256] serving shape;
    every row of y and of the attention output compared, all values
    finite."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(len(lens), T, dim, generator=g, device=cuda).to(dtype)
    w = K4.random_block_weights(dim, heads, 64, 4 * dim, dtype, g, cuda)
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    kw = dict(sm_scale=0.125, heads=heads, head_dim=64, return_attention=True)
    got = K4.dit_block_fused(x, lens, *w, **kw)
    want = K4.dit_block_plain(x, lens, *w, **kw)
    for b in torch.nonzero(lens == 0).flatten():
        assert not got[1][b].any()
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)
        else:
            err, top = (a.float() - b.float()).abs().max(), float(b.float().abs().max())
            assert err <= 2 * 2.0 ** (math.floor(math.log2(top)) - 7), float(err)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["channels_last", "channels_first",
                                    "channels_first_unaligned"])
@pytest.mark.parametrize("shape,beta,logscale", [
    ((2, 700, 24), True, True), ((1, 5, 3), False, True), ((1, 130, 96), True, False),
    ((1, 1, 40), True, True), ((4, 8000, 768), True, True)],
    ids=["snakebeta", "short_snake", "linear_scale", "one_sample", "full_width_stage"])
def test_snake_aa_matches_plain(cuda, shape, beta, logscale, layout):
    """K7 against its plain version in fp32 (the sums in another order:
    ~1e-6 at these magnitudes), every sample, edges included, with x
    channels-last, channels-first (16-byte vectors where T % 4 == 0) and
    channels-first at an offset of one float (the scalar route); y has x's
    strides, and each call is one launch."""
    g = torch.Generator(device=cuda).manual_seed(4)
    B, T, C = shape
    x = torch.randn(*shape, generator=g, device=cuda)
    a, b = (torch.randn(C, generator=g, device=cuda) * 0.3 + (0.0 if logscale else 1.0)
            for _ in range(2))
    b = b if beta else None
    if layout == "channels_first":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif layout == "channels_first_unaligned":
        mem = torch.empty(B * C * T + 1, device=cuda)[1:].view(B, C, T)
        x = mem.copy_(x.transpose(1, 2)).transpose(1, 2)
    K7.launches = 0
    y = K7.snake_aa(x, a, b, logscale)
    torch.cuda.synchronize()
    assert K7.launches == 1
    assert y.stride() == x.stride()
    torch.testing.assert_close(y, K7.snake_aa_plain(x, a, b, logscale), atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
def test_snake_aa_sin2_is_sinf_bit_for_bit(cuda):
    """The kernel's branch-free copy of sinf's fast path, squared, equals
    sinf(z)^2 in every bit for every float |z| < 105615."""
    assert K7.sin2_mismatches(cuda) == 0


@pytest.mark.gpu
def test_snake_aa_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.randn(1, 64, 8, device=cuda)
    a = torch.zeros(8, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        K7.snake_aa(x.bfloat16(), a.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        K7.snake_aa(x[:, ::2], a)
    with pytest.raises(ValueError, match="contiguous"):
        K7.snake_aa(x.transpose(1, 2).contiguous().transpose(1, 2)[:, ::2], a)


@pytest.mark.gpu
def test_continuous_small_stack_gates(cuda):
    """chip_smoke.py's small-stack continuous gates: the windowed
    ContinuousSynthesizer on the card (batch_chunks on and off) against the
    same stack's sequential stream on the CPU (tokens exact, chunks within
    CONT_WAV_TOL) and the incremental one against the one-shot stream-masked
    flow (INC_WAV_TOL)."""
    import chip_smoke

    res = chip_smoke.small_continuous_checks()
    for key, g in res.items():
        assert g["max_abs_err"] <= g["tol"], (key, g)
        if key.startswith("windowed"):
            assert g["tokens_equal"] and g["chunk_samples_equal"], (key, g)


@pytest.fixture
def deterministic_cudnn():
    """cuDNN's deterministic convolutions: its default ones may give one
    call other last bits from run to run."""
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = False


@pytest.mark.gpu
def test_grouped_vocoders_equal_per_session_loop(cuda, deterministic_cudnn):
    """The grouped vocoders on the card, with HiFT source noise from each
    session's generator, equal mel2wav called session by session: exactly,
    with deterministic convolutions."""
    import chip_smoke

    model = chip_smoke.small_stack("cuda")
    model.hift.m_source.deterministic = False
    g = torch.Generator(device="cuda").manual_seed(3)
    mel = torch.randn((3, 200, 80), generator=g, device="cuda") * 0.5
    grouped = [model.new_session() for _ in range(3)]
    single = [model.new_session() for _ in range(3)]
    win = 2 * (model.token_hop_len + model.pre_lookahead_len)
    errs = []
    for step in range(2):
        starts = [50 * step, 7, 31]
        got = model.mel2wav_stream_group(mel, [0, 1, 2], starts, grouped, win_rows=win)
        want = [model.mel2wav(mel[i, s:s + win], single[i], False) for i, s in enumerate(starts)]
        errs += [float(np.abs(a - b).max()) for a, b in zip(got, want)]
    got = model.mel2wav_final_group(mel, [0, 1, 2], [10, 20, 30], [64, 45, 100], grouped)
    want = [model.mel2wav(mel[i, s:s + n], single[i], True)
            for i, (s, n) in enumerate([(10, 64), (20, 45), (30, 100)])]
    errs += [float(np.abs(a - b).max()) for a, b in zip(got, want)]
    assert max(errs) == 0.0, errs


@pytest.mark.gpu
def test_train_steps_card_equal_cpu(cuda):
    """chip_smoke.py's small training check: the small LM and flow (flow
    encoder dropout on) take 3 steps on the card and on the CPU from one
    init, every step's generator a CPU one (the same masks and flow draws
    on both): each step's loss within 1e-4 relative."""
    import chip_smoke

    for kind, r in chip_smoke.train_small_checks().items():
        assert r["ok"], (kind, r)


@pytest.mark.gpu
def test_bigvgan_training_forward_refuses_k7(cuda):
    """A BigVGAN training forward (gradients on) with use_pallas_act reaches
    K7, which has no backward: it raises rather than hand back an output cut
    off from the graph; the same forward without K7 keeps the graph, and
    inference (deterministic) still takes K7."""
    from cosyvoice_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig

    small = dict(vocab_size=30, input_size=16, output_size=16, mel_bin=8,
                 upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
                 upsample_initial_channel=32, resblock_kernel_sizes=(3,),
                 resblock_dilation_sizes=((1, 3),), speaker_embedding_dim=8)
    g = torch.Generator(device=cuda).manual_seed(0)
    token = torch.randint(0, 30, (2, 12), generator=g, device=cuda)
    lens = torch.tensor([12, 9], device=cuda)
    spk = torch.randn(2, 8, generator=g, device=cuda)
    with torch.enable_grad():
        torch.manual_seed(0)
        model = BigVGAN(BigVGANConfig(**small, use_pallas_act=True)).to(cuda).train()
        with pytest.raises(RuntimeError, match="no backward"):
            model(token, lens, spk, deterministic=False)
        plain = BigVGAN(BigVGANConfig(**small)).to(cuda).train()
        plain.load_state_dict(model.state_dict())
        wav, _ = plain(token, lens, spk, deterministic=False)
        assert wav.requires_grad
    before = K7.launches
    wav_k7, _ = model(token, lens, spk)
    assert K7.launches > before and not wav_k7.requires_grad


@pytest.mark.gpu
def test_phoneme_training_losses_card_equal_cpu(cuda):
    """chip_smoke.py's pho_train small checks: the Src2 phoneme LM's loss
    and acc, the multi-code focal loss and TransformerLMPhonemeWithSpk's
    loss with VICReg (SpecAugment masks and posterior samples pinned), one
    seeded init on the card and on the CPU: within PHO_TRAIN_SMALL_TOL (1e-4)
    relative."""
    import chip_smoke

    with torch.enable_grad():
        for kind, r in chip_smoke.pho_train_small_checks().items():
            assert r["ok"], (kind, r)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 2e-5, 2e-5),
                                             (torch.bfloat16, 1e-4, 2.0 ** -7)])
@pytest.mark.parametrize("B,pos", [(1, (0,)), (1, (364,)), (1, (383,)),
                                   (8, (100, 140, 180, 220, 260, 300, 340, 380))])
def test_lm_decode_attention_tensor_parallel_heads(cuda, dtype, atol, rtol, B, pos):
    """K1 at Qwen2-0.5B's local heads under tensor parallelism at model 2
    (one KV head, G = 7: KH * D = 64), cache 384, at B = 1 and at B = 8
    with per-row frontiers: the output and the appended cache equal the
    plain version's."""
    g = torch.Generator(device=cuda).manual_seed(18)
    r = lambda *s: torch.randn(*s, generator=g, device=cuda).to(dtype)
    ck, cv = r(B, 384, 64), r(B, 384, 64)
    ck2, cv2 = ck.clone(), cv.clone()
    bias = torch.where(torch.rand(B, 384, generator=g, device=cuda) < 0.1, -1e9, 0.0)
    p = torch.tensor(pos, dtype=torch.int32, device=cuda)
    q, kn, vn = r(B, 7, 64), r(B, 1, 64), r(B, 1, 64)
    o, _, _ = K1.lm_decode_attention(q, kn, vn, ck, cv, bias, p, 64, 0.125)
    o_ref, _, _ = K1.lm_decode_attention_plain(q, kn, vn, ck2, cv2, bias, p, 64, 0.125)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=atol, rtol=rtol)
    assert torch.equal(ck, ck2) and torch.equal(cv, cv2)


@pytest.mark.gpu
def test_continuous_flow_on_the_cpu(cuda):
    """chip_smoke.py's flow_device split: the small stack's
    ContinuousSynthesizer with the LM on the card and copies of the flow and
    HiFT on the CPU, against the all-card run (CONT_WAV_TOL); the model then
    serves all on the card again."""
    import chip_smoke

    res = chip_smoke.mc_flow_device()
    assert res["ok"], res
