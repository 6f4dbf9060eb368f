"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA GPU and skip without one.  They import no JAX,
so they also run where JAX is absent:
    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""
import math

import pytest
import torch

from cosyvoice_tpu_torch.ops.kernels import dit_attention as K2
from cosyvoice_tpu_torch.ops.kernels import dit_block as K4
from cosyvoice_tpu_torch.ops.kernels import fused_norm as K3
from cosyvoice_tpu_torch.ops.kernels import int4_matmul as K5
from cosyvoice_tpu_torch.ops.kernels import lm_decode_attention as K1
from cosyvoice_tpu_torch.ops.kernels import lm_step as K6
from cosyvoice_tpu_torch.ops.kernels import snake_aa as K7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
# (atol, rtol): both sides compute in fp32; fp32 outputs differ only in the
# order of the sums, bf16 outputs by at most one bf16 ulp of |y| (2**-7 |y|).
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
    o = K2.dit_attention_packed(qkv, lens, 0.125, 64)
    q3, k3, v3 = (qkv[..., i * 512:(i + 1) * 512].reshape(4, 1152, 8, 64) for i in range(3))
    o_ref = K2.dit_attention_plain(q3, k3, v3, lens, 0.125).reshape(4, 1152, 512)
    for b, L in enumerate(lens.tolist()):
        torch.testing.assert_close(o[b, :L].float(), o_ref[b, :L].float(), atol=atol, rtol=rtol)

    x, w, bb = r(2304, 256), r(256), r(256)
    for act in ("none", "mish"):
        torch.testing.assert_close(K3.fused_layer_norm(x, w, bb, 1e-5, act).float(),
                                   K3.layer_norm_plain(x, w, bb, 1e-5, act).float(),
                                   atol=atol, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 2e-5, 2e-5),
                                             (torch.bfloat16, 1e-4, 2.0 ** -7)])
def test_int4_matmul_matches_plain(cuda, dtype, atol, rtol):
    """K5 at the LM's four projection shapes, group 128, decode (1 row) and
    prefill (200 rows) sizes; same bars as above (one fp32 sum per output,
    rounded once)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    for IN, OUT in ((896, 896), (896, 128), (896, 4864), (4864, 896)):
        w = K5.pack_int4(torch.randint(-7, 8, (IN, OUT), generator=g, device=cuda))
        scale = torch.rand(IN // 128, OUT, generator=g, device=cuda) * 0.02 + 1e-3
        for rows in (1, 200):
            x = torch.randn(rows, IN, generator=g, device=cuda).to(dtype)
            torch.testing.assert_close(K5.int4_matmul(x, w, scale).float(),
                                       K5.int4_matmul_plain(x, w, scale).float(),
                                       atol=atol, rtol=rtol)


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
# fp32: the two differ only in the order of fp32 sums.  bf16: both round at
# the TPU kernel's points, but a sum taken in another order (or p rounded
# against the online softmax's running max) can land on the other side of a
# bf16 rounding boundary, so the attention output o and the residual sums x1
# and y may each differ by one bf16 ulp: max |kernel - plain| <= two bf16 ulps
# at max |plain|, for y and, on its own, for o (y is dominated by the
# residual, so an attention fault could hide in it).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim,heads", [(128, 2), (256, 8)])
def test_dit_block_matches_plain(cuda, dtype, dim, heads):
    """K4 at a small ragged shape: lengths with a full row, a short row and a
    length-0 row; every row of y and of the attention output compared, all
    values finite."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(4, 256, dim, generator=g, device=cuda).to(dtype)
    w = K4.random_block_weights(dim, heads, 64, 4 * dim, dtype, g, cuda)
    lens = torch.tensor([200, 256, 100, 0], dtype=torch.int32, device=cuda)
    kw = dict(sm_scale=0.125, heads=heads, head_dim=64, return_attention=True)
    got = K4.dit_block_fused(x, lens, *w, **kw)
    want = K4.dit_block_plain(x, lens, *w, **kw)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)
        else:
            err, top = (a.float() - b.float()).abs().max(), float(b.float().abs().max())
            assert err <= 2 * 2.0 ** (math.floor(math.log2(top)) - 7), float(err)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,beta,logscale", [
    ((2, 700, 24), True, True), ((1, 5, 3), False, True), ((1, 130, 96), True, False),
    ((1, 1, 40), True, True), ((4, 8000, 768), True, True)],
    ids=["snakebeta", "short_snake", "linear_scale", "one_sample", "full_width_stage"])
def test_snake_aa_matches_plain(cuda, shape, beta, logscale):
    """K7 against its plain version in fp32 (the sums in another order and
    sinf's rounding: ~1e-6 at these magnitudes), every sample, edges included."""
    g = torch.Generator(device=cuda).manual_seed(4)
    C = shape[-1]
    x = torch.randn(*shape, generator=g, device=cuda)
    a, b = (torch.randn(C, generator=g, device=cuda) * 0.3 + (0.0 if logscale else 1.0)
            for _ in range(2))
    b = b if beta else None
    K7.launches = 0
    y = K7.snake_aa(x, a, b, logscale)
    torch.cuda.synchronize()
    assert K7.launches == 1
    torch.testing.assert_close(y, K7.snake_aa_plain(x, a, b, logscale), atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
def test_snake_aa_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.randn(1, 64, 8, device=cuda)
    a = torch.zeros(8, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        K7.snake_aa(x.bfloat16(), a.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        K7.snake_aa(x[:, ::2], a)
