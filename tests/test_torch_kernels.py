"""The port's kernel modules on the CPU: each plain PyTorch version against
the JAX Pallas kernel run in interpret mode.  The CUDA kernels themselves are
held against these plain versions on the card (tests/test_torch_gpu.py,
chip_smoke.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cosyvoice_tpu.ops.pallas import dit_attention as jax_dit
from cosyvoice_tpu.ops.pallas import fused_norm as jax_norm
from cosyvoice_tpu.ops.pallas import lm_decode_attention as jax_lm
from cosyvoice_tpu_torch.ops.kernels import dit_attention as K2
from cosyvoice_tpu_torch.ops.kernels import fused_norm as K3
from cosyvoice_tpu_torch.ops.kernels import lm_decode_attention as K1


def _k1_inputs(seed, B=3, T=256, KH=2, G=7, D=64):
    rng = np.random.default_rng(seed)
    KHD = KH * D
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, G, KHD), (B, 1, KHD), (B, 1, KHD), (B, T, KHD), (B, T, KHD))]
    bias = np.where(rng.random((B, T)) < 0.2, -1e9, 0.0).astype(np.float32)  # pad keys
    return arrs, bias


@pytest.mark.parametrize("pos", [135, (0, 40, 255)], ids=["scalar_pos", "per_row_pos"])
def test_lm_decode_attention_plain_matches_pallas(pos):
    """fp32, 1e-5: the plain version's exact softmax vs the kernel's clamped
    un-shifted one (same ratios; the clamp never binds at these scores).
    The appended cache rows must be identical."""
    (q, kn, vn, ck, cv), bias = _k1_inputs(1)
    D = 64
    scale = 1.0 / np.sqrt(D)
    jpos = jnp.asarray(pos, jnp.int32)
    o_j, ck_j, cv_j = jax_lm.lm_decode_attention(
        *(jnp.asarray(a) for a in (q, kn, vn, ck, cv, bias)), jpos, head_dim=D,
        sm_scale=scale, interpret=True)
    tpos = torch.as_tensor(pos, dtype=torch.int32) if isinstance(pos, tuple) else pos
    ck_t, cv_t = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    o_t, ck_t, cv_t = K1.lm_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), ck_t, cv_t,
        torch.from_numpy(bias), tpos, head_dim=D, sm_scale=scale)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(ck_t.numpy(), np.asarray(ck_j))
    np.testing.assert_array_equal(cv_t.numpy(), np.asarray(cv_j))


def _bf16_ulp(v: float) -> float:
    """The spacing of bf16 numbers at magnitude v (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(v)) - 7)


@pytest.mark.parametrize("packed,dtype", [(True, "float32"), (False, "float32"),
                                          (True, "bfloat16"), (False, "bfloat16")],
                         ids=["packed", "unpacked", "packed-bf16", "unpacked-bf16"])
def test_dit_attention_plain_matches_pallas(packed, dtype):
    """fp32: 3e-5 on valid query rows.  bf16 (inputs cast to bf16 on both
    sides): one bf16 ulp at max |o| on valid rows; both round the scaled q and
    p to bf16, but p against the row max here and unshifted in the TPU kernel,
    so a p may round apart.  The length-0 row is all zeros (the TPU kernel's
    floored divide) in both."""
    rng = np.random.default_rng(2)
    B, T, H, D = 4, 256, 2, 64
    HD = H * D
    qkv = rng.standard_normal((B, T, 3 * HD)).astype(np.float32)
    lens = np.asarray([256, 200, 77, 0], np.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tq = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(tdt)
    if packed:
        want = jax_dit.dit_attention_packed(jnp.asarray(qkv, jdt), jnp.asarray(lens), 0.125,
                                            head_dim=D, interpret=True)
        got = K2.dit_attention_packed(tq(qkv), torch.from_numpy(lens), 0.125, head_dim=D)
    else:
        q, k, v = (qkv[..., i * HD:(i + 1) * HD].reshape(B, T, H, D) for i in range(3))
        want = jax_dit.dit_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                     jnp.asarray(lens), 0.125,
                                     interpret=True).reshape(B, T, HD)
        got = K2.dit_attention(tq(q), tq(k), tq(v), torch.from_numpy(lens),
                               0.125).reshape(B, T, HD)
    assert got.dtype == tdt
    want, got = np.asarray(want.astype(jnp.float32)), got.float().numpy()
    if dtype == "float32":
        for b, L in enumerate(lens):
            np.testing.assert_allclose(got[b, :L], want[b, :L], atol=3e-5, rtol=3e-5)
    else:
        valid = np.arange(T)[None, :] < lens[:, None]
        err = np.abs(got[valid] - want[valid]).max()
        assert err <= _bf16_ulp(np.abs(want[valid]).max()), err
    assert not got[3].any() and not want[3].any()


@pytest.mark.parametrize("act", ["none", "mish"])
def test_fused_layer_norm_plain_matches_pallas(act):
    """fp32, 2e-6: same fast-variance formula and op order as the kernel."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((48, 256)) * 3.0).astype(np.float32)
    scale, bias = (rng.standard_normal(256).astype(np.float32) for _ in range(2))
    want = jax_norm.fused_layer_norm(jnp.asarray(x), jnp.asarray(scale),
                                     jnp.asarray(bias), 1e-5, act=act, interpret=True)
    got = K3.fused_layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                              torch.from_numpy(bias), 1e-5, act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=2e-6)


def test_layer_norm_plain_bf16_promotes_like_flax():
    """bf16 x with bf16 params gives bf16 out; bf16 x with fp32 params fp32."""
    x = torch.randn(4, 256, generator=torch.Generator().manual_seed(0))
    w, b = torch.ones(256), torch.zeros(256)
    assert K3.fused_layer_norm(x.bfloat16(), w.bfloat16(), b.bfloat16()).dtype == torch.bfloat16
    assert K3.layer_norm_plain(x.bfloat16(), w, b).dtype == torch.float32


def test_wrappers_reject_inconsistent_shapes():
    z = lambda *s: torch.zeros(*s)
    with pytest.raises(ValueError):
        K1.lm_decode_attention(z(2, 7, 128), z(2, 1, 128), z(2, 1, 128), z(2, 64, 128),
                               z(2, 64, 128), z(2, 32), 3, 64, 0.125)
    with pytest.raises(ValueError):
        K2.dit_attention_packed(z(2, 16, 100), torch.tensor([16, 8]), 0.125, 64)
    with pytest.raises(ValueError):
        K3.fused_layer_norm(z(4, 256), z(128), z(256))
