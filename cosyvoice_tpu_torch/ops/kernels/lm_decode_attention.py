"""Single-token GQA decode attention over a packed KV cache, appending the new
token's K/V in place (the LM decode step under `fused_cache_update`).

`lm_decode_attention` launches the split-key CUDA kernel in
`csrc/lm_decode_attention.cu` for CUDA tensors (one launch; the wrapper owns
its scratch and counters, one set per device and stream) and runs
`lm_decode_attention_plain`, the same function in plain PyTorch, for CPU
tensors.  Port of cosyvoice_tpu/ops/pallas/lm_decode_attention.py.
"""
from __future__ import annotations

import torch

from cosyvoice_tpu_torch.ops.kernels import build

# kernel launches so far (plain integer; callers may reset it to 0)
launches = 0
# keys a block of the split kernel takes (csrc/lm_decode_attention.cu kChunk)
CHUNK = 32
# the split kernel's scratch, per (device, raw stream) (build.scratch_for):
# counters [B*KH] and fp32 partials
_scratch: dict = {}


def _pos_vector(pos, B: int, device) -> torch.Tensor:
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        if pos.shape != (B,):
            raise ValueError(f"pos must be a scalar or [B={B}], got {tuple(pos.shape)}")
        if pos.dtype == torch.int32 and pos.device == device:
            return pos
        return pos.to(device=device, dtype=torch.int32)
    return torch.full((B,), int(pos), dtype=torch.int32, device=device)


def lm_decode_attention_plain(q, k_new, v_new, ck, cv, bias_row, pos, head_dim: int,
                              sm_scale: float):
    """Plain version; shapes and semantics as `lm_decode_attention`."""
    B, G, KHD = q.shape
    T = ck.shape[1]
    KH, D = KHD // head_dim, head_dim
    pos = _pos_vector(pos, B, q.device)
    qh = q.float().reshape(B, G, KH, D)
    s = torch.einsum("bgkd,btkd->bkgt", qh, ck.float().reshape(B, T, KH, D)) * sm_scale
    s = s + bias_row.float()[:, None, None, :]
    live = torch.arange(T, device=q.device)[None, :] < pos[:, None]
    s = s.masked_fill(~live[:, None, None, :], float("-inf"))
    s_self = torch.einsum("bgkd,bkd->bkg", qh,
                          k_new.float().reshape(B, KH, D)) * sm_scale
    # exact softmax over the cached keys plus the new token (always finite)
    p = torch.softmax(torch.cat([s, s_self[..., None]], dim=-1), dim=-1)
    o = torch.einsum("bkgt,btkd->bgkd", p[..., :T], cv.float().reshape(B, T, KH, D))
    o = o + (p[..., T][..., None] * v_new.float().reshape(B, KH, 1, D)).transpose(1, 2)
    rows = torch.nonzero((pos >= 0) & (pos < T)).flatten()
    ck[rows, pos[rows].long()] = k_new[rows, 0].to(ck.dtype)
    cv[rows, pos[rows].long()] = v_new[rows, 0].to(cv.dtype)
    return o.reshape(B, G, KHD).to(q.dtype), ck, cv


def lm_decode_attention(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                        ck: torch.Tensor, cv: torch.Tensor, bias_row: torch.Tensor,
                        pos, head_dim: int, sm_scale: float):
    """One GQA decode-attention step over a packed cache, appending in place.

    q        [B, G, KH*D]  query heads grouped KV-head-major (G = H // KH):
                           q[b, g, kh*D:(kh+1)*D] is query head kh*G + g
    k_new    [B, 1, KH*D]  this step's K/V, written to the cache at pos
    v_new    [B, 1, KH*D]
    ck, cv   [B, T, KH*D]  cache buffers, UPDATED IN PLACE at row pos[b]
    bias_row [B, T] f32    additive key bias (0 valid / -1e9 pad)
    pos      int or int32 [B]: keys j < pos[b] plus the new token attend
    returns (o [B, G, KH*D], ck, cv)
    """
    global launches
    B, G, KHD = q.shape
    T = ck.shape[1]
    if (KHD % head_dim or k_new.shape != (B, 1, KHD) or v_new.shape != (B, 1, KHD)
            or ck.shape != (B, T, KHD) or cv.shape != (B, T, KHD)
            or bias_row.shape != (B, T)):
        raise ValueError("lm_decode_attention: inconsistent shapes "
                         f"q{tuple(q.shape)} k_new{tuple(k_new.shape)} "
                         f"ck{tuple(ck.shape)} bias{tuple(bias_row.shape)}")
    if q.device.type == "cpu":
        return lm_decode_attention_plain(q, k_new, v_new, ck, cv, bias_row, pos,
                                         head_dim, sm_scale)
    pos = _pos_vector(pos, B, q.device)
    build.require_cuda("lm_decode_attention", q, k_new, v_new, ck, cv, bias_row, pos)
    if not (q.dtype == k_new.dtype == v_new.dtype == ck.dtype == cv.dtype):
        raise TypeError("lm_decode_attention: q, k_new, v_new and the cache must "
                        "share one dtype")
    if bias_row.dtype != torch.float32:
        raise TypeError("lm_decode_attention: bias_row must be float32")
    if head_dim != 64 or G > 16:
        raise ValueError(f"lm_decode_attention: kernel takes head_dim 64 and "
                         f"G <= 16, got head_dim={head_dim} G={G}")
    ptrs = [t.data_ptr() for t in (q, k_new, v_new, ck, cv, bias_row, pos)]
    if ptrs[0] % 16 or ptrs[3] % 16 or ptrs[4] % 16:
        raise ValueError("lm_decode_attention: q and the cache must be 16-byte aligned")
    KH = KHD // head_dim
    stream = build.stream_of(q)
    counters, work = build.scratch_for(_scratch, q.device, stream, B * KH,
                                       B * KH * -(-T // CHUNK) * G * (head_dim + 2))
    out = torch.empty_like(q)
    rc = build.library().cvt_lm_decode_attention(
        *ptrs, out.data_ptr(), work.data_ptr(), counters.data_ptr(), B, G, KH, head_dim,
        T, float(sm_scale), build.dtype_code(q), stream)
    build.check_launch(rc, "lm_decode_attention")
    launches += 1
    return out, ck, cv
