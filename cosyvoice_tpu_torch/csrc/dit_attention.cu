// Non-causal multi-head self-attention with per-row prefix key lengths, for
// the DiT blocks of the flow estimator.
//
// Replaces: cosyvoice_tpu/ops/pallas/dit_attention.py::dit_attention_packed
// and ::dit_attention (one Pallas _kernel), and the library TPU
// flash_attention that cosyvoice_tpu/models/flow.py:188-220 falls back to for
// unaligned T: this kernel takes any T and masks the ragged edge itself.
//
// Bound on the H100: at the balance point.  A batch row does 4 * H * T * L * D
// flops and must move (2 * T + 2 * L) * H * D elements (q and out over all T
// rows, k and v over the L live rows only), so in bf16 it does
// T * L / (T + L) flops per byte against the card's 989 TF/s / 3.35 TB/s ~ 295.
// It is bound by operations once T * L / (T + L) > 295 (T ~ L > 590) and by
// bytes below; the main path's shapes (T ~ 640 padded, L ~ 550) sit within a
// few percent of the balance point (0.0015 ms at [2, 640], L = 550).
//
// bf16: a FlashAttention-2 loop on the tensor cores.  A block of 4 warps owns
// 64 query rows of one (batch row, head), 16 rows a warp; the grid is
// (ceil(T / 64), H, B).  q, k and v are read straight out of the packed
// [B, T, 3*H*D] projection (or three [B, T, H*D] tensors) through row and
// batch strides, no copies.  One head's row is 128 bytes: 64-key K/V tiles
// are copied into shared memory 16 bytes a thread with cp.async, two tiles in
// flight (the next one loads while the warps work on this one), rows padded by
// 8 bf16 so ldmatrix reads are free of bank conflicts.  Keys at
// j >= lengths[b] are never loaded (cp.async zero-fills those rows) and are
// masked to -inf in the ragged last tile.  S = q k^T runs on mma.sync
// m16n8k16 with q's A fragments (ldmatrix.x4) kept in registers and K's B
// fragments read by ldmatrix.x4; the softmax is an online exp2 softmax in
// fp32 on the score accumulators, and those accumulators, rounded to bf16,
// are the A fragments of o += p v (V's B fragments by ldmatrix.x4.trans).
// Rounding points are the TPU kernel's: q * (sm_scale * log2 e) and p rounded
// to bf16, fp32 accumulators, l summed over the unrounded p.  p is rounded
// against the running max (the plain version: the row max), so the two may
// round a p apart (<= 1 bf16 ulp of o).  The TPU kernel skipped the max
// subtraction and clamped exp2 at 108; the two agree wherever that clamp does
// not bind.  A row with lengths[b] == 0 has no keys and returns zeros, as the
// TPU kernel's floored divide does; query rows past T are never written.
// wgmma/TMA tiles and a persistent grid are the next steps for speed.  The
// launcher is declared in dit_attention.cuh: K4 (dit_block.cu) runs its
// attention phase through this kernel.
//
// fp32: the SIMT kernel below (exact fp32, no tensor cores): each block keeps
// 32 query rows in shared memory and streams 64-key tiles through it.

#include "common.cuh"
#include "dit_attention.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------- fp32 path

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBK = 64;                      // key rows per tile (2 per lane)

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
dit_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     const int* __restrict__ lengths, int T_len,
                     long long in_bstride, long long in_rstride,
                     long long out_bstride, long long out_rstride, float qscale) {
  constexpr int DPL = D / 32;
  __shared__ float q_s[kBQ][D];
  __shared__ float k_s[kBK][D + 1];
  __shared__ float v_s[kBK][D];

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = min(max(lengths[b], 0), T_len);
  const T* qb = q + b * in_bstride + h * D;
  const T* kb = k + b * in_bstride + h * D;
  const T* vb = v + b * in_bstride + h * D;

  for (int idx = tid; idx < kBQ * D; idx += blockDim.x) {
    const int r = idx / D, d = idx % D;
    const int t = q0 + r;
    q_s[r][d] = t < T_len ? to_float(qb[t * in_rstride + d]) * qscale : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  for (int j0 = 0; j0 < L; j0 += kBK) {
    __syncthreads();                         // previous tile fully consumed
    for (int idx = tid; idx < kBK * D; idx += blockDim.x) {
      const int jj = idx / D, d = idx % D;
      const int j = j0 + jj;
      float kv = 0.f, vv = 0.f;
      if (j < L) {
        kv = to_float(kb[j * in_rstride + d]);
        vv = to_float(vb[j * in_rstride + d]);
      }
      k_s[jj][d] = kv;
      v_s[jj][d] = vv;
    }
    __syncthreads();
    const bool ok0 = j0 + lane < L, ok1 = j0 + lane + 32 < L;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp * kRowsPerWarp + r;
      if (q0 + row >= T_len) continue;       // uniform across the warp
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float qd = q_s[row][d];
        s0 += qd * k_s[lane][d];
        s1 += qd * k_s[lane + 32][d];
      }
      s0 = ok0 ? s0 : -INFINITY;
      s1 = ok1 ? s1 : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s0, s1)));
      const float corr = exp2f(m[r] - m_new);
      const float p0 = exp2f(s0 - m_new), p1 = exp2f(s1 - m_new);
      l[r] = l[r] * corr + warp_sum(p0 + p1);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= corr;
#pragma unroll 8
      for (int kk = 0; kk < 32; ++kk) {
        const float pa = __shfl_sync(0xffffffffu, p0, kk);
        const float pb = __shfl_sync(0xffffffffu, p1, kk);
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          acc[r][i] += pa * v_s[kk][lane + 32 * i] + pb * v_s[kk + 32][lane + 32 * i];
      }
      m[r] = m_new;
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = q0 + warp * kRowsPerWarp + r;
    if (t >= T_len) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    T* o = out + b * out_bstride + t * out_rstride + h * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i) o[lane + 32 * i] = from_float<T>(acc[r][i] * inv);
  }
}

// ---------------------------------------------------------------- bf16 path

constexpr int kHD = 64;                       // head_dim
constexpr int kTcWarps = 4;
constexpr int kTcBQ = 16 * kTcWarps;          // query rows per block
constexpr int kTcBK = 64;                     // keys per tile
constexpr int kLd = kHD + 8;                  // padded shared-memory row (144 bytes)

// Fragment layout of m16n8k16 (lane = 4 g + t): A rows g and g + 8, columns
// 2t, 2t + 1 (+ 8); B column g, rows 2t, 2t + 1 (+ 8); C rows g and g + 8,
// columns 2t, 2t + 1.
__global__ void __launch_bounds__(kTcWarps * 32)
dit_attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ out,
                        const int* __restrict__ lengths, int T_len, long long in_bstride,
                        long long in_rstride, long long out_bstride, long long out_rstride,
                        float qscale) {
  __shared__ __align__(16) bf16 q_s[kTcBQ][kLd];
  __shared__ __align__(16) bf16 k_s[2][kTcBK][kLd];
  __shared__ __align__(16) bf16 v_s[2][kTcBK][kLd];
  const int q0 = blockIdx.x * kTcBQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int L = min(max(lengths[b], 0), T_len);
  const bf16* qb = q + b * in_bstride + h * kHD;
  const bf16* kb = k + b * in_bstride + h * kHD;
  const bf16* vb = v + b * in_bstride + h * kHD;

  // one 64-key K/V tile into buffer buf: 8 pieces of 16 bytes a row
  auto load_tile = [&](int j0, int buf) {
    for (int idx = tid; idx < kTcBK * kHD / 8; idx += kTcWarps * 32) {
      const int jj = idx >> 3, c = 8 * (idx & 7), j = j0 + jj;
      const bool live = j < L;
      const long long off = live ? j * in_rstride + c : 0;
      cp_async16(&k_s[buf][jj][c], kb + off, live);
      cp_async16(&v_s[buf][jj][c], vb + off, live);
    }
    cp_async_commit();
  };
  const int n_tiles = (L + kTcBK - 1) / kTcBK;
  if (n_tiles > 0) load_tile(0, 0);

  // q * (sm_scale * log2 e), rounded to bf16 (the TPU kernel's rounding point)
  for (int idx = tid; idx < kTcBQ * kHD / 8; idx += kTcWarps * 32) {
    const int r = idx >> 3, c = 8 * (idx & 7), tt = q0 + r;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (tt < T_len) raw = *reinterpret_cast<const uint4*>(qb + tt * in_rstride + c);
    const bf16* x = reinterpret_cast<const bf16*>(&raw);
    __align__(16) bf16 y[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) y[i] = __float2bfloat16(__bfloat162float(x[i]) * qscale);
    *reinterpret_cast<uint4*>(&q_s[r][c]) = *reinterpret_cast<const uint4*>(y);
  }
  __syncthreads();
  uint32_t qa[kHD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kHD / 16; ++kk)
    ldsm_x4(qa[kk], &q_s[16 * warp + (lane & 15)][16 * kk + 8 * (lane >> 4)]);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, acc[kHD / 8][4] = {};
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1, j0 = it * kTcBK;
    if (it + 1 < n_tiles) {
      load_tile(j0 + kTcBK, buf ^ 1);          // the next tile flies meanwhile
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                           // tile `it` is in shared memory

    // S = q k^T for this warp's 16 rows x 64 keys; key 8 ni + g of the tile
    float s[kTcBK / 8][4] = {};
#pragma unroll
    for (int ni = 0; ni < kTcBK / 8; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {   // head dims 32 half .. 32 half + 31
        uint32_t kf[4];
        ldsm_x4(kf, &k_s[buf][8 * ni + (lane & 7)][32 * half + 8 * (lane >> 3)]);
        mma16816(s[ni], qa[2 * half], kf[0], kf[1]);
        mma16816(s[ni], qa[2 * half + 1], kf[2], kf[3]);
      }
    // rows g (s[.][0..1]) and g + 8 (s[.][2..3]); key j0 + 8 ni + 2t (+1)
    if (j0 + kTcBK > L) {                      // the ragged last tile
#pragma unroll
      for (int ni = 0; ni < kTcBK / 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j0 + 8 * ni + 2 * t + (e & 1) >= L) s[ni][e] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int ni = 0; ni < kTcBK / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[ni][e]);
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);  // finite: key j0 is live
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int ni = 0; ni < kTcBK / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[ni][e] = exp2f(s[ni][e] - m[e >> 1]);
        l[e >> 1] += s[ni][e];
      }
#pragma unroll
    for (int ni = 0; ni < kHD / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ni][e] *= corr[e >> 1];
    // o += p v: the score accumulators of keys 16 kk .. 16 kk + 15, rounded
    // to bf16, are the A fragment; V's B fragments for head dims 8 ni ..
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      const uint32_t pa[4] = {pack2(s[2 * kk][0], s[2 * kk][1]),
                              pack2(s[2 * kk][2], s[2 * kk][3]),
                              pack2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int ni = 0; ni < kHD / 8; ni += 2) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, &v_s[buf][16 * kk + (lane & 15)][8 * ni + 8 * (lane >> 4)]);
        mma16816(acc[ni], pa, vf[0], vf[1]);
        mma16816(acc[ni + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();                           // buffer `buf` free for tile it + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int tt = q0 + 16 * warp + g + 8 * r;
    if (tt >= T_len) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    bf16* o = out + b * out_bstride + tt * out_rstride + h * kHD + 2 * t;
#pragma unroll
    for (int ni = 0; ni < kHD / 8; ++ni)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * ni) =
          __floats2bfloat162_rn(acc[ni][2 * r] * inv, acc[ni][2 * r + 1] * inv);
  }
}

void launch_simt(const float* q, const float* k, const float* v, float* out,
                 const int* lengths, int B, int T_len, int H, long long in_bs, long long in_rs,
                 long long out_bs, long long out_rs, float qscale, cudaStream_t stream) {
  const dim3 grid((T_len + kBQ - 1) / kBQ, H, B);
  dit_attention_kernel<float, 64><<<grid, kWarps * 32, 0, stream>>>(
      q, k, v, out, lengths, T_len, in_bs, in_rs, out_bs, out_rs, qscale);
}

}  // namespace

void dit_attention_tc_launch(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                             const int* lengths, int B, int T_len, int H, long long in_bs,
                             long long in_rs, long long out_bs, long long out_rs, float qscale,
                             cudaStream_t stream) {
  const dim3 grid((T_len + kTcBQ - 1) / kTcBQ, H, B);
  dit_attention_tc_kernel<<<grid, kTcWarps * 32, 0, stream>>>(
      q, k, v, out, lengths, T_len, in_bs, in_rs, out_bs, out_rs, qscale);
}

// bf16: q, k and v 16-byte aligned, strides multiples of 8 (the wrapper checks).
extern "C" int cvt_dit_attention(const void* q, const void* k, const void* v, void* out,
                                 const void* lengths, int B, int T_len, int H, int D,
                                 long long in_bstride, long long in_rstride,
                                 long long out_bstride, long long out_rstride,
                                 float sm_scale, int dtype, void* stream) {
  if (D != 64) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float qscale = sm_scale * 1.4426950408889634f;  // exp -> exp2
  if (dtype == kFloat32) {
    launch_simt((const float*)q, (const float*)k, (const float*)v, (float*)out,
                (const int*)lengths, B, T_len, H, in_bstride, in_rstride, out_bstride,
                out_rstride, qscale, s);
  } else if (dtype == kBFloat16) {
    dit_attention_tc_launch((const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out,
                            (const int*)lengths, B, T_len, H, in_bstride, in_rstride,
                            out_bstride, out_rstride, qscale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
