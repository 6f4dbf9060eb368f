// One whole DiT block of the flow estimator (diffusers BasicTransformerBlock:
// LayerNorm -> packed qkv projection -> H-head self-attention with per-row
// prefix key lengths -> out projection + bias + residual -> LayerNorm ->
// tanh-GELU FFN + residual), in fp32 or bf16.
//
// Replaces: cosyvoice_tpu/ops/pallas/dit_block.py::dit_block_fused.
//
// Numerics are the TPU kernel's, one rounding point for one: LayerNorms with
// fp32 fast-variance statistics (max(E[x^2] - E[x]^2, 0), eps 1e-5) and the
// affine in fp32, each matmul accumulated in fp32 and rounded once to the
// working type, biases added in fp32 before that rounding, q scaled by
// sm_scale * log2(e) in fp32 and rounded, p rounded to the working type before
// the p @ v product, residual sums rounded once.  One deliberate difference:
// the softmax is an exact, max-subtracted online softmax where the TPU kernel
// clamped exp2 at 108 without the max (they agree wherever the clamp does not
// bind); a row with no valid keys gives zeros, like the TPU kernel's 1e-30
// floor.  Keys j >= lengths[b] are never loaded (exp2(-1e9) is exactly 0
// there).  Rows i >= lengths[b] are computed over the same keys; the caller
// masks them.
//
// Bound on the H100: operations.  A batch row of T frames does
// 2*T*dim*3*inner + 4*H*T*L*D + 2*T*inner*dim + 4*T*dim*ff flops and the call
// moves x, y and the weights once, so at the serving shape (16 CFG rows x 640
// frames, dim 256, 8 x 64 heads, ff 1024) it is ~35 GFLOP against ~11 MB:
// far above the card's 295 flops per byte in bf16.
//
// Design.  The TPU kernel held one whole batch row in VMEM (the fp32 score
// tile alone is 5.3 MB at T = 1152); a Hopper block has 227 KB of shared
// memory, and attention for a query tile needs the keys and values of every
// valid row of its batch row, so the projection of all rows must finish
// before any attention starts.  The call is three launches on one stream:
//   A. per (64-row tile, 128 qkv columns, batch row): LN1 of the rows into
//      shared memory, then their qkv columns, written to a [B, T, 3*inner]
//      scratch in the working type (the rounding point the TPU kernel has);
//   B. per (query tile, head, batch row): attention over the valid keys,
//      64-key tiles streamed through shared memory, online exp2 softmax,
//      written to an o scratch [B, T, inner] (64 queries a block in bf16,
//      32 in fp32);
//   C. per (32-row tile, batch row): o @ wo + bo + x -> x1 (kept in shared
//      memory), LN3 -> h2, then the FFN in chunks of 128 mid columns, so the
//      [32, ff] mid never sits in shared memory whole, its second product
//      accumulated in registers; y = x1 + (.. + bo2) written once.
// In bf16 every product runs on the tensor cores (mma.sync m16n8k16, bf16
// operands, fp32 accumulators): weight tiles of 64 rows are copied into shared
// memory 16 bytes a thread and read as B fragments by ldmatrix.trans, the
// activations sit there in bf16 (the rounding point the TPU kernel has), and
// attention is a flash loop whose score fragments become the p operand of
// the p @ v product in registers.  In fp32 the products stay on the SIMT
// units in full fp32: weight tiles of 32 rows in shared memory, each of the
// 256 threads owning a strip of the output tile in registers.  wgmma/TMA
// tiles are the next step for speed.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // a 16 x 16 thread grid over every output tile
constexpr int kKT = 32;        // depth of one staged weight tile
constexpr int kRowsA = 64;     // rows per block in phase A
constexpr int kColsA = 128;    // qkv columns per block in phase A
constexpr int kRowsC = 32;     // rows per block in phase C
constexpr int kFC = 128;       // FFN mid columns per chunk in phase C
constexpr int kD = 64;         // head_dim
constexpr int kBQ = 32;        // query rows per block in phase B (8 warps x 4)
constexpr int kBK = 64;        // key rows per tile in phase B (2 per lane)
constexpr float kEps = 1e-5f;
constexpr int kKT2 = 64;       // depth of one staged weight tile (tensor-core path)
constexpr int kBQ2 = 64;       // query rows per block in the tensor-core attention

using bf16 = __nv_bfloat16;

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

__device__ __forceinline__ float gelu_tanh(float v) {
  return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
}

// acc[RM][RN] += A[rows, 0:K] @ W[0:K, 0:16*RN] for this thread's strip:
// rows ty*RM + r, columns tx + 16*j.  A lies in shared memory as fp32 (row
// stride lda); W is global, row-major with row stride ldw, already offset to
// the tile's first column.  Starts with a barrier, so writes to A made before
// the call are visible, and the staging buffer w_s is free.
template <typename T, int RM, int RN>
__device__ __forceinline__ void tile_gemm(float (&acc)[RM][RN], const float* a_s, int lda,
                                          int K, const T* __restrict__ W, int ldw,
                                          float* w_s) {
  constexpr int BN = 16 * RN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  for (int k0 = 0; k0 < K; k0 += kKT) {
    __syncthreads();
    for (int idx = tid; idx < kKT * BN; idx += kThreads) {
      const int kk = idx / BN, c = idx % BN;
      w_s[idx] = to_float(W[(long long)(k0 + kk) * ldw + c]);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kKT; ++kk) {
      float a[RM], w[RN];
#pragma unroll
      for (int r = 0; r < RM; ++r) a[r] = a_s[(ty * RM + r) * lda + k0 + kk];
#pragma unroll
      for (int j = 0; j < RN; ++j) w[j] = w_s[kk * BN + tx + 16 * j];
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[r][j] = fmaf(a[r], w[j], acc[r][j]);
    }
  }
}

// dst[r, :n] = round_T(((src[r] - mean) * rstd) * g + b) for rows [0, rows),
// one warp per row, stored as D; src (float or T, shared or global memory)
// and dst may be the same buffer.
template <typename T, typename S, typename D>
__device__ __forceinline__ void layer_norm_rows(const S* src, int lds, D* dst, int ldd,
                                                int rows, int n,
                                                const float* __restrict__ g,
                                                const float* __restrict__ b) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += kThreads / 32) {
    float s = 0.f, ss = 0.f;
    for (int c = lane; c < n; c += 32) {
      const float v = to_float(src[(long long)r * lds + c]);
      s += v;
      ss += v * v;
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mean = s / n;
    const float rstd = rsqrtf(fmaxf(ss / n - mean * mean, 0.f) + kEps);
    for (int c = lane; c < n; c += 32)
      dst[r * ldd + c] = from_float<D>(
          round_to<T>((to_float(src[(long long)r * lds + c]) - mean) * rstd * g[c] + b[c]));
  }
}

// Phase A: qkv[b, t, n0:n0+128] = round_T(LN1(x[b, t]) @ wqkv[:, n0:n0+128]).
template <typename T, int DIM>
__global__ void __launch_bounds__(kThreads)
ln_qkv_kernel(const T* __restrict__ x, const float* __restrict__ g1,
              const float* __restrict__ b1, const T* __restrict__ wqkv,
              T* __restrict__ qkv, int T_len, int n_qkv) {
  extern __shared__ float smem[];
  constexpr int ldh = DIM + 1, RM = kRowsA / 16, RN = kColsA / 16;
  float* h_s = smem;                       // [kRowsA][ldh]
  float* w_s = smem + kRowsA * ldh;        // [kKT][kColsA]
  const int t0 = blockIdx.x * kRowsA, n0 = blockIdx.y * kColsA, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* xb = x + (long long)b * T_len * DIM;
  for (int idx = tid; idx < kRowsA * DIM; idx += kThreads) {
    const int r = idx / DIM, c = idx % DIM;
    h_s[r * ldh + c] = t0 + r < T_len ? to_float(xb[(long long)(t0 + r) * DIM + c]) : 0.f;
  }
  __syncthreads();
  layer_norm_rows<T>(h_s, ldh, h_s, ldh, kRowsA, DIM, g1, b1);
  float acc[RM][RN] = {};
  tile_gemm<T, RM, RN>(acc, h_s, ldh, DIM, wqkv + n0, n_qkv, w_s);
  T* out = qkv + (long long)b * T_len * n_qkv + n0;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int t = t0 + ty * RM + r;
    if (t >= T_len) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) out[(long long)t * n_qkv + tx + 16 * j] = from_float<T>(acc[r][j]);
  }
}

// Phase B: o[b, t, h*D:(h+1)*D] for 32 query rows of one head, over the keys
// j < lengths[b].  Each warp owns 4 query rows; a lane holds two keys of each
// 64-key tile and two of the 64 output columns.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ qkv, T* __restrict__ o,
                 const int* __restrict__ lengths, int T_len, int inner, float qscale) {
  constexpr int RPW = kBQ / (kThreads / 32), DPL = kD / 32;
  __shared__ float q_s[kBQ][kD];
  __shared__ float k_s[kBK][kD + 1];
  __shared__ float v_s[kBK][kD];
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = min(max(lengths[b], 0), T_len);
  const long long rs = 3LL * inner;
  const T* base = qkv + (long long)b * T_len * rs;
  const T* qb = base + h * kD;
  const T* kb = base + inner + h * kD;
  const T* vb = base + 2 * inner + h * kD;

  for (int idx = tid; idx < kBQ * kD; idx += kThreads) {
    const int r = idx / kD, d = idx % kD, t = q0 + r;
    q_s[r][d] = t < T_len ? round_to<T>(to_float(qb[t * rs + d]) * qscale) : 0.f;
  }

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  for (int j0 = 0; j0 < L; j0 += kBK) {
    __syncthreads();                         // previous tile fully consumed
    for (int idx = tid; idx < kBK * kD; idx += kThreads) {
      const int jj = idx / kD, d = idx % kD, j = j0 + jj;
      k_s[jj][d] = j < L ? to_float(kb[j * rs + d]) : 0.f;
      v_s[jj][d] = j < L ? to_float(vb[j * rs + d]) : 0.f;
    }
    __syncthreads();
    const bool ok0 = j0 + lane < L, ok1 = j0 + lane + 32 < L;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = warp * RPW + r;
      if (q0 + row >= T_len) continue;       // uniform across the warp
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        const float qd = q_s[row][d];
        s0 = fmaf(qd, k_s[lane][d], s0);
        s1 = fmaf(qd, k_s[lane + 32][d], s1);
      }
      s0 = ok0 ? s0 : -INFINITY;
      s1 = ok1 ? s1 : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s0, s1)));   // finite: key j0 is valid
      const float corr = exp2f(m[r] - m_new);
      const float p0 = exp2f(s0 - m_new), p1 = exp2f(s1 - m_new);
      l[r] = l[r] * corr + warp_sum(p0 + p1);
      // p enters the p @ v product rounded to the working type, as on the TPU
      const float p0r = round_to<T>(p0), p1r = round_to<T>(p1);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= corr;
#pragma unroll 8
      for (int kk = 0; kk < 32; ++kk) {
        const float pa = __shfl_sync(0xffffffffu, p0r, kk);
        const float pb = __shfl_sync(0xffffffffu, p1r, kk);
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          acc[r][i] += pa * v_s[kk][lane + 32 * i] + pb * v_s[kk + 32][lane + 32 * i];
      }
      m[r] = m_new;
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int t = q0 + warp * RPW + r;
    if (t >= T_len) continue;
    T* ot = o + ((long long)b * T_len + t) * inner + h * kD;
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      ot[lane + 32 * i] = from_float<T>(l[r] > 0.f ? acc[r][i] / l[r] : 0.f);
  }
}

// Phase C: y = x1 + round_T(gelu(LN3(x1) @ wi + bi) @ wo2 + bo2) with
// x1 = x + round_T(o @ wo + bo), for 32 rows of one batch row.
template <typename T, int DIM>
__global__ void __launch_bounds__(kThreads)
out_ffn_kernel(const T* __restrict__ x, const T* __restrict__ o, const T* __restrict__ wo,
               const float* __restrict__ bo, const float* __restrict__ g3,
               const float* __restrict__ b3, const T* __restrict__ wi,
               const float* __restrict__ bi, const T* __restrict__ wo2,
               const float* __restrict__ bo2, T* __restrict__ y, int T_len, int inner,
               int ff) {
  extern __shared__ float smem[];
  constexpr int RM = kRowsC / 16, RN = DIM / 16, RNF = kFC / 16;
  constexpr int ldx = DIM + 1, ldm = kFC + 1;
  const int lda = (inner > DIM ? inner : DIM) + 1;
  float* a_s = smem;                       // [kRowsC][lda]: o, then LN3(x1)
  float* x1_s = a_s + kRowsC * lda;        // [kRowsC][ldx]: x, then x1
  float* m_s = x1_s + kRowsC * ldx;        // [kRowsC][ldm]: one chunk of the FFN mid
  float* w_s = m_s + kRowsC * ldm;         // [kKT][max(DIM, kFC)]
  const int t0 = blockIdx.x * kRowsC, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* xb = x + (long long)b * T_len * DIM;
  const T* ob = o + (long long)b * T_len * inner;
  for (int idx = tid; idx < kRowsC * inner; idx += kThreads) {
    const int r = idx / inner, c = idx % inner;
    a_s[r * lda + c] = t0 + r < T_len ? to_float(ob[(long long)(t0 + r) * inner + c]) : 0.f;
  }
  for (int idx = tid; idx < kRowsC * DIM; idx += kThreads) {
    const int r = idx / DIM, c = idx % DIM;
    x1_s[r * ldx + c] = t0 + r < T_len ? to_float(xb[(long long)(t0 + r) * DIM + c]) : 0.f;
  }

  float acc[RM][RN] = {};
  tile_gemm<T, RM, RN>(acc, a_s, lda, inner, wo, DIM, w_s);
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int row = ty * RM + r, c = tx + 16 * j;
      x1_s[row * ldx + c] = round_to<T>(x1_s[row * ldx + c] + round_to<T>(acc[r][j] + bo[c]));
    }
  __syncthreads();                         // x1 complete; every read of o done
  layer_norm_rows<T>(x1_s, ldx, a_s, ldx, kRowsC, DIM, g3, b3);

#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[r][j] = 0.f;
  for (int c0 = 0; c0 < ff; c0 += kFC) {
    float mid[RM][RNF] = {};
    tile_gemm<T, RM, RNF>(mid, a_s, ldx, DIM, wi + c0, ff, w_s);
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int j = 0; j < RNF; ++j) {
        const int c = tx + 16 * j;
        m_s[(ty * RM + r) * ldm + c] = round_to<T>(gelu_tanh(mid[r][j] + bi[c0 + c]));
      }
    tile_gemm<T, RM, RN>(acc, m_s, ldm, kFC, wo2 + (long long)c0 * DIM, DIM, w_s);
  }

  T* yb = y + (long long)b * T_len * DIM;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int row = ty * RM + r, t = t0 + row;
    if (t >= T_len) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int c = tx + 16 * j;
      yb[(long long)t * DIM + c] =
          from_float<T>(x1_s[row * ldx + c] + round_to<T>(acc[r][j] + bo2[c]));
    }
  }
}

// ---------------------------------------------------------------- bf16 path

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void store2(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

// acc[mi][ni] += A[r0 + 16 mi .., 0:K] @ B[0:K, n0 + 8 ni ..] for one warp,
// A [m][k] and B [k][n] bf16 in shared memory (row strides lda, ldb).
// Fragment layout of m16n8k16: lane = 4 g + t; A rows g and g + 8, columns
// 2t, 2t + 1 (+ 8); B column g, rows 2t, 2t + 1 (+ 8), read transposed by
// ldmatrix; C rows g and g + 8, columns 2t, 2t + 1.
template <int MI, int NI>
__device__ __forceinline__ void warp_mma(float (&acc)[MI][NI][4], const bf16* A, int lda,
                                         int r0, const bf16* B, int ldb, int n0, int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k = 0; k < K; k += 16) {
    uint32_t a[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const bf16* p = A + (r0 + 16 * mi + g) * lda + k + 2 * t;
      a[mi][0] = ld32(p);
      a[mi][1] = ld32(p + 8 * lda);
      a[mi][2] = ld32(p + 8);
      a[mi][3] = ld32(p + 8 * lda + 8);
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      uint32_t b0, b1;
      ldsm_x2_trans(b0, b1, B + (k + (lane & 15)) * ldb + n0 + 8 * ni);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) mma16816(acc[mi][ni], a[mi], b0, b1);
    }
  }
}

// Block-wide: each warp's acc += A[its rows, 0:K] @ W[0:K, its columns].  W
// is global [K, ldw] row-major (16-byte aligned rows), offset to the block's
// first column; BN of its columns are copied per 64-row step into w_s
// ([k][n], row stride BN + 8), 16 bytes a thread.  Starts with a barrier, so
// writes to A made before the call are visible, and w_s is free.
template <int MI, int NI, int BN>
__device__ __forceinline__ void block_mma(float (&acc)[MI][NI][4], const bf16* A, int lda,
                                          int K, const bf16* __restrict__ W, int ldw,
                                          bf16* w_s, int r0, int n0) {
  constexpr int ldb = BN + 8;
  for (int k0 = 0; k0 < K; k0 += kKT2) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kKT2 * BN / 8; idx += kThreads) {
      const int kk = idx / (BN / 8), c = 8 * (idx % (BN / 8));
      *reinterpret_cast<uint4*>(w_s + kk * ldb + c) =
          *reinterpret_cast<const uint4*>(W + (long long)(k0 + kk) * ldw + c);
    }
    __syncthreads();
    warp_mma<MI, NI>(acc, A + k0, lda, r0, w_s, ldb, n0, kKT2);
  }
}

// Phase A in bf16: LN1 of 64 rows straight from x into shared memory (bf16),
// then their 128 qkv columns; warp (wr, wc) owns rows 32 wr.., columns 32 wc..
template <int DIM>
__global__ void __launch_bounds__(kThreads)
ln_qkv_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ g1,
                 const float* __restrict__ b1, const bf16* __restrict__ wqkv,
                 bf16* __restrict__ qkv, int T_len, int n_qkv) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int ldh = DIM + 8;
  bf16* h_s = reinterpret_cast<bf16*>(smem_raw);    // [kRowsA][ldh]
  bf16* w_s = h_s + kRowsA * ldh;                   // [kKT2][kColsA + 8]
  const int t0 = blockIdx.x * kRowsA, n0 = blockIdx.y * kColsA, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp / 4, wc = warp % 4;
  const int rows = min(kRowsA, T_len - t0);
  for (int idx = threadIdx.x; idx < (kRowsA - rows) * ldh; idx += kThreads)
    h_s[rows * ldh + idx] = __float2bfloat16(0.f);
  layer_norm_rows<bf16>(x + ((long long)b * T_len + t0) * DIM, DIM, h_s, ldh, rows, DIM,
                        g1, b1);
  float acc[2][4][4] = {};
  block_mma<2, 4, kColsA>(acc, h_s, ldh, DIM, wqkv + n0, n_qkv, w_s, 32 * wr, 32 * wc);
  bf16* out = qkv + (long long)b * T_len * n_qkv + n0 + 32 * wc + 2 * t;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tt = t0 + 32 * wr + 16 * mi + g + 8 * h;
      if (tt >= T_len) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        store2(out + (long long)tt * n_qkv + 8 * ni, acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
    }
}

// Phase B in bf16: flash attention for 64 query rows of one head (4 warps x
// 16 rows).  S = q k^T and o += p v run on the tensor cores; each score tile's
// accumulators are the A fragments of the p @ v product (p rounded to bf16).
__global__ void __launch_bounds__(128)
attention_tc_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ o,
                    const int* __restrict__ lengths, int T_len, int inner, float qscale) {
  constexpr int ld = kD + 8;
  __shared__ __align__(16) bf16 q_s[kBQ2][ld];
  __shared__ __align__(16) bf16 k_s[kBK][ld];
  __shared__ __align__(16) bf16 v_s[kBK][ld];
  const int q0 = blockIdx.x * kBQ2, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int L = min(max(lengths[b], 0), T_len);
  const long long rs = 3LL * inner;
  const bf16* base = qkv + (long long)b * T_len * rs + h * kD;

  for (int idx = tid; idx < kBQ2 * kD / 8; idx += 128) {    // 8 values a thread
    const int r = idx / (kD / 8), c = 8 * (idx % (kD / 8)), tt = q0 + r;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (tt < T_len) raw = *reinterpret_cast<const uint4*>(base + tt * rs + c);
    const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) q_s[r][c + i] = __float2bfloat16(__bfloat162float(v[i]) * qscale);
  }
  __syncthreads();
  uint32_t qa[kD / 16][4];
  const int r0 = 16 * warp + g;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    qa[kk][0] = ld32(&q_s[r0][16 * kk + 2 * t]);
    qa[kk][1] = ld32(&q_s[r0 + 8][16 * kk + 2 * t]);
    qa[kk][2] = ld32(&q_s[r0][16 * kk + 2 * t + 8]);
    qa[kk][3] = ld32(&q_s[r0 + 8][16 * kk + 2 * t + 8]);
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, acc[kD / 8][4] = {};
  for (int j0 = 0; j0 < L; j0 += kBK) {
    __syncthreads();                                   // previous tile consumed
    for (int idx = tid; idx < kBK * kD / 8; idx += 128) {
      const int jj = idx / (kD / 8), c = 8 * (idx % (kD / 8)), j = j0 + jj;
      uint4 kr = make_uint4(0, 0, 0, 0), vr = make_uint4(0, 0, 0, 0);
      if (j < L) {
        kr = *reinterpret_cast<const uint4*>(base + inner + j * rs + c);
        vr = *reinterpret_cast<const uint4*>(base + 2 * inner + j * rs + c);
      }
      *reinterpret_cast<uint4*>(&k_s[jj][c]) = kr;
      *reinterpret_cast<uint4*>(&v_s[jj][c]) = vr;
    }
    __syncthreads();
    float s[kBK / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
#pragma unroll
      for (int ni = 0; ni < kBK / 8; ++ni)
        mma16816(s[ni], qa[kk], ld32(&k_s[8 * ni + g][16 * kk + 2 * t]),
                 ld32(&k_s[8 * ni + g][16 * kk + 2 * t + 8]));
    // rows g (s[.][0..1]) and g + 8 (s[.][2..3]); key j0 + 8 ni + 2t (+1)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int ni = 0; ni < kBK / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (j0 + 8 * ni + 2 * t + (e & 1) >= L) s[ni][e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[ni][e]);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);          // finite: key j0 is valid
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int ni = 0; ni < kBK / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[ni][e] = exp2f(s[ni][e] - m[e >> 1]);
        l[e >> 1] += s[ni][e];
      }
#pragma unroll
    for (int ni = 0; ni < kD / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ni][e] *= corr[e >> 1];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack2(s[2 * kk][0], s[2 * kk][1]),
                              pack2(s[2 * kk][2], s[2 * kk][3]),
                              pack2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int ni = 0; ni < kD / 8; ++ni) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, &v_s[16 * kk + (lane & 15)][8 * ni]);
        mma16816(acc[ni], pa, b0, b1);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int tt = q0 + r0 + 8 * r;
    if (tt >= T_len) continue;
    bf16* ot = o + ((long long)b * T_len + tt) * inner + h * kD + 2 * t;
#pragma unroll
    for (int ni = 0; ni < kD / 8; ++ni)
      store2(ot + 8 * ni, l[r] > 0.f ? acc[ni][2 * r] / l[r] : 0.f,
             l[r] > 0.f ? acc[ni][2 * r + 1] / l[r] : 0.f);
  }
}

// Phase C in bf16: as out_ffn_kernel, with warp (wr, wc) owning rows 16 wr..
// and a quarter of each product's columns.
template <int DIM>
__global__ void __launch_bounds__(kThreads)
out_ffn_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ o,
                  const bf16* __restrict__ wo, const float* __restrict__ bo,
                  const float* __restrict__ g3, const float* __restrict__ b3,
                  const bf16* __restrict__ wi, const float* __restrict__ bi,
                  const bf16* __restrict__ wo2, const float* __restrict__ bo2,
                  bf16* __restrict__ y, int T_len, int inner, int ff) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int ldx = DIM + 1, ldh = DIM + 8, ldm = kFC + 8, NO = DIM / 32, WO = DIM / 4;
  const int lda = inner + 8;
  bf16* a_s = reinterpret_cast<bf16*>(smem_raw);    // [kRowsC][max(lda, ldh)]: o, then h2
  float* x1_s = reinterpret_cast<float*>(a_s + kRowsC * (lda > ldh ? lda : ldh));
  bf16* m_s = reinterpret_cast<bf16*>(x1_s + kRowsC * ldx);   // [kRowsC][ldm]
  bf16* w_s = m_s + kRowsC * ldm;                   // [kKT2][max(DIM, kFC) + 8]
  const int t0 = blockIdx.x * kRowsC, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp / 4, wc = warp % 4;
  const bf16* xb = x + (long long)b * T_len * DIM;
  const bf16* ob = o + (long long)b * T_len * inner;
  for (int idx = threadIdx.x; idx < kRowsC * inner / 8; idx += kThreads) {
    const int r = idx / (inner / 8), c = 8 * (idx % (inner / 8));
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (t0 + r < T_len) raw = *reinterpret_cast<const uint4*>(ob + (long long)(t0 + r) * inner + c);
    *reinterpret_cast<uint4*>(a_s + r * lda + c) = raw;
  }
  for (int idx = threadIdx.x; idx < kRowsC * DIM; idx += kThreads) {
    const int r = idx / DIM, c = idx % DIM;
    x1_s[r * ldx + c] = t0 + r < T_len ? __bfloat162float(xb[(long long)(t0 + r) * DIM + c]) : 0.f;
  }

  float acc[1][NO][4] = {};
  block_mma<1, NO, DIM>(acc, a_s, lda, inner, wo, DIM, w_s, 16 * wr, WO * wc);
#pragma unroll
  for (int ni = 0; ni < NO; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * wr + g + 8 * (e >> 1), c = WO * wc + 8 * ni + 2 * t + (e & 1);
      x1_s[row * ldx + c] =
          round_to<bf16>(x1_s[row * ldx + c] + round_to<bf16>(acc[0][ni][e] + bo[c]));
    }
  __syncthreads();                         // x1 complete; every read of o done
  layer_norm_rows<bf16>(x1_s, ldx, a_s, ldh, kRowsC, DIM, g3, b3);

#pragma unroll
  for (int ni = 0; ni < NO; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][ni][e] = 0.f;
  for (int c0 = 0; c0 < ff; c0 += kFC) {
    float mid[1][4][4] = {};
    block_mma<1, 4, kFC>(mid, a_s, ldh, DIM, wi + c0, ff, w_s, 16 * wr, 32 * wc);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * wr + g + 8 * h, c = 32 * wc + 8 * ni + 2 * t;
        store2(m_s + row * ldm + c, gelu_tanh(mid[0][ni][2 * h] + bi[c0 + c]),
               gelu_tanh(mid[0][ni][2 * h + 1] + bi[c0 + c + 1]));
      }
    block_mma<1, NO, DIM>(acc, m_s, ldm, kFC, wo2 + (long long)c0 * DIM, DIM, w_s, 16 * wr,
                          WO * wc);
  }

  bf16* yb = y + (long long)b * T_len * DIM;
#pragma unroll
  for (int ni = 0; ni < NO; ++ni)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * wr + g + 8 * h, c = WO * wc + 8 * ni + 2 * t;
      if (t0 + row >= T_len) continue;
      store2(yb + (long long)(t0 + row) * DIM + c,
             x1_s[row * ldx + c] + round_to<bf16>(acc[0][ni][2 * h] + bo2[c]),
             x1_s[row * ldx + c + 1] + round_to<bf16>(acc[0][ni][2 * h + 1] + bo2[c + 1]));
    }
}

struct BlockArgs {
  const void *x, *lengths, *g1, *b1, *wqkv, *wo, *bo, *g3, *b3, *wi, *bi, *wo2, *bo2;
  void *qkv, *o, *y;
  int B, T_len, heads, inner, ff;
  float qscale;
};

template <int DIM>
int launch_tc(const BlockArgs& a, cudaStream_t stream) {
  const size_t smem_a = (size_t)(kRowsA * (DIM + 8) + kKT2 * (kColsA + 8)) * sizeof(bf16);
  const int lda = (a.inner > DIM ? a.inner : DIM) + 8;
  const size_t smem_c = (size_t)kRowsC * lda * sizeof(bf16) +
                        (size_t)kRowsC * (DIM + 1) * sizeof(float) +
                        (size_t)(kRowsC * (kFC + 8) + kKT2 * ((DIM > kFC ? DIM : kFC) + 8)) *
                            sizeof(bf16);
  cudaError_t e = cudaFuncSetAttribute(ln_qkv_tc_kernel<DIM>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem_a);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(out_ffn_tc_kernel<DIM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_c);
  if (e != cudaSuccess) return (int)e;
  const int n_qkv = 3 * a.inner;
  ln_qkv_tc_kernel<DIM><<<dim3((a.T_len + kRowsA - 1) / kRowsA, n_qkv / kColsA, a.B),
                          kThreads, smem_a, stream>>>(
      (const bf16*)a.x, (const float*)a.g1, (const float*)a.b1, (const bf16*)a.wqkv,
      (bf16*)a.qkv, a.T_len, n_qkv);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  attention_tc_kernel<<<dim3((a.T_len + kBQ2 - 1) / kBQ2, a.heads, a.B), 128, 0, stream>>>(
      (const bf16*)a.qkv, (bf16*)a.o, (const int*)a.lengths, a.T_len, a.inner, a.qscale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  out_ffn_tc_kernel<DIM><<<dim3((a.T_len + kRowsC - 1) / kRowsC, a.B), kThreads, smem_c,
                           stream>>>(
      (const bf16*)a.x, (const bf16*)a.o, (const bf16*)a.wo, (const float*)a.bo,
      (const float*)a.g3, (const float*)a.b3, (const bf16*)a.wi, (const float*)a.bi,
      (const bf16*)a.wo2, (const float*)a.bo2, (bf16*)a.y, a.T_len, a.inner, a.ff);
  return (int)cudaGetLastError();
}

template <typename T, int DIM>
int launch_simt(const BlockArgs& a, cudaStream_t stream) {
  const size_t smem_a = (size_t)(kRowsA * (DIM + 1) + kKT * kColsA) * sizeof(float);
  const int lda = (a.inner > DIM ? a.inner : DIM) + 1;
  const size_t smem_c = (size_t)(kRowsC * (lda + DIM + 1 + kFC + 1) +
                                 kKT * (DIM > kFC ? DIM : kFC)) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(ln_qkv_kernel<T, DIM>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem_a);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(out_ffn_kernel<T, DIM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_c);
  if (e != cudaSuccess) return (int)e;
  const int n_qkv = 3 * a.inner;
  ln_qkv_kernel<T, DIM><<<dim3((a.T_len + kRowsA - 1) / kRowsA, n_qkv / kColsA, a.B),
                          kThreads, smem_a, stream>>>(
      (const T*)a.x, (const float*)a.g1, (const float*)a.b1, (const T*)a.wqkv, (T*)a.qkv,
      a.T_len, n_qkv);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  attention_kernel<T><<<dim3((a.T_len + kBQ - 1) / kBQ, a.heads, a.B), kThreads, 0, stream>>>(
      (const T*)a.qkv, (T*)a.o, (const int*)a.lengths, a.T_len, a.inner, a.qscale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  out_ffn_kernel<T, DIM><<<dim3((a.T_len + kRowsC - 1) / kRowsC, a.B), kThreads, smem_c,
                           stream>>>(
      (const T*)a.x, (const T*)a.o, (const T*)a.wo, (const float*)a.bo, (const float*)a.g3,
      (const float*)a.b3, (const T*)a.wi, (const float*)a.bi, (const T*)a.wo2,
      (const float*)a.bo2, (T*)a.y, a.T_len, a.inner, a.ff);
  return (int)cudaGetLastError();
}

}  // namespace

// Vectors (g1, b1, bo, g3, b3, bi, bo2) are fp32; x, the weights, the
// scratch buffers qkv [B, T, 3*inner], o [B, T, inner] and y share `dtype`.
// Takes head_dim 64, dim 128 or 256, inner % 128 == 0 and ff % 128 == 0.
extern "C" int cvt_dit_block(const void* x, const void* lengths, const void* g1,
                             const void* b1, const void* wqkv, const void* wo,
                             const void* bo, const void* g3, const void* b3, const void* wi,
                             const void* bi, const void* wo2, const void* bo2, void* qkv,
                             void* o, void* y, int B, int T_len, int dim, int heads,
                             int head_dim, int ff, float qscale, int dtype, void* stream) {
  const int inner = heads * head_dim;
  if (B < 1 || T_len < 1 || head_dim != kD || inner % kColsA || ff % kFC)
    return (int)cudaErrorInvalidValue;
  const BlockArgs a{x, lengths, g1, b1, wqkv, wo, bo, g3, b3, wi, bi, wo2, bo2,
                    qkv, o, y, B, T_len, heads, inner, ff, qscale};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kFloat32 && dim == 128) return launch_simt<float, 128>(a, s);
  if (dtype == kFloat32 && dim == 256) return launch_simt<float, 256>(a, s);
  if (dtype == kBFloat16 && dim == 128) return launch_tc<128>(a, s);
  if (dtype == kBFloat16 && dim == 256) return launch_tc<256>(a, s);
  return (int)cudaErrorInvalidValue;
}
