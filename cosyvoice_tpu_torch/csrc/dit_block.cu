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
//   A. LN1 of a row tile into shared memory, then its qkv columns, written
//      to a [B, T, 3*inner] scratch in the working type (the rounding point
//      the TPU kernel has);
//   B. attention over the valid keys into an o scratch [B, T, inner];
//   C. per (row tile, batch row): o @ wo + bo + x -> x1 (kept in shared
//      memory), LN3 -> h2, then the FFN in chunks of 128 mid columns, so the
//      [rows, ff] mid never sits in shared memory whole, its second product
//      accumulated in registers; y = x1 + (.. + bo2) written once.
// bf16 (the serving route), on the tensor cores (mma.sync m16n8k16, bf16
// operands, fp32 accumulators, ldmatrix fragments):
//   A. a block per (64 rows, 384 qkv columns, batch row): LN1 once into
//      shared memory, the columns in chunks of 128;
//   B. K2's kernel (dit_attention.cu, declared in dit_attention.cuh) on the
//      packed qkv scratch through its strides: one attention kernel in the
//      port;
//   C. a block of 12 warps per (96 rows, batch row): one wave at the
//      serving shape; x1 stays in shared memory in bf16 (it is
//      bf16-valued), each warp owns 32 rows x a quarter of a product's
//      columns, so each B fragment feeds two products.
// In A and C every weight slab (64 input rows) streams through a ring of
// two shared-memory slots by cp.async, the next slab in flight while the
// tensor cores work on this one, across the products' epilogues too; A
// starts its stream before LN1 and fits three blocks an SM (a third slot
// bought C nothing and cost A one of them).  At the serving shape (dim
// 256, inner 512, ff 1024) phase C takes 218 KB of shared memory (o streams
// beside wo, never whole), and its 1.25 MB of weights stream from the L2
// once a 96-row tile: a third of the traffic of 32-row tiles.
// fp32: the products stay on the SIMT units in full fp32 (the GPU tests'
// route): weight tiles of 32 rows in shared memory, each of the 256 threads
// owning a strip of the output tile in registers, and a SIMT attention.

#include <cstdint>

#include "common.cuh"
#include "dit_attention.cuh"

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
// bf16 route
constexpr int kRows = 64;      // rows a block in phase A
constexpr int kRowsC2 = 96;    // rows a block in phase C
constexpr int kThreadsC = 384; // phase C: 12 warps, 3 x 32 rows by 4 column quarters
constexpr int kSlab = 64;      // input rows of one streamed weight slab
constexpr int kStages = 2;     // slabs in the ring (the next in flight while one computes)
constexpr int kChunk = 128;    // columns of a phase A chunk and of a phase C mid chunk
constexpr int kColsTc = 384;   // qkv columns a block in phase A

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
  for (int r = warp; r < rows; r += blockDim.x / 32) {
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

__device__ __forceinline__ void store2(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

// rows [0, nrows) x columns [0, ncols) (a multiple of 8) of a bf16 tensor
// (row stride lds) into dst (row stride ldd), 16 bytes a cp.async spread over
// the block; rows >= valid are zero-filled and their source is not read; the
// caller commits
__device__ __forceinline__ void load_tile(bf16* dst, int ldd, const bf16* src, long long lds,
                                          int nrows, int ncols, int valid) {
  const int cpr = ncols / 8;
  for (int i = threadIdx.x; i < nrows * cpr; i += blockDim.x) {
    const int r = i / cpr, c = 8 * (i - r * cpr);
    const bool live = r < valid;
    cp_async16(dst + r * ldd + c, src + (live ? r : 0) * lds + c, live);
  }
}

// one [kSlab][n] weight slab (global row stride ldw) into dst (row stride n + 8)
__device__ __forceinline__ void load_slab(bf16* dst, const bf16* src, int ldw, int n) {
  load_tile(dst, n + 8, src, ldw, kSlab, n, kSlab);
}

// acc[mi][ni] += A[r0 + 16 mi .., 0:kSlab] @ B[0:kSlab, n0 + 8 ni ..] for one
// warp: A [m][k] (row stride lda) and the slab B [k][n] (row stride ldb) bf16
// in shared memory, A fragments by ldmatrix.x4, two B fragments a
// ldmatrix.x4.trans, each B fragment feeding MI products.
template <int MI, int NI>
__device__ __forceinline__ void slab_mma(float (&acc)[MI][NI][4], const bf16* A, int lda,
                                         int r0, const bf16* B, int ldb, int n0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kSlab; k += 16) {
    uint32_t a[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
      ldsm_x4(a[mi], A + (r0 + 16 * mi + (lane & 15)) * lda + k + 8 * (lane >> 4));
#pragma unroll
    for (int ni = 0; ni < NI; ni += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, B + (k + (lane & 15)) * ldb + n0 + 8 * ni + 8 * (lane >> 4));
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        mma16816(acc[mi][ni], a[mi], b[0], b[1]);
        mma16816(acc[mi][ni + 1], a[mi], b[2], b[3]);
      }
    }
  }
}

template <int MI, int NI>
__device__ __forceinline__ void zero(float (&acc)[MI][NI][4]) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
}

// Phase A in bf16: LN1 of 64 rows into shared memory (bf16), once, then
// their kColsTc qkv columns in chunks of kChunk; the weight slabs stream
// through a kStages ring of cp.async copies, the first ones in flight
// before LN1.  Warp (wr, wc) owns rows 32 wr.., columns 32 wc.. of a chunk.
template <int DIM>
__global__ void __launch_bounds__(kThreads)
ln_qkv_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ g1,
                 const float* __restrict__ b1, const bf16* __restrict__ wqkv,
                 bf16* __restrict__ qkv, int T_len, int n_qkv) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int ldh = DIM + 8, ldw = kChunk + 8, KS = DIM / kSlab;
  constexpr int NS = kColsTc / kChunk * KS;            // slabs a block
  bf16* h_s = reinterpret_cast<bf16*>(smem_raw);       // [kRows][ldh]
  bf16* ring = h_s + kRows * ldh;                      // kStages x [kSlab][ldw]
  const int t0 = blockIdx.x * kRows, n0 = blockIdx.y * kColsTc, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp / 4, wc = warp % 4;
  // slab s: input rows (s % KS) * kSlab .., columns of chunk s / KS
  auto src = [&](int s) {
    return wqkv + (long long)(s % KS) * kSlab * n_qkv + n0 + (s / KS) * kChunk;
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    load_slab(ring + s * kSlab * ldw, src(s), n_qkv, kChunk);
    cp_async_commit();
  }
  const int rows = min(kRows, T_len - t0);
  for (int idx = threadIdx.x; idx < (kRows - rows) * ldh; idx += kThreads)
    h_s[rows * ldh + idx] = __float2bfloat16(0.f);
  layer_norm_rows<bf16>(x + ((long long)b * T_len + t0) * DIM, DIM, h_s, ldh, rows, DIM,
                        g1, b1);
  float acc[2][4][4];
  zero(acc);
  bf16* out = qkv + (long long)b * T_len * n_qkv + n0 + 32 * wc + 2 * t;
  for (int s = 0; s < NS; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                    // slab s landed; slab s - 1's slot is free
    if (s + kStages - 1 < NS)
      load_slab(ring + (s + kStages - 1) % kStages * kSlab * ldw, src(s + kStages - 1), n_qkv,
                kChunk);
    cp_async_commit();
    const int ks = s % KS;
    slab_mma<2, 4>(acc, h_s + ks * kSlab, ldh, 32 * wr, ring + s % kStages * kSlab * ldw, ldw,
                   32 * wc);
    if (ks == KS - 1) {                 // a chunk's columns are done
      const int c0 = s / KS * kChunk;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int tt = t0 + 32 * wr + 16 * mi + g + 8 * h;
          if (tt >= T_len) continue;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            store2(out + (long long)tt * n_qkv + c0 + 8 * ni, acc[mi][ni][2 * h],
                   acc[mi][ni][2 * h + 1]);
        }
      zero(acc);
    }
  }
}

// Phase C in bf16 for kRowsC2 (96) rows of one batch row: x1 = x + T(o @ wo
// + bo), h2 = LN3(x1), then the FFN in chunks of kChunk mid columns, y = x1 +
// T(.. + bo2).  96-row tiles make one wave of blocks at the serving shape
// (7 x 16 = 112 on 132 SMs, where 64-row tiles took two) with 12 warps an SM.
// Every slab streams through one kStages ring of cp.async copies, so the next
// loads while the tensor cores work on this one, across the products'
// epilogues too: during the out projection a ring slot holds the tile's o
// columns of the slab's depth beside wo's rows (o never sits in shared
// memory whole), then wi's and wo2's slabs.  x, then x1 (bf16-valued, so
// exact in bf16), sit in x1_s, h2 in h_s, one chunk of the mid in m_s.  Warp
// (wr, wc) owns rows 32 wr.. and a quarter of each product's columns (32 x 64
// of the out projection and the FFN's second product at dim 256, 32 x 32 of
// a mid chunk), so each B fragment feeds two products.
template <int DIM>
__global__ void __launch_bounds__(kThreadsC)
out_ffn_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ o,
                  const bf16* __restrict__ wo, const float* __restrict__ bo,
                  const float* __restrict__ g3, const float* __restrict__ b3,
                  const bf16* __restrict__ wi, const float* __restrict__ bi,
                  const bf16* __restrict__ wo2, const float* __restrict__ bo2,
                  bf16* __restrict__ y, int T_len, int inner, int ff) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int R = kRowsC2, ldx = DIM + 8, ldm = kChunk + 8, ldr = DIM + 8, ldo = kSlab + 8;
  constexpr int NO = DIM / 32, WO = DIM / 4;
  constexpr int KS = DIM / kSlab, CS = KS + kChunk / kSlab;   // slabs a chunk: wi, wo2
  constexpr int kSlot = R * ldo + kSlab * ldr;                 // an o slab, then a weight slab
  const int S1 = inner / kSlab, NS = S1 + ff / kChunk * CS;
  bf16* x1_s = reinterpret_cast<bf16*>(smem_raw);   // [R][ldx]: x, then x1
  bf16* h_s = x1_s + R * ldx;                       // [R][ldx]: h2
  bf16* m_s = h_s + R * ldx;                        // [R][ldm]
  bf16* ring = m_s + R * ldm;                       // kStages x kSlot
  const int t0 = blockIdx.x * R, b = blockIdx.y, valid = min(R, T_len - t0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp / 4, wc = warp % 4;
  // slab s: o's columns and wo's rows s * kSlab .. (s < S1), else of chunk c:
  // wi's rows j * kSlab .., columns c * kChunk .. (j < KS), then wo2's rows
  // c * kChunk + (j - KS) * kSlab ..
  auto load = [&](int s) {
    bf16* slot = ring + s % kStages * kSlot;
    if (s < S1) {
      load_tile(slot, ldo, o + ((long long)b * T_len + t0) * inner + s * kSlab, inner, R, kSlab,
                valid);
      load_slab(slot + R * ldo, wo + (long long)s * kSlab * DIM, DIM, DIM);
    } else {
      const int c = (s - S1) / CS, j = (s - S1) % CS;
      if (j < KS) load_slab(slot + R * ldo, wi + (long long)j * kSlab * ff + c * kChunk, ff, kChunk);
      else load_slab(slot + R * ldo, wo2 + (long long)(c * kChunk + (j - KS) * kSlab) * DIM, DIM, DIM);
    }
  };
  load_tile(x1_s, ldx, x + ((long long)b * T_len + t0) * DIM, DIM, R, DIM, valid);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    load(s);
    cp_async_commit();
  }

  float acc[2][NO][4], mid[2][4][4];
  zero(acc);
  zero(mid);
  for (int s = 0; s < NS; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                    // slab s landed; slab s - 1's slot is free
    if (s + kStages - 1 < NS) load(s + kStages - 1);
    cp_async_commit();
    const bf16* slot = ring + s % kStages * kSlot;
    const bf16* w_s = slot + R * ldo;
    if (s < S1) {
      slab_mma<2, NO>(acc, slot, ldo, 32 * wr, w_s, ldr, WO * wc);
      if (s == S1 - 1) {                // x1 = x + T(o @ wo + bo), then h2
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < NO; ++ni)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = 32 * wr + 16 * mi + g + 8 * h, c = WO * wc + 8 * ni + 2 * t;
              const __nv_bfloat162 xv = *reinterpret_cast<__nv_bfloat162*>(x1_s + row * ldx + c);
              store2(x1_s + row * ldx + c,
                     __low2float(xv) + round_to<bf16>(acc[mi][ni][2 * h] + bo[c]),
                     __high2float(xv) + round_to<bf16>(acc[mi][ni][2 * h + 1] + bo[c + 1]));
            }
        zero(acc);
        __syncthreads();                // x1 complete
        layer_norm_rows<bf16>(x1_s, ldx, h_s, ldx, R, DIM, g3, b3);
      }
    } else {
      const int c = (s - S1) / CS, j = (s - S1) % CS;
      if (j < KS) {
        slab_mma<2, 4>(mid, h_s + j * kSlab, ldx, 32 * wr, w_s, ldm, 32 * wc);
        if (j == KS - 1) {              // the chunk's mid = T(gelu(h2 @ wi + bi))
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int row = 32 * wr + 16 * mi + g + 8 * h, col = 32 * wc + 8 * ni + 2 * t;
                const float* bc = bi + c * kChunk + col;
                store2(m_s + row * ldm + col, gelu_tanh(mid[mi][ni][2 * h] + bc[0]),
                       gelu_tanh(mid[mi][ni][2 * h + 1] + bc[1]));
              }
          zero(mid);
        }
      } else {
        slab_mma<2, NO>(acc, m_s + (j - KS) * kSlab, ldm, 32 * wr, w_s, ldr, WO * wc);
      }
    }
  }

  bf16* yb = y + (long long)b * T_len * DIM;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NO; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 32 * wr + 16 * mi + g + 8 * h, c = WO * wc + 8 * ni + 2 * t;
        if (row >= valid) continue;
        const __nv_bfloat162 xv = *reinterpret_cast<__nv_bfloat162*>(x1_s + row * ldx + c);
        store2(yb + (long long)(t0 + row) * DIM + c,
               __low2float(xv) + round_to<bf16>(acc[mi][ni][2 * h] + bo2[c]),
               __high2float(xv) + round_to<bf16>(acc[mi][ni][2 * h + 1] + bo2[c + 1]));
      }
}

struct BlockArgs {
  const void *x, *lengths, *g1, *b1, *wqkv, *wo, *bo, *g3, *b3, *wi, *bi, *wo2, *bo2;
  void *qkv, *o, *y;
  int B, T_len, heads, inner, ff;
  float qscale;
};

// dynamic shared memory of the bf16 route's phase A and phase C kernels
size_t smem_ln_qkv_tc(int dim) {
  return (size_t)(kRows * (dim + 8) + kStages * kSlab * (kChunk + 8)) * sizeof(bf16);
}
size_t smem_out_ffn_tc(int dim) {
  return (size_t)(kRowsC2 * (2 * (dim + 8) + (kChunk + 8)) +
                  kStages * (kRowsC2 * (kSlab + 8) + kSlab * (dim + 8))) *
         sizeof(bf16);
}

template <int DIM>
int launch_tc(const BlockArgs& a, cudaStream_t stream) {
  const size_t smem_a = smem_ln_qkv_tc(DIM), smem_c = smem_out_ffn_tc(DIM);
  cudaError_t e = cudaFuncSetAttribute(ln_qkv_tc_kernel<DIM>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem_a);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(out_ffn_tc_kernel<DIM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_c);
  if (e != cudaSuccess) return (int)e;
  const int n_qkv = 3 * a.inner, tiles = (a.T_len + kRows - 1) / kRows;
  ln_qkv_tc_kernel<DIM><<<dim3(tiles, n_qkv / kColsTc, a.B), kThreads, smem_a, stream>>>(
      (const bf16*)a.x, (const float*)a.g1, (const float*)a.b1, (const bf16*)a.wqkv,
      (bf16*)a.qkv, a.T_len, n_qkv);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const bf16* qkv = (const bf16*)a.qkv;
  dit_attention_tc_launch(qkv, qkv + a.inner, qkv + 2 * a.inner, (bf16*)a.o,
                          (const int*)a.lengths, a.B, a.T_len, a.heads,
                          (long long)a.T_len * n_qkv, n_qkv, (long long)a.T_len * a.inner,
                          a.inner, a.qscale, stream);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  out_ffn_tc_kernel<DIM><<<dim3((a.T_len + kRowsC2 - 1) / kRowsC2, a.B), kThreadsC, smem_c,
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
