// Packed-int4 weight-only matmul: y[rows, out] = x[rows, in] @ dequant(W),
// W packed two input rows per int8 byte ([in/2, out], low nibble = even
// row, both nibbles two's complement), group-wise fp32 scales [in/g, out].
//
// Replaces: cosyvoice_tpu/ops/pallas/int4_matmul.py::int4_matmul (the
// QDense(quant="int4") projection of the LM, rows <= 512).
//
// Bound on the H100: bytes.  At decode (1 row) every packed weight byte is
// used for 4 flops, so the kernel is a GEMV that must stream the 0.5-byte
// weights once: 896 -> 4864 moves 2.18 MB of packed weights and 0.14 MB of
// scales, 0.7 us at 3.35 TB/s.  What keeps a GEMV from that is too few bytes
// in flight: one block per 64 columns gave the 896-wide projections 14
// blocks on 132 SMs.
//
// Decode route (one row, out % 16 == 0, groups a multiple of 32 input
// rows): the grid is column tiles x splits of the packed input rows.
// plan_for() takes the widest tile (128, 64, 32 or 16 columns) that gives
// at least 132 tiles x groups, then the longest split (a whole number of
// groups, else half or a quarter of one, at least 32 rows; at most 16 KB of
// packed weights a block) that keeps at least 132 blocks.  At the LM's
// shapes, group 128:
//   896 -> 896:   28 tiles of 32 columns x 7 one-group splits  = 196 blocks
//   896 -> 128:    8 tiles of 16 columns x 14 half-group splits = 112 blocks
//   896 -> 4864:  38 tiles of 128 columns x 4 two-group splits  = 152 blocks
//                 (the last split holds one group)
//   4864 -> 896:   7 tiles of 128 columns x 19 two-group splits = 133 blocks
// A thread loads 16 bytes of one packed row (16 columns x 2 input rows),
// up to 4 such loads, all issued before anything waits on them; the split's
// x slice and its scales (rounded to x's dtype) are staged in shared memory
// meanwhile.  Nibbles become numbers by bit operations, not by an I2F: in
// fp32 (b & 0xF) ^ 8 in the mantissa of 2^23, minus 2^23 + 8; in bf16 two at
// a time in the mantissas of a bf16x2 128, minus 136 (HSUB2), then one HMUL2
// by the scale pair, which rounds each product to bf16 once.  The
// threads of a column segment add their sums by shuffles, the warps theirs
// in shared memory in a fixed order; a split's fp32 partial goes to scratch,
// and the last block of a column tile to arrive (an acquire-release counter
// that it resets, as in lm_decode_attention.cu) adds the splits, all its
// threads loading partials at once, in a fixed order, and writes y.  So the
// result does not depend on the order in which the blocks run.
// Calls of 2-512 rows (prefill) keep a block per 64 columns and 8 rows of
// x, so one pass over the weights serves 8 rows.  The LM sends only B=1
// decode rows and prefills of more than 8 rows through this kernel, so the
// split route takes one row and nothing else.
// Numerics mirror the TPU kernel: the nibble and the group scale are rounded
// to x's dtype and multiplied in it (bf16(nibble) * bf16(scale) -> bf16),
// the products accumulate in fp32, and the output is cast once.

#include "common.cuh"

#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// ------------------------------------------------ decode route (one row)

constexpr int kThreads = 256;
constexpr int kMaxWarps = kThreads / 32;
constexpr int kTargetBlocks = 132;       // an SM each, at least
constexpr int kMaxTileBytes = 16384;     // packed bytes a block: 4 loads a thread
constexpr int kLoads = 4;
constexpr int kMinSplitRows = 32;
constexpr int kMaxSplitRows = 256;
constexpr int kMaxScales = 1024;         // groups x columns of a block's scales
constexpr int kFinalLoads = 16;          // partials a thread loads at once in the final sum

struct Plan {
  int split;      // 1: the decode route; 0: the prefill route
  int tc, r, s;   // columns a tile, packed rows a split, splits
  int blocks, threads;
};

Plan prefill_plan(int rows, int OUT) {
  Plan p{};
  p.tc = 64;
  p.blocks = ((OUT + 63) / 64) * ((rows + 7) / 8);
  p.threads = kThreads;
  return p;
}

Plan plan_for(int rows, int IN2, int OUT, int g2) {
  if (rows != 1 || OUT % 16 || g2 % 16) return prefill_plan(rows, OUT);
  const int n_g = IN2 / g2;
  Plan p{};
  p.split = 1;
  p.tc = 16;
  for (int tc = 128; tc > 16; tc /= 2)
    if (OUT % tc == 0 && (OUT / tc) * n_g >= kTargetBlocks) {
      p.tc = tc;
      break;
    }
  const int tiles = OUT / p.tc;
  const int max_r = min(min(kMaxTileBytes / p.tc, kMaxSplitRows), IN2);
  // candidates, longest first: whole groups, then a half or a quarter group
  int cand[64], n = 0;
  for (int r = max_r / g2 * g2; r >= g2 && n < 60; r -= g2) cand[n++] = r;
  for (int d = 2; d <= 4; d *= 2)
    if (g2 % d == 0 && g2 / d >= kMinSplitRows && g2 / d <= max_r) cand[n++] = g2 / d;
  if (!n) return prefill_plan(rows, OUT);         // groups too long to split
  p.r = cand[n - 1];
  for (int i = 0; i < n; ++i)
    if (tiles * ((IN2 + cand[i] - 1) / cand[i]) >= kTargetBlocks) {
      p.r = cand[i];
      break;
    }
  p.s = (IN2 + p.r - 1) / p.r;
  p.blocks = tiles * p.s;
  const int t = p.r * (p.tc / 16);
  p.threads = t >= kThreads ? kThreads : (t + 31) / 32 * 32;
  return p;
}

// 16 bytes of weights that are read once: no L1 allocation
__device__ __forceinline__ int4 ld_stream16(const int8_t* p) {
  int4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// the signed nibble in the low 4 bits of b, exactly, by bit operations
__device__ __forceinline__ float nibble(uint32_t b) {
  return __int_as_float((int)((b & 0xFu) ^ 0x4B000008u)) - 8388616.f;
}

// 16 packed bytes (16 columns, even row in the low nibbles) -> the
// dequantised weights lo[c], hi[c], each T(T(nibble) * T(scale[c])); sc holds
// the scales already rounded to T.  fp32: the product needs no rounding.
__device__ __forceinline__ void dequant16(const int4& raw, const float* sc, float* lo,
                                          float* hi, float) {
  const uint32_t wd[4] = {(uint32_t)raw.x, (uint32_t)raw.y, (uint32_t)raw.z, (uint32_t)raw.w};
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const uint32_t b = wd[c / 4] >> (8 * (c % 4));
    lo[c] = nibble(b) * sc[c];
    hi[c] = nibble(b >> 4) * sc[c];
  }
}

__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t u) {
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// bf16: two nibbles a bf16x2 register.  A nibble u in the mantissa of bf16
// 128 is 128 + (u ^ 8), so subtracting 136 (HSUB2) gives the signed nibble
// exactly, and one HMUL2 by the scale pair rounds the product to bf16 once:
// the same bits as rounding the fp32 product.
__device__ __forceinline__ void dequant16(const int4& raw, const float* sc, float* lo,
                                          float* hi, __nv_bfloat16) {
  const uint32_t wd[4] = {(uint32_t)raw.x, (uint32_t)raw.y, (uint32_t)raw.z, (uint32_t)raw.w};
  const __nv_bfloat162 k136 = as_bf2(0x43084308u);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float* s = sc + 4 * q;
    const __nv_bfloat162 s02 = __floats2bfloat162_rn(s[0], s[2]);
    const __nv_bfloat162 s13 = __floats2bfloat162_rn(s[1], s[3]);
    // columns 4q and 4q + 2 sit in bytes 0 and 2 of the word, 4q + 1 and
    // 4q + 3 in bytes 1 and 3
    const uint32_t v[4] = {
        as_u32(__hmul2(__hsub2(as_bf2((wd[q] & 0x000F000Fu) ^ 0x43084308u), k136), s02)),
        as_u32(__hmul2(__hsub2(as_bf2(((wd[q] >> 4) & 0x000F000Fu) ^ 0x43084308u), k136), s02)),
        as_u32(__hmul2(__hsub2(as_bf2(((wd[q] >> 8) & 0x000F000Fu) ^ 0x43084308u), k136), s13)),
        as_u32(__hmul2(__hsub2(as_bf2(((wd[q] >> 12) & 0x000F000Fu) ^ 0x43084308u), k136), s13))};
    lo[4 * q] = __uint_as_float(v[0] << 16);
    lo[4 * q + 2] = __uint_as_float(v[0] & 0xFFFF0000u);
    hi[4 * q] = __uint_as_float(v[1] << 16);
    hi[4 * q + 2] = __uint_as_float(v[1] & 0xFFFF0000u);
    lo[4 * q + 1] = __uint_as_float(v[2] << 16);
    lo[4 * q + 3] = __uint_as_float(v[2] & 0xFFFF0000u);
    hi[4 * q + 1] = __uint_as_float(v[3] << 16);
    hi[4 * q + 3] = __uint_as_float(v[3] & 0xFFFF0000u);
  }
}

template <int TC>
__host__ __device__ constexpr int split_smem_floats() {
  // phase 1: x slice [2 * kMaxSplitRows] + scales; phase 2: the warps' sums
  return 2 * kMaxSplitRows + kMaxScales > kMaxWarps * TC ? 2 * kMaxSplitRows + kMaxScales
                                                         : kMaxWarps * TC;
}

template <typename T, int TC>
__global__ void __launch_bounds__(kThreads)
int4_gemv_split_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                       const float* __restrict__ scale, T* __restrict__ y,
                       float* __restrict__ part, int* __restrict__ counters, int IN,
                       int OUT, int g2, int R, int S) {
  constexpr int TPR = TC / 16;                      // threads a packed row
  __shared__ float smem[split_smem_floats<TC>()];
  __shared__ int is_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, rpp = nthreads / TPR;
  const int tile = blockIdx.x, split = blockIdx.y;
  const int col0 = tile * TC, k0 = split * R;
  const int nk = min(R, IN / 2 - k0);               // packed rows of this split
  const int seg = tid % TPR, r0 = tid / TPR;

  // the block's weights: every load in flight before anything waits
  const int8_t* wt = w + (size_t)k0 * OUT + col0 + seg * 16;
  int4 raw[kLoads];
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int k = r0 + u * rpp;
    raw[u] = k < nk ? ld_stream16(wt + (size_t)k * OUT) : make_int4(0, 0, 0, 0);
  }

  // the split's x slice and scales (rounded to T) into shared memory
  float* xs = smem;                                 // [2R]
  float* ss = smem + 2 * R;                         // [groups][TC]
  const int g_lo = k0 / g2, ng = (k0 + nk - 1) / g2 - g_lo + 1;
  for (int j = tid; j < 2 * nk; j += nthreads) xs[j] = to_float(x[2 * k0 + j]);
  for (int i = tid; i < ng * TC; i += nthreads)
    ss[i] = round_to<T>(scale[(size_t)(g_lo + i / TC) * OUT + col0 + i % TC]);
  __syncthreads();

  float acc[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) acc[c] = 0.f;
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int k = r0 + u * rpp;
    if (k < nk) {
      const float* sc = ss + ((k0 + k) / g2 - g_lo) * TC + seg * 16;
      const float xe = xs[2 * k], xo = xs[2 * k + 1];
      float lo[16], hi[16];
      dequant16(raw[u], sc, lo, hi, T());
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[c] = fmaf(xo, hi[c], fmaf(xe, lo[c], acc[c]));
    }
  }

  // lanes of one column segment add up within the warp, then the warps
#pragma unroll
  for (int c = 0; c < 16; ++c)
#pragma unroll
    for (int o = 16; o >= TPR; o >>= 1) acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], o);
  __syncthreads();                                  // x and scales are consumed
  float* red = smem;                                // [warps][TC]
  if (lane < TPR) {
#pragma unroll
    for (int c = 0; c < 16; ++c) red[warp * TC + seg * 16 + c] = acc[c];
  }
  __syncthreads();
  const int nwarps = nthreads / 32;
  for (int c = tid; c < TC; c += nthreads) {
    float v = 0.f;
    for (int v_w = 0; v_w < nwarps; ++v_w) v += red[v_w * TC + c];
    if (S == 1) y[col0 + c] = from_float<T>(v);
    else part[(size_t)split * OUT + col0 + c] = v;
  }
  if (S == 1) return;

  // arrive; the last block of the column tile adds the splits in order
  __syncthreads();
  if (tid == 0) {
    int before;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(before)
                 : "l"(counters + tile)
                 : "memory");
    is_last = before == S - 1;
  }
  __syncthreads();
  if (!is_last) return;
  // tpo neighbouring lanes an output, each over every tpo-th split, up to
  // kFinalLoads loads in flight, then added across the lanes in a fixed order
  int tpo = 1;
  while (tpo < 8 && 2 * tpo * TC <= nthreads) tpo *= 2;
  const int sub = tid % tpo;
  for (int c = tid / tpo; c < TC; c += nthreads / tpo) {
    const float* pr = part + col0 + c;
    float v = 0.f;
    for (int s0 = sub; s0 < S; s0 += kFinalLoads * tpo) {
      float pv[kFinalLoads];
#pragma unroll
      for (int u = 0; u < kFinalLoads; ++u) {
        const int s = s0 + u * tpo;
        pv[u] = s < S ? __ldcg(pr + (size_t)s * OUT) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kFinalLoads; ++u) v += pv[u];
    }
    for (int o = 1; o < tpo; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (sub == 0) y[col0 + c] = from_float<T>(v);
  }
  if (tid == 0) counters[tile] = 0;
}

// ------------------------------------------------- prefill route (2-512 rows)

constexpr int kWarps = 8;
constexpr int kCols = 64;       // output columns per block (2 per lane)
constexpr int kChunk = 256;     // packed rows of x staged per shared-memory chunk
constexpr int kRows = 8;        // rows of x a block

// signed nibbles of a packed byte: low = even input row, high = odd row
__device__ __forceinline__ float lo_nibble(int8_t b) {
  return (float)((int8_t)((uint8_t)b << 4) >> 4);
}
__device__ __forceinline__ float hi_nibble(int8_t b) { return (float)(b >> 4); }

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
int4_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, T* __restrict__ y, int rows,
                   int IN, int OUT, int g2) {
  __shared__ float xs[kRows][2 * kChunk];
  __shared__ float red[kWarps][kRows][kCols];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = blockIdx.x * kCols;
  const int row0 = blockIdx.y * kRows;
  const int nr = min(kRows, rows - row0);
  const int col = col0 + 2 * lane;
  const bool live = col < OUT;
  const int IN2 = IN / 2;

  float acc[kRows][2];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r][0] = acc[r][1] = 0.f;

  int cur_g = -1;
  float s0 = 0.f, s1 = 0.f;
  for (int k0 = 0; k0 < IN2; k0 += kChunk) {
    const int kc = min(kChunk, IN2 - k0);
    __syncthreads();                       // previous chunk fully consumed
    for (int idx = tid; idx < kRows * 2 * kChunk; idx += blockDim.x) {
      const int r = idx / (2 * kChunk), j = idx % (2 * kChunk);
      xs[r][j] = (r < nr && j < 2 * kc)
                     ? to_float(x[(size_t)(row0 + r) * IN + 2 * k0 + j]) : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    const int per_warp = (kc + kWarps - 1) / kWarps;
    const int i_lo = warp * per_warp, i_hi = min(kc, i_lo + per_warp);
#pragma unroll 4
    for (int i = i_lo; i < i_hi; ++i) {
      const int i2 = k0 + i;
      const int g = i2 / g2;
      if (g != cur_g) {
        cur_g = g;
        s0 = round_to<T>(scale[(size_t)g * OUT + col]);
        s1 = round_to<T>(scale[(size_t)g * OUT + col + 1]);
      }
      const char2 b = *reinterpret_cast<const char2*>(w + (size_t)i2 * OUT + col);
      const float lo0 = round_to<T>(lo_nibble(b.x) * s0);
      const float hi0 = round_to<T>(hi_nibble(b.x) * s0);
      const float lo1 = round_to<T>(lo_nibble(b.y) * s1);
      const float hi1 = round_to<T>(hi_nibble(b.y) * s1);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float xe = xs[r][2 * i], xo = xs[r][2 * i + 1];
        acc[r][0] += xe * lo0 + xo * hi0;
        acc[r][1] += xe * lo1 + xo * hi1;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    red[warp][r][2 * lane] = acc[r][0];
    red[warp][r][2 * lane + 1] = acc[r][1];
  }
  __syncthreads();
  for (int idx = tid; idx < kRows * kCols; idx += blockDim.x) {
    const int r = idx / kCols, c = idx % kCols;
    if (r < nr && col0 + c < OUT) {
      float s = 0.f;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) s += red[v][r][c];
      y[(size_t)(row0 + r) * OUT + col0 + c] = from_float<T>(s);
    }
  }
}

template <typename T>
void launch_split(const Plan& p, const void* x, const void* w, const void* scale, void* y,
                  float* part, int* counters, int IN, int OUT, int g2,
                  cudaStream_t stream) {
  const dim3 grid(OUT / p.tc, p.s);
#define K5_SPLIT(TC)                                                                   \
  int4_gemv_split_kernel<T, TC><<<grid, p.threads, 0, stream>>>(                       \
      (const T*)x, (const int8_t*)w, (const float*)scale, (T*)y, part, counters, IN, OUT, \
      g2, p.r, p.s)
  if (p.tc == 128) K5_SPLIT(128);
  else if (p.tc == 64) K5_SPLIT(64);
  else if (p.tc == 32) K5_SPLIT(32);
  else K5_SPLIT(16);
#undef K5_SPLIT
}

template <typename T>
int launch(const void* x, const void* w, const void* scale, void* y, float* part,
           int* counters, int rows, int IN, int OUT, int g2, cudaStream_t stream) {
  const Plan p = plan_for(rows, IN / 2, OUT, g2);
  if (!p.split) {
    int4_matmul_kernel<T><<<dim3((OUT + kCols - 1) / kCols, (rows + kRows - 1) / kRows),
                            kWarps * 32, 0, stream>>>(
        (const T*)x, (const int8_t*)w, (const float*)scale, (T*)y, rows, IN, OUT, g2);
  } else {
    launch_split<T>(p, x, w, scale, y, part, counters, IN, OUT, g2, stream);
  }
  return (int)cudaGetLastError();
}

bool valid(int rows, int IN, int OUT, int g2) {
  return rows >= 1 && IN >= 2 && IN % 2 == 0 && OUT >= 2 && OUT % 2 == 0 && g2 >= 1 &&
         (IN / 2) % g2 == 0;
}

}  // namespace

// The launch plan for these shapes: {split route, columns a tile, packed rows
// a split, splits, blocks, threads a block}.  The decode route needs
// splits * OUT floats of scratch and OUT / tile counters, zero before
// the first launch (each launch leaves them zero).
extern "C" int cvt_int4_matmul_plan(int rows, int IN, int OUT, int g2, int* plan) {
  if (!valid(rows, IN, OUT, g2)) return (int)cudaErrorInvalidValue;
  const Plan p = plan_for(rows, IN / 2, OUT, g2);
  const int v[6] = {p.split, p.tc, p.r, p.s, p.blocks, p.threads};
  for (int i = 0; i < 6; ++i) plan[i] = v[i];
  return 0;
}

// work and counters as cvt_int4_matmul_plan says (unused by the prefill
// route); w 16-byte aligned on the decode route (the wrapper checks).
extern "C" int cvt_int4_matmul(const void* x, const void* w, const void* scale, void* y,
                               void* work, void* counters, int rows, int IN, int OUT,
                               int g2, int dtype, void* stream) {
  if (!valid(rows, IN, OUT, g2)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kFloat32)
    return launch<float>(x, w, scale, y, (float*)work, (int*)counters, rows, IN, OUT, g2, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, w, scale, y, (float*)work, (int*)counters, rows, IN,
                                 OUT, g2, s);
  return (int)cudaErrorInvalidValue;
}
