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
// scales.  Design: a block owns 64 consecutive output columns (each lane
// two neighbouring columns, one 2-byte load per packed row, so a warp reads
// 64 consecutive bytes of a row) and a tile of up to 8 rows of x, so one
// pass over the weights serves all of them.  The block's 8 warps split the
// packed rows between them and their fp32 partial sums are added in shared
// memory at the end; x is staged through shared memory in chunks.
// Numerics mirror the TPU kernel: the nibble and the group scale are rounded
// to x's dtype and multiplied in it (bf16(nibble) * bf16(scale) -> bf16),
// the products accumulate in fp32, and the output is cast once.

#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kCols = 64;       // output columns per block (2 per lane)
constexpr int kChunk = 256;     // packed rows of x staged per shared-memory chunk

template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// signed nibbles of a packed byte: low = even input row, high = odd row
__device__ __forceinline__ float lo_nibble(int8_t b) {
  return (float)((int8_t)((uint8_t)b << 4) >> 4);
}
__device__ __forceinline__ float hi_nibble(int8_t b) { return (float)(b >> 4); }

template <typename T, int ROWS>
__global__ void __launch_bounds__(kWarps * 32)
int4_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, T* __restrict__ y, int rows,
                   int IN, int OUT, int g2) {
  __shared__ float xs[ROWS][2 * kChunk];
  __shared__ float red[kWarps][ROWS][kCols];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = blockIdx.x * kCols;
  const int row0 = blockIdx.y * ROWS;
  const int nr = min(ROWS, rows - row0);
  const int col = col0 + 2 * lane;
  const bool live = col < OUT;
  const int IN2 = IN / 2;

  float acc[ROWS][2];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r][0] = acc[r][1] = 0.f;

  int cur_g = -1;
  float s0 = 0.f, s1 = 0.f;
  for (int k0 = 0; k0 < IN2; k0 += kChunk) {
    const int kc = min(kChunk, IN2 - k0);
    __syncthreads();                       // previous chunk fully consumed
    for (int idx = tid; idx < ROWS * 2 * kChunk; idx += blockDim.x) {
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
      for (int r = 0; r < ROWS; ++r) {
        const float xe = xs[r][2 * i], xo = xs[r][2 * i + 1];
        acc[r][0] += xe * lo0 + xo * hi0;
        acc[r][1] += xe * lo1 + xo * hi1;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    red[warp][r][2 * lane] = acc[r][0];
    red[warp][r][2 * lane + 1] = acc[r][1];
  }
  __syncthreads();
  for (int idx = tid; idx < ROWS * kCols; idx += blockDim.x) {
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
int launch(const void* x, const void* w, const void* scale, void* y, int rows, int IN,
           int OUT, int g2, cudaStream_t stream) {
  const int col_blocks = (OUT + kCols - 1) / kCols;
  if (rows == 1) {
    int4_matmul_kernel<T, 1><<<dim3(col_blocks, 1), kWarps * 32, 0, stream>>>(
        (const T*)x, (const int8_t*)w, (const float*)scale, (T*)y, rows, IN, OUT, g2);
  } else {
    int4_matmul_kernel<T, 8><<<dim3(col_blocks, (rows + 7) / 8), kWarps * 32, 0, stream>>>(
        (const T*)x, (const int8_t*)w, (const float*)scale, (T*)y, rows, IN, OUT, g2);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cvt_int4_matmul(const void* x, const void* w, const void* scale, void* y,
                               int rows, int IN, int OUT, int g2, int dtype,
                               void* stream) {
  if (rows < 1 || IN < 2 || IN % 2 || OUT < 2 || OUT % 2 || g2 < 1 || (IN / 2) % g2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kFloat32) return launch<float>(x, w, scale, y, rows, IN, OUT, g2, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(x, w, scale, y, rows, IN, OUT, g2, s);
  return (int)cudaErrorInvalidValue;
}
