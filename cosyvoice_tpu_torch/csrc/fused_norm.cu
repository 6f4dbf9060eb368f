// LayerNorm over the last axis (+ optional fused mish), the flow estimator's
// ELayerNorm on the serving path (DiT norm1/norm3 and the causal Block1D
// LN+mish).
//
// Replaces: cosyvoice_tpu/ops/pallas/fused_norm.py::fused_layer_norm.
//
// Bound on the H100: bytes.  One read of x and one write of y per element
// and ~10 flops in between: 1.3 MB at the estimator's [1280, 256] bf16,
// 0.39 us at 3.35 TB/s.  At that size a call is a chain of latencies
// (launch, one round of loads, the reductions, the stores), so the design
// keeps the chain to one round of loads.
//
// Vector route (C a multiple of 32 16-byte vectors: 256 in bf16, 128 in
// fp32; C <= 1024; every pointer 16-byte aligned): a lane holds NV 16-byte
// vectors of a row (a 256-wide bf16 row is one vector a lane, a warp reads
// it as 512 contiguous bytes) and a warp takes RPW rows.  Each lane loads
// its slices of scale and bias and of all its rows' x before it waits on
// any of them, so the affine's operands arrive with x; a row's fp32 sums of
// x and x^2 are warp shuffles; y goes out in 16-byte stores.  Other widths
// take the element route: a warp a row, a lane every 32nd element.
// Both use the fast-variance form max(E[x^2] - E[x]^2, 0) of flax's
// LayerNorm, rsqrt(var + eps), the affine and the optional mish in fp32,
// and write each row once.

#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int kMaxPerLane = 32;              // C <= 1024

__device__ __forceinline__ float mish(float y) {
  // softplus as logaddexp(y, 0), the stable form jax.nn.softplus uses
  const float sp = fmaxf(y, 0.f) + log1pf(expf(-fabsf(y)));
  return y * tanhf(sp);
}

// ------------------------------------------------------------- vector route

constexpr int kVecWarps = 4;

// rows a warp takes: two while a row is one vector a lane, else one
__host__ __device__ constexpr int rows_per_warp(int nv) { return nv >= 2 ? 1 : 2; }

// 16 bytes <-> VE floats (8 bf16 or 4 fp32)
__device__ __forceinline__ void unpack(const uint4& v, float* f, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& v, float* f, float) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ uint4 pack(const float* f, __nv_bfloat16) {
  uint4 v;
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = pack2(f[2 * i], f[2 * i + 1]);
  return v;
}
__device__ __forceinline__ uint4 pack(const float* f, float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

// x is read once: no L1 allocation
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

template <typename T, int NV>
__global__ void __launch_bounds__(kVecWarps * 32)
layer_norm_vec_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                      const T* __restrict__ bias, T* __restrict__ y, long long N, int C,
                      float eps, int act_mish) {
  constexpr int VE = 16 / sizeof(T);         // elements a vector
  constexpr int RPW = rows_per_warp(NV);
  const int lane = threadIdx.x & 31;
  const long long row0 = ((long long)blockIdx.x * kVecWarps + (threadIdx.x >> 5)) * RPW;
  if (row0 >= N) return;                     // whole warp leaves together

  // every load of the lane before any use: scale, bias, then the rows
  uint4 sv[NV], bv[NV], xv[RPW][NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    sv[j] = __ldg(reinterpret_cast<const uint4*>(scale) + j * 32 + lane);
    bv[j] = __ldg(reinterpret_cast<const uint4*>(bias) + j * 32 + lane);
  }
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (row0 + r < N) xv[r][j] = ld_stream(x + (row0 + r) * C + (j * 32 + lane) * VE);

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    if (row0 + r >= N) break;
    float v[NV][VE];
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      unpack(xv[r][j], v[j], T());
#pragma unroll
      for (int i = 0; i < VE; ++i) {
        s += v[j][i];
        ss += v[j][i] * v[j][i];
      }
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mean = s / C;
    const float var = fmaxf(ss / C - mean * mean, 0.f);
    const float inv = rsqrtf(var + eps);
    T* yr = y + (row0 + r) * C;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float g[VE], b[VE], o[VE];
      unpack(sv[j], g, T());
      unpack(bv[j], b, T());
#pragma unroll
      for (int i = 0; i < VE; ++i) {
        o[i] = (v[j][i] - mean) * inv * g[i] + b[i];
        if (act_mish) o[i] = mish(o[i]);
      }
      *reinterpret_cast<uint4*>(yr + (j * 32 + lane) * VE) = pack(o, T());
    }
  }
}

// ------------------------------------------------------------ element route

constexpr int kWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
fused_layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                        const T* __restrict__ bias, T* __restrict__ y, long long N,
                        int C, float eps, int act_mish) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= N) return;                      // whole warp leaves together
  const int per_lane = C / 32;
  const T* xr = x + row * C;
  float v[kMaxPerLane];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    if (i < per_lane) {
      v[i] = to_float(xr[lane + 32 * i]);
      s += v[i];
      ss += v[i] * v[i];
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mean = s / C;
  const float var = fmaxf(ss / C - mean * mean, 0.f);
  const float inv = rsqrtf(var + eps);
  T* yr = y + row * C;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    if (i < per_lane) {
      const int c = lane + 32 * i;
      float o = (v[i] - mean) * inv * to_float(scale[c]) + to_float(bias[c]);
      if (act_mish) o = mish(o);
      yr[c] = from_float<T>(o);
    }
  }
}

template <typename T, int NV>
void launch_vec(const void* x, const void* scale, const void* bias, void* y, long long N,
                int C, float eps, int act_mish, cudaStream_t s) {
  constexpr long long rows = kVecWarps * rows_per_warp(NV);
  layer_norm_vec_kernel<T, NV><<<(unsigned)((N + rows - 1) / rows), kVecWarps * 32, 0, s>>>(
      (const T*)x, (const T*)scale, (const T*)bias, (T*)y, N, C, eps, act_mish);
}

template <typename T>
void launch(const void* x, const void* scale, const void* bias, void* y, long long N, int C,
            float eps, int act_mish, cudaStream_t s) {
  constexpr int VE = 16 / sizeof(T);
  const bool aligned = ((uintptr_t)x | (uintptr_t)scale | (uintptr_t)bias | (uintptr_t)y) %
                           16 == 0;
  const int nv = C % (32 * VE) == 0 && aligned ? C / (32 * VE) : 0;
  switch (nv) {
    case 1: return launch_vec<T, 1>(x, scale, bias, y, N, C, eps, act_mish, s);
    case 2: return launch_vec<T, 2>(x, scale, bias, y, N, C, eps, act_mish, s);
    case 4: return launch_vec<T, 4>(x, scale, bias, y, N, C, eps, act_mish, s);
    default:
      fused_layer_norm_kernel<T><<<(unsigned)((N + kWarps - 1) / kWarps), kWarps * 32, 0, s>>>(
          (const T*)x, (const T*)scale, (const T*)bias, (T*)y, N, C, eps, act_mish);
  }
}

}  // namespace

extern "C" int cvt_fused_layer_norm(const void* x, const void* scale, const void* bias,
                                    void* y, long long N, int C, float eps, int act_mish,
                                    int dtype, void* stream) {
  if (C % 32 != 0 || C > 32 * kMaxPerLane) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kFloat32) launch<float>(x, scale, bias, y, N, C, eps, act_mish, s);
  else if (dtype == kBFloat16) launch<__nv_bfloat16>(x, scale, bias, y, N, C, eps, act_mish, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
