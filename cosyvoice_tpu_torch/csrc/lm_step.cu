// One whole B=1 Qwen2 decode step, all layers in one cooperative launch.
//
// Replaces: cosyvoice_tpu/ops/pallas/lm_step.py::lm_step_fused (the TPU's
// persistent whole-step decode kernel behind lm_generate_fused_step).
//
// Bound on the H100: bytes.  A step reads every int8 projection weight once
// (14.91 MB a layer, 357.8 MB for Qwen2-0.5B's 24 layers), their fp32 scales
// and the live KV cache rows; each weight byte serves 2 flops.  At 3.35 TB/s
// that is about 0.11 ms a step, against the ~1,100 eager launches a step
// costs layer by layer.
//
// Design.  The TPU kernel walked a sequential (layer, phase) grid with the
// hidden state in VMEM.  Here one persistent grid of (SMs x occupancy, at
// most 2) blocks runs every layer, and `grid.sync()` separates five phases
// per layer (5 * L - 1 barriers a step):
//   A  each block recomputes rms(x, n1) into shared memory (cheaper than a
//      barrier), then the QKV GEMV; a block owns whole 64-wide heads, so
//      RoPE's d <-> d+32 pairs stay in the block; bias and RoPE applied; q
//      goes to scratch, the new k/v straight into the cache at row `pos`
//      (attention reads rows <= pos only after the next barrier);
//   B  attention, one block per query head: scores of rows 0..pos (row pos
//      is the new token), a per-row max, exp2, probabilities rounded to the
//      cache dtype before the PV sum, division after it;
//   C  o-proj + residual;
//   D  rms(x, n2) per block, gate and up columns, silu(g) * u to scratch;
//   E  down-proj + residual.
// The GEMVs read the int8 weights ([in, out] layout) 16 bytes a thread and
// never materialise a dequantised copy; a block owns 16-64 output columns
// and its 8 warps split the input dim, adding partial sums in shared memory.
// The hidden state is the output buffer itself (each block updates only its
// own columns in C and E); q, o and the MLP vector live in fp32 scratch the
// wrapper allocates.  Buffers written inside the launch are read with
// L1-bypassing loads (__ldcg).
// Numerics mirror lm_step_xla op for op: int8 QDense = fp32-accumulated dot
// -> T -> * T(scale) -> + T(bias); RMSNorm in fp32; RoPE in fp32;
// q7 = T(q * sm * log2e); residual adds and silu(g) rounded to T.

#include "common.cuh"

#include <cooperative_groups.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHD = 64;                 // head_dim, the only width instantiated
constexpr int kMaxBlocksPerSM = 2;      // no phase has more than ~150 work items
constexpr int kErrNoCooperativeLaunch = -1;
constexpr int kErrGridTooLarge = -2;

template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_float(from_float<T>(v));
}

// loads of buffers that other blocks of this launch write: bypass L1
__device__ __forceinline__ float ld(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(__ldcg(p));
}

// 8 consecutive elements (16-byte aligned) as floats
__device__ __forceinline__ void ld8(const float* p, float* v) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void ld8(const __nv_bfloat16* p, float* v) {
  const uint4 a = __ldcg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ float block_sum(float v, float* stat) {
  v = warp_sum(v);
  __syncthreads();                                   // stat is free
  if ((threadIdx.x & 31) == 0) stat[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += stat[w];
  return t;
}

__device__ float block_max(float v, float* stat) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) stat[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t = fmaxf(t, stat[w]);
  return t;
}

// vec[i] = T(rms(x)[i] * g[i]) over the H hidden values, fp32 statistics
template <typename T>
__device__ void load_rms(const T* x, const float* g, int H, float eps, float* vec,
                         float* stat) {
  float ss = 0.f;
  for (int i = threadIdx.x; i < H; i += kThreads) {
    const float v = ld(x + i);
    vec[i] = v;
    ss += v * v;
  }
  const float r = rsqrtf(block_sum(ss, stat) / (float)H + eps);
  for (int i = threadIdx.x; i < H; i += kThreads)
    vec[i] = rnd<T>(__fmul_rn(__fmul_rn(vec[i], r), g[i]));
  __syncthreads();
}

// out[m * TC + c] = sum_k vec[k] * W_m[k, col0 + c] (fp32) for NM int8
// matrices [K, N] sharing the input vector (in shared memory).  Each thread
// reads 16 columns of one row per load; TC / 16 threads cover a row of the
// tile and the block walks 256 / (TC / 16) rows at a time.
template <int TC, int NM>
__device__ void gemv_tile(const float* vec, int K, const int8_t* W0, const int8_t* W1,
                          int N, int col0, float* red, float* out) {
  constexpr int TPR = TC / 16, RPS = kThreads / TPR;
  const int tid = threadIdx.x, seg = tid % TPR, lane = tid & 31, warp = tid >> 5;
  const int8_t* W[2] = {W0, W1};
  float acc[NM][16];
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = 0.f;
  const size_t c = (size_t)col0 + seg * 16;
#pragma unroll 4
  for (int k = tid / TPR; k < K; k += RPS) {
    const float v = vec[k];
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      const int4 raw = __ldg(reinterpret_cast<const int4*>(W[m] + (size_t)k * N + c));
      const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[m][j] += v * (float)b[j];
    }
  }
  // lanes with the same seg hold the same columns: add them within the warp
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int o = 16; o >= TPR; o >>= 1)
        acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], o);
  if (lane < TPR) {
#pragma unroll
    for (int m = 0; m < NM; ++m)
#pragma unroll
      for (int j = 0; j < 16; ++j) red[warp * NM * TC + m * TC + seg * 16 + j] = acc[m][j];
  }
  __syncthreads();
  for (int t = tid; t < NM * TC; t += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * NM * TC + t];
    out[t] = s;
  }
  __syncthreads();
}

template <typename T>
struct StepArgs {
  T* y;                       // [H] hidden state in, last layer's output out
  T* kc;                      // [L, C, nkv * 64] caches; row pos written
  T* vc;
  const float* cos;           // [64] RoPE at pos
  const float* sin;
  const int8_t* wqkv;         // [L, H, (nq + 2 nkv) * 64]
  const float* sqkv;
  const float* bqkv;
  const int8_t* wo;           // [L, nq * 64, H]
  const float* so;
  const int8_t* wg;           // [L, H, I]
  const float* sg;
  const int8_t* wu;
  const float* su;
  const int8_t* wd;           // [L, I, H]
  const float* sd;
  const float* n1;            // [L, H]
  const float* n2;
  float* work;                // q [nq * 64] | o [nq * 64] | m [I]
  int L, H, I, nq, nkv, C, pos;
  float eps, qscale;
};

// one query head's attention over cache rows 0..pos (row pos = new token)
template <typename T>
__device__ void attend(const StepArgs<T>& a, const T* kc, const T* vc, int hq,
                       float* vec, float* qs, float* red, float* stat) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int KHD = a.nkv * kHD, pos = a.pos;
  const int hh = hq / (a.nq / a.nkv);
  const float* wq = a.work;
  float* wo = a.work + a.nq * kHD;
  if (tid < kHD) qs[tid] = rnd<T>(__fmul_rn(ld(wq + hq * kHD + tid), a.qscale));
  __syncthreads();
  float mx = -INFINITY;
  for (int j = tid; j <= pos; j += kThreads) {
    const T* kr = kc + (size_t)j * KHD + hh * kHD;
    float s = 0.f;
#pragma unroll
    for (int d0 = 0; d0 < kHD; d0 += 8) {
      float kv[8];
      ld8(kr + d0, kv);
#pragma unroll
      for (int i = 0; i < 8; ++i) s += qs[d0 + i] * kv[i];
    }
    vec[j] = s;
    mx = fmaxf(mx, s);
  }
  mx = block_max(mx, stat);
  float den = 0.f;
  for (int j = tid; j < pos; j += kThreads) {
    const float p = exp2f(vec[j] - mx);
    den += p;
    vec[j] = rnd<T>(p);                 // probabilities in the cache dtype for PV
  }
  den = block_sum(den, stat);
  const float pn = exp2f(vec[pos] - mx);
  // PV: 8 segments of 8 dims x 32 key lanes
  const int dseg = tid & 7;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  for (int j = tid >> 3; j < pos; j += kThreads / 8) {
    float vv[8];
    ld8(vc + (size_t)j * KHD + hh * kHD + dseg * 8, vv);
    const float p = vec[j];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] += p * vv[i];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 8);
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 16);
  }
  if (lane < 8) {
#pragma unroll
    for (int i = 0; i < 8; ++i) red[warp * kHD + dseg * 8 + i] = acc[i];
  }
  __syncthreads();
  if (tid < kHD) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += red[w * kHD + tid];
    const float vh = ld(vc + (size_t)pos * KHD + hh * kHD + tid);
    o = __fdiv_rn(__fadd_rn(o, __fmul_rn(pn, vh)), __fadd_rn(den, pn));
    wo[hq * kHD + tid] = rnd<T>(o);
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSM)
lm_step_kernel(StepArgs<T> a) {
  extern __shared__ float vec[];        // the current phase's input vector
  __shared__ float red[kWarps * 64];
  __shared__ float out_s[64];
  __shared__ float t_s[64];
  __shared__ float qs[kHD];
  __shared__ float stat[kWarps];
  cg::grid_group grid = cg::this_grid();

  const int tid = threadIdx.x;
  const int H = a.H, I = a.I, nq = a.nq, nkv = a.nkv, C = a.C, pos = a.pos;
  const int KHD = nkv * kHD, QKVW = (nq + 2 * nkv) * kHD, NQD = nq * kHD;
  float* wq = a.work;
  float* wo = a.work + NQD;
  float* wm = a.work + 2 * NQD;

  for (int l = 0; l < a.L; ++l) {
    T* kc = a.kc + (size_t)l * C * KHD;
    T* vc = a.vc + (size_t)l * C * KHD;
    const float* sqkv = a.sqkv + (size_t)l * QKVW;
    const float* bqkv = a.bqkv + (size_t)l * QKVW;

    // A: rms1 -> QKV (+bias) -> RoPE; one 64-wide head per work item
    bool have = false;
    for (int item = blockIdx.x; item < nq + 2 * nkv; item += gridDim.x) {
      if (!have) {
        load_rms<T>(a.y, a.n1 + (size_t)l * H, H, a.eps, vec, stat);
        have = true;
      }
      gemv_tile<64, 1>(vec, H, a.wqkv + (size_t)l * H * QKVW, nullptr, QKVW, item * kHD,
                       red, out_s);
      if (tid < kHD) {
        const int col = item * kHD + tid;
        float v = rnd<T>(out_s[tid]);
        v = rnd<T>(v * rnd<T>(sqkv[col]));
        t_s[tid] = rnd<T>(v + rnd<T>(bqkv[col]));
      }
      __syncthreads();
      if (tid < kHD) {
        const float v = t_s[tid];
        if (item < nq + nkv) {
          const float rot = tid < kHD / 2 ? -t_s[tid + kHD / 2] : t_s[tid - kHD / 2];
          const float r = __fadd_rn(__fmul_rn(v, a.cos[tid]), __fmul_rn(rot, a.sin[tid]));
          if (item < nq) wq[item * kHD + tid] = r;
          else kc[(size_t)pos * KHD + (item - nq) * kHD + tid] = from_float<T>(r);
        } else {
          vc[(size_t)pos * KHD + (item - nq - nkv) * kHD + tid] = from_float<T>(v);
        }
      }
      __syncthreads();
    }
    grid.sync();

    // B: attention, one query head per work item
    for (int item = blockIdx.x; item < nq; item += gridDim.x)
      attend<T>(a, kc, vc, item, vec, qs, red, stat);
    grid.sync();

    // C: x += T(T(o @ wo) * so), 16 columns per work item
    have = false;
    for (int item = blockIdx.x; item < H / 16; item += gridDim.x) {
      if (!have) {
        for (int i = tid; i < NQD; i += kThreads) vec[i] = ld(wo + i);
        __syncthreads();
        have = true;
      }
      gemv_tile<16, 1>(vec, NQD, a.wo + (size_t)l * NQD * H, nullptr, H, item * 16, red,
                       out_s);
      if (tid < 16) {
        const int col = item * 16 + tid;
        const float d = rnd<T>(rnd<T>(out_s[tid]) * rnd<T>(a.so[(size_t)l * H + col]));
        a.y[col] = from_float<T>(ld(a.y + col) + d);
      }
    }
    grid.sync();

    // D: rms2 -> gate, up -> T(silu(g)) * u, 32 columns of each per work item
    have = false;
    for (int item = blockIdx.x; item < I / 32; item += gridDim.x) {
      if (!have) {
        load_rms<T>(a.y, a.n2 + (size_t)l * H, H, a.eps, vec, stat);
        have = true;
      }
      gemv_tile<32, 2>(vec, H, a.wg + (size_t)l * H * I, a.wu + (size_t)l * H * I, I,
                       item * 32, red, out_s);
      if (tid < 32) {
        const int col = item * 32 + tid;
        const float g = rnd<T>(rnd<T>(out_s[tid]) * rnd<T>(a.sg[(size_t)l * I + col]));
        const float u = rnd<T>(rnd<T>(out_s[32 + tid]) * rnd<T>(a.su[(size_t)l * I + col]));
        const float silu = rnd<T>(g * (1.f / (1.f + expf(-g))));
        wm[col] = rnd<T>(silu * u);
      }
    }
    grid.sync();

    // E: x += T(T(m @ wd) * sd), 16 columns per work item
    have = false;
    for (int item = blockIdx.x; item < H / 16; item += gridDim.x) {
      if (!have) {
        for (int i = tid; i < I; i += kThreads) vec[i] = ld(wm + i);
        __syncthreads();
        have = true;
      }
      gemv_tile<16, 1>(vec, I, a.wd + (size_t)l * I * H, nullptr, H, item * 16, red,
                       out_s);
      if (tid < 16) {
        const int col = item * 16 + tid;
        const float d = rnd<T>(rnd<T>(out_s[tid]) * rnd<T>(a.sd[(size_t)l * H + col]));
        a.y[col] = from_float<T>(ld(a.y + col) + d);
      }
    }
    if (l + 1 < a.L) grid.sync();
  }
}

__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSM) sync_probe_kernel(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}

size_t vec_bytes(int H, int I, int nq, int C) {
  int n = H > I ? H : I;
  if (nq * kHD > n) n = nq * kHD;
  if (C + 1 > n) n = C + 1;
  return (size_t)n * sizeof(float);
}

// blocks of the persistent grid: SMs x min(occupancy, kMaxBlocksPerSM)
template <typename T>
int step_grid(size_t smem, int* grid) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return kErrNoCooperativeLaunch;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(lm_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lm_step_kernel<T>, kThreads,
                                                      smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return kErrGridTooLarge;
  *grid = sms * (per_sm < kMaxBlocksPerSM ? per_sm : kMaxBlocksPerSM);
  return 0;
}

int launch_error(cudaError_t e) {
  return e == cudaErrorCooperativeLaunchTooLarge ? kErrGridTooLarge : (int)e;
}

template <typename T>
int launch(const StepArgs<T>& args, cudaStream_t stream) {
  const size_t smem = vec_bytes(args.H, args.I, args.nq, args.C);
  int grid = 0;
  const int rc = step_grid<T>(smem, &grid);
  if (rc) return rc;
  StepArgs<T> a = args;
  void* params[] = {&a};
  return launch_error(cudaLaunchCooperativeKernel((const void*)lm_step_kernel<T>, dim3(grid),
                                                  dim3(kThreads), params, smem, stream));
}

}  // namespace

extern "C" int cvt_lm_step(void* y, void* kc, void* vc, const void* cos, const void* sin,
                           const void* wqkv, const void* sqkv, const void* bqkv,
                           const void* wo, const void* so, const void* wg, const void* sg,
                           const void* wu, const void* su, const void* wd, const void* sd,
                           const void* n1, const void* n2, void* work, int L, int H, int I,
                           int nq, int nkv, int C, int pos, float eps, float qscale,
                           int dtype, void* stream) {
  if (L < 1 || H % 64 || I % 64 || nkv < 1 || nq % nkv || pos < 0 || pos >= C)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define K6_ARGS(T)                                                                    \
  StepArgs<T>{(T*)y, (T*)kc, (T*)vc, (const float*)cos, (const float*)sin,            \
              (const int8_t*)wqkv, (const float*)sqkv, (const float*)bqkv,            \
              (const int8_t*)wo, (const float*)so, (const int8_t*)wg, (const float*)sg, \
              (const int8_t*)wu, (const float*)su, (const int8_t*)wd, (const float*)sd, \
              (const float*)n1, (const float*)n2, (float*)work, L, H, I, nq, nkv, C, pos, \
              eps, qscale}
  if (dtype == kFloat32) return launch<float>(K6_ARGS(float), s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(K6_ARGS(__nv_bfloat16), s);
#undef K6_ARGS
  return (int)cudaErrorInvalidValue;
}

// n_syncs grid barriers on the grid lm_step would launch with (to measure
// the barriers' share of a step); writes that grid's block count.
extern "C" int cvt_lm_step_sync_probe(int n_syncs, int H, int I, int nq, int C, int dtype,
                                      int* grid_out, void* stream) {
  const size_t smem = vec_bytes(H, I, nq, C);
  int grid = 0;
  const int rc = dtype == kFloat32 ? step_grid<float>(smem, &grid)
                                   : step_grid<__nv_bfloat16>(smem, &grid);
  if (rc) return rc;
  *grid_out = grid;
  void* params[] = {&n_syncs};
  return launch_error(cudaLaunchCooperativeKernel((const void*)sync_probe_kernel, dim3(grid),
                                                  dim3(kThreads), params, 0,
                                                  (cudaStream_t)stream));
}
