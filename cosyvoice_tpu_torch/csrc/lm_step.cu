// One whole B=1 Qwen2 decode step, all layers in one cooperative launch.
//
// Replaces: cosyvoice_tpu/ops/pallas/lm_step.py::lm_step_fused (the TPU's
// persistent whole-step decode kernel behind lm_generate_fused_step).
//
// Bound on the H100: bytes.  A step reads every int8 projection weight once
// (14.91 MB a layer, 357.8 MB for Qwen2-0.5B's 24 layers), their fp32 scales
// and the live KV cache rows; each weight byte serves 2 flops.  At 3.35 TB/s
// that is about 0.11 ms a step.
//
// Design: every SM streams its share of every phase's weights, a layer ahead
// of the phase that reads it.
//   Grid: one block of 512 threads an SM, cooperative; `grid.sync()`
//   separates five phases a layer:
//     A  x, then rms(x, n1) in every block, then the qkv GEMV, split-K;
//     B  attention over key chunks: the block of (kv head, chunk) adds up
//        the qkv partials of its heads, applies bias and RoPE (the block
//        whose chunk holds `pos` writes the new k/v into the cache), scores
//        its chunk, one warp a query head, and writes (max, sum, acc);
//     C  each o-proj block merges the chunks of the rows it reads, then its
//        GEMV share;
//     D  x + o-proj, then rms(., n2), then the gate and up GEMVs, split-K;
//     E  each down-proj block adds the gate/up partials of its rows,
//        T(silu(g)) * u, then its GEMV share.
//   Plan: the host (ops/kernels/lm_step.py `plan`) cuts each GEMV phase into
//   column tiles x input-row splits, at most one item a block, minimising
//   the largest item; at Qwen2-0.5B on 132 SMs: qkv 18 x 7 of 64 columns x
//   128 rows, o-proj 14 x 9 of 64 x 100, gate+up 38 x 3 of 128 x 299 (two
//   matrices), down 14 x 9 of 64 x 541; attention chunks of 32 keys, widened
//   until nkv x chunks fits the grid.  A block's share of a phase is fixed
//   by the shapes, and its five shares of a layer fit in shared memory
//   together (about 140 KB at Qwen2-0.5B: each phase has a region of its
//   own), so as soon as a phase has consumed its share the block issues
//   cp.async copies of the same phase's share of the next layer (weights,
//   or the K/V rows < pos of its chunk, and the fp32 vectors the phase
//   reads) into that region: every copy is in flight a whole layer ahead,
//   and the memory pipe does not drain at a barrier.
//   int8 -> fp32 without an I2F: four weights a word, each byte (xor 0x80)
//   permuted into the mantissa of 2^23, minus 2^23 + 128, exact.
//   Split-K partials are fp32 in scratch the wrapper keeps per (device,
//   stream).  No block waits on another outside the barriers: a phase that
//   needs the residual stream (A, D) computes x + T(T(sum of the last
//   GEMV's partials) * T(scale)) for all H values in every block that needs
//   it, block 0 keeping it in scratch for the next such phase; every sum of
//   partials runs in a fixed order, so all blocks, and two launches on the
//   same inputs, give the same bits.  The step's output is written after
//   one more barrier (5 * L a step).
// Numerics mirror lm_step_xla op for op: int8 QDense = fp32-accumulated dot
// -> T -> * T(scale) -> + T(bias); RMSNorm in fp32; RoPE in fp32;
// q7 = T(q * sm * log2e); residual adds and silu(g) rounded to T.  The
// probabilities of cached keys are rounded to T against their chunk's max
// (the TPU kernel rounds them against the row max; the split-key decode
// attention kernel, lm_decode_attention.cu, rounds as here); the new
// token's is not rounded.

#include "common.cuh"

#include <cooperative_groups.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kHD = 64;                 // head_dim, the only width instantiated
constexpr int kAttnStride = 2 + kHD;    // a chunk's partial: max, sum, acc[64]
constexpr int kErrNoCooperativeLaunch = -1;
constexpr int kErrGridTooLarge = -2;
constexpr int kErrPlan = -3;

// GEMV phases (index into Plan): qkv, o-proj, gate+up, down
enum { kQKV = 0, kO = 1, kGU = 2, kDown = 3 };

struct Plan {
  int tc[4];        // columns a tile
  int splits[4];    // input-row splits a tile
  int rows[4];      // input rows a split (the last split may hold fewer)
  int chunk;        // keys an attention chunk
  int region[6];    // byte offsets of the phases' shared-memory regions (A-E), end
  int red;          // floats a warp's row of the cross-warp reduction
};

template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_float(from_float<T>(v));
}

// loads of buffers that other blocks of this launch write: bypass L1
__device__ __forceinline__ float ld(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(__ldcg(p));
}

// 8 consecutive values (16-byte aligned, shared memory) as floats
__device__ __forceinline__ void ld8s(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void ld8s(const __nv_bfloat16* p, float* v) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

// byte i of w (int8) as an exact float: (b ^ 0x80) = b + 128 in the mantissa
// of 2^23, minus 2^23 + 128
__device__ __forceinline__ float i8f(uint32_t w_xor, int i) {
  return __uint_as_float(__byte_perm(w_xor, 0x4B000000u, 0x7540u + i)) - 8388736.f;
}

__device__ __forceinline__ void fma16(float (&acc)[16], float v, uint4 w) {
  const uint32_t q[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u, w.z ^ 0x80808080u,
                         w.w ^ 0x80808080u};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[4 * j + i] = fmaf(v, i8f(q[j], i), acc[4 * j + i]);
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

// sum_{i < n} p[i * stride] in order of i, 8 loads in flight at a time (the
// partials other blocks of this launch wrote: through L2)
__device__ __forceinline__ float sum_parts(const float* p, int n, size_t stride) {
  float s = 0.f;
  for (int i0 = 0; i0 < n; i0 += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = i0 + u < n ? __ldcg(p + (i0 + u) * stride) : 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u) s += v[u];
  }
  return s;
}

// The residual stream without arrival counters: a layer's x is
// y = T(base + T(T(sum of the splits' partials) * T(scale))) of the last
// GEMV before it, and every block that needs y computes it from the same
// inputs in the same order (so all hold the same bits).  vec[i] = y[i]
// (x0[i] itself where x0 is given) for the H hidden values; block 0 also
// stores y to `out`; then vec = T(rms(y) * g) with fp32 statistics.  g and
// scale lie in shared memory; a thread's loads are all issued before any is
// used (S <= kMaxSplits in one round).
constexpr int kMaxSplits = 16;
template <typename T>
__device__ void residual_rms(const T* x0, const float* base, const float* part, int S,
                             const float* scale, const float* g, float* out, int H, float eps,
                             float* vec, float* stat) {
  constexpr int kPer = 2;                             // values a thread a pass
  float ss = 0.f;
  for (int i0 = threadIdx.x; i0 < H; i0 += kPer * kThreads) {
    float b[kPer], v[kPer][kMaxSplits];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = i0 + u * kThreads;
      b[u] = i >= H ? 0.f : x0 ? ld(x0 + i) : __ldcg(base + i);
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s)
        v[u][s] = !x0 && i < H && s < S ? __ldcg(part + (size_t)s * H + i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= H) continue;
      float y = b[u];
      if (!x0) {
        float sum = 0.f;
#pragma unroll
        for (int s = 0; s < kMaxSplits; ++s) sum += v[u][s];
        for (int s = kMaxSplits; s < S; ++s) sum += __ldcg(part + (size_t)s * H + i);
        y = rnd<T>(y + rnd<T>(rnd<T>(sum) * rnd<T>(scale[i])));
      }
      vec[i] = y;
      if (out) out[i] = y;
      ss += y * y;
    }
  }
  const float r = rsqrtf(block_sum(ss, stat) / (float)H + eps);
  for (int i = threadIdx.x; i < H; i += kThreads)
    vec[i] = rnd<T>(__fmul_rn(__fmul_rn(vec[i], r), g[i]));
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
  float* work;                // fp32 partials and residual stream (layout in lm_step_kernel)
  int L, H, I, nq, nkv, C, pos;
  float eps, qscale;
  Plan p;
};

// one GEMV phase of one layer: NM int8 matrices [K, N] sharing the input
struct Gemv {
  const int8_t* w0;
  const int8_t* w1;
  int K, N, nm, tc, splits, rows;
  // this block's item
  bool have;
  int tile, split, r0, nr, col0;
};

template <typename T>
__device__ __forceinline__ Gemv gemv_of(const StepArgs<T>& a, int l, int which) {
  const int QKVW = (a.nq + 2 * a.nkv) * kHD, NQD = a.nq * kHD;
  Gemv g;
  g.w1 = nullptr;
  g.nm = 1;
  if (which == kQKV) {
    g.w0 = a.wqkv + (size_t)l * a.H * QKVW; g.K = a.H; g.N = QKVW;
  } else if (which == kO) {
    g.w0 = a.wo + (size_t)l * NQD * a.H; g.K = NQD; g.N = a.H;
  } else if (which == kGU) {
    g.w0 = a.wg + (size_t)l * a.H * a.I; g.w1 = a.wu + (size_t)l * a.H * a.I;
    g.K = a.H; g.N = a.I; g.nm = 2;
  } else {
    g.w0 = a.wd + (size_t)l * a.I * a.H; g.K = a.I; g.N = a.H;
  }
  g.tc = a.p.tc[which];
  g.splits = a.p.splits[which];
  g.rows = a.p.rows[which];
  const int items = g.N / g.tc * g.splits;
  g.have = (int)blockIdx.x < items;
  g.tile = blockIdx.x / g.splits;
  g.split = blockIdx.x % g.splits;
  g.r0 = g.split * g.rows;
  g.nr = max(0, min(g.rows, g.K - g.r0));
  g.col0 = g.tile * g.tc;
  return g;
}

// A slot holds a phase's share of weights (or K/V rows) and, behind it, the
// fp32 vectors that phase reads (norm weights, scales, biases), so no
// dependent load of the phase goes to device memory for them.
__device__ __forceinline__ float* side(const Gemv& g, unsigned char* slot) {
  return reinterpret_cast<float*>(slot + ((size_t)g.nm * g.rows * g.tc + 15) / 16 * 16);
}

// this block's share of a GEMV phase into its region: [m][rows][tc] bytes (tc
// a power of two, so rows and 16-byte pieces come from shifts)
__device__ void prefetch_gemv(const Gemv& g, unsigned char* slot) {
  const int sh = __ffs(g.tc / 16) - 1, per = g.nr << sh, mask = (1 << sh) - 1;
  for (int m = 0; m < g.nm; ++m) {
    const int8_t* w = (m ? g.w1 : g.w0) + (size_t)g.r0 * g.N + g.col0;
    unsigned char* d = slot + (size_t)m * g.rows * g.tc;
    for (int i = threadIdx.x; i < per; i += kThreads) {
      const int r = i >> sh, c = 16 * (i & mask);
      cp16(d + (size_t)r * g.tc + c, w + (size_t)r * g.N + c);
    }
  }
}

__device__ __forceinline__ void prefetch_vec(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) cp4(dst + i, src + i);
}

// chunks of the longest cache (pos = C - 1): a head's stride in the scratch
template <typename T>
__device__ __forceinline__ int chunks_max(const StepArgs<T>& a) {
  return (a.C + a.p.chunk - 1) / a.p.chunk;
}

// the attention item of this block: kv head hh, chunk c of nch live chunks
struct Chunk {
  bool have;
  int hh, c, nch, j0, nk;    // keys j0 .. j0 + nk - 1 (the last one may be pos)
};

template <typename T>
__device__ __forceinline__ Chunk chunk_of(const StepArgs<T>& a) {
  Chunk k;
  k.nch = (a.pos + a.p.chunk) / a.p.chunk;           // ceil((pos + 1) / chunk)
  k.have = (int)blockIdx.x < a.nkv * k.nch;
  k.hh = blockIdx.x / k.nch;
  k.c = blockIdx.x % k.nch;
  k.j0 = k.c * a.p.chunk;
  k.nk = min(a.p.chunk, a.pos + 1 - k.j0);
  return k;
}

// bytes of a cached K or V row of one head in a slot: 64 values, padded by
// 16 bytes so that the rows a warp reads 16 bytes at a time hit distinct banks
template <typename T> __host__ __device__ constexpr int kv_row_bytes() {
  return kHD * (int)sizeof(T) + 16;
}

// the attention slot: K rows [chunk], V rows [chunk], then the side vectors:
// scale and bias of the group's q columns and of the head's k and v columns,
// [scale q (grp * 64) | k | v | bias q | k | v]
template <typename T>
__device__ __forceinline__ float* attn_side(const StepArgs<T>& a, unsigned char* slot) {
  return reinterpret_cast<float*>(slot + 2 * (size_t)a.p.chunk * kv_row_bytes<T>());
}

template <typename T>
__device__ void prefetch_attn(const StepArgs<T>& a, int l, unsigned char* slot) {
  const Chunk k = chunk_of(a);
  if (!k.have) return;
  constexpr int cpr = kHD * (int)sizeof(T) / 16, sh = cpr == 8 ? 3 : 4;
  const int n = min(k.nk, a.pos - k.j0), KHD = a.nkv * kHD;
  for (int kv = 0; kv < 2; ++kv) {
    const T* src = (kv ? a.vc : a.kc) + ((size_t)l * a.C + k.j0) * KHD + k.hh * kHD;
    unsigned char* dst = slot + (size_t)kv * a.p.chunk * kv_row_bytes<T>();
    for (int i = threadIdx.x; i < (n << sh); i += kThreads) {
      const int r = i >> sh, c = 16 * (i & (cpr - 1));
      cp16(dst + (size_t)r * kv_row_bytes<T>() + c,
           reinterpret_cast<const unsigned char*>(src + (size_t)r * KHD) + c);
    }
  }
  const int grp = a.nq / a.nkv, QKVW = (a.nq + 2 * a.nkv) * kHD;
  float* v = attn_side(a, slot);
  for (int sb = 0; sb < 2; ++sb) {
    const float* src = (sb ? a.bqkv : a.sqkv) + (size_t)l * QKVW;
    float* d = v + sb * (grp + 2) * kHD;
    prefetch_vec(d, src + k.hh * grp * kHD, grp * kHD);
    prefetch_vec(d + grp * kHD, src + (a.nq + k.hh) * kHD, kHD);
    prefetch_vec(d + (grp + 1) * kHD, src + (a.nq + a.nkv + k.hh) * kHD, kHD);
  }
}

// the E phase's side vectors: the gate and up scales of its rows, each copied
// from the 16-byte boundary at or below r0, at a stride of side_rows floats
__device__ __forceinline__ int side_rows(const Gemv& g) { return (g.rows + 4 + 3) / 4 * 4; }

// issue the copies of phase ph (0-4: A-E) of layer l into its region and
// commit them as one group (an empty one past the last layer, or where this
// block has no item in the phase)
template <typename T>
__device__ void prefetch(const StepArgs<T>& a, int l, int ph, unsigned char* slot) {
  if (l < a.L && ph == 1) {
    prefetch_attn(a, l, slot);
  } else if (l < a.L) {
    const Gemv G = gemv_of(a, l, ph == 0 ? kQKV : ph - 1);
    if (G.have) {
      prefetch_gemv(G, slot);
      float* v = side(G, slot);
      const size_t lh = (size_t)l * a.H, li = (size_t)l * a.I;
      if (ph == 0) {                                  // norm weights, the last down-proj's scales
        prefetch_vec(v, a.n1 + lh, a.H);
        if (l > 0) prefetch_vec(v + a.H, a.sd + lh - a.H, a.H);
      }
      if (ph == 3) {                                  // norm weights, the o-proj's scales
        prefetch_vec(v, a.n2 + lh, a.H);
        prefetch_vec(v + a.H, a.so + lh, a.H);
      }
      if (ph == 4) {                                  // the rows' gate and up scales
        const int a0 = G.r0 & ~3, n = ((G.r0 + G.nr + 3) & ~3) - a0;
        prefetch_vec(v, a.sg + li + a0, n);
        prefetch_vec(v + side_rows(G), a.su + li + a0, n);
      }
    }
  }
  cp_async_commit();
}

// part[split][m][N] (columns col0 .. col0 + tc) = sum_r vec[r] * W_m[r0 + r]
// over this block's share in `slot`.  A thread owns 16 columns of one matrix
// and every (kThreads / TPR)-th row; lanes of a column segment add by
// shuffles, warps in shared memory in a fixed order.
__device__ void gemv_slot(const Gemv& g, const float* vec, const unsigned char* slot,
                          float* red, float* part) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tpr = g.tc * g.nm / 16, seg = tid % tpr, rps = kThreads / tpr;
  const int m = seg / (g.tc / 16), c16 = 16 * (seg % (g.tc / 16));
  const unsigned char* base = slot + (size_t)m * g.rows * g.tc + c16;
  float acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0.f;
#pragma unroll 4
  for (int r = tid / tpr; r < g.nr; r += rps)
    fma16(acc, vec[r], *reinterpret_cast<const uint4*>(base + (size_t)r * g.tc));
  for (int o = 16; o >= tpr; o >>= 1)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
  const int w = g.tc * g.nm;
  if (lane < tpr) {
#pragma unroll
    for (int j = 0; j < 16; ++j) red[warp * w + seg * 16 + j] = acc[j];
  }
  __syncthreads();
  for (int t = tid; t < w; t += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) s += red[v * w + t];
    const int mm = t / g.tc, c = t - mm * g.tc;
    part[((size_t)g.split * g.nm + mm) * g.N + g.col0 + c] = s;
  }
}

// QDense epilogue of a qkv value from its split partials:
// T(T(T(sum) * T(scale)) + T(bias))
template <typename T>
__device__ __forceinline__ float qkv_value(const float* part, int splits, int QKVW, float sc,
                                           float bc) {
  const float v = sum_parts(part, splits, QKVW);
  return rnd<T>(rnd<T>(rnd<T>(v) * rnd<T>(sc)) + rnd<T>(bc));
}

// RoPE of value d of a head t[0..63] (fp32)
__device__ __forceinline__ float rope(const float* t, int d, const float* cs, const float* sn) {
  const float rot = d < kHD / 2 ? -t[d + kHD / 2] : t[d - kHD / 2];
  return __fadd_rn(__fmul_rn(t[d], cs[d]), __fmul_rn(rot, sn[d]));
}

// Phase B for this block's (kv head, chunk): (max, sum, acc) of every query
// head of the group over the chunk's keys, into att[hq][c]
template <typename T>
__device__ void attend_chunk(const StepArgs<T>& a, int l, const Chunk& k, unsigned char* slot,
                             float* vec, float* att) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = a.nq / a.nkv, hq0 = k.hh * grp, KHD = a.nkv * kHD;
  const int QKVW = (a.nq + 2 * a.nkv) * kHD, S = a.p.splits[kQKV], CH = a.p.chunk;
  const float* qkvp = a.work;
  const bool self = k.c == k.nch - 1;                 // the chunk holding pos
  const int ncached = self ? k.nk - 1 : k.nk;         // keys read from the cache
  float* tq = vec;                                    // [grp * 64] q before RoPE
  float* tk = tq + grp * kHD;                         // [64] new k before RoPE
  float* tv = tk + kHD;                               // [64] new v
  float* qs = tv + kHD;                               // [grp * 64] T(rope(q) * qscale)
  float* kr = qs + grp * kHD;                         // [64] T(rope(k))
  float* sc = kr + kHD;                               // [grp][CH] scores, then p
  // this block's qkv columns into tq | tk | tv: q of the group, then (the
  // chunk of pos) k and v
  const int ncol = (grp + (self ? 2 : 0)) * kHD;
  const float* sv = attn_side(a, slot);
  for (int t = tid; t < ncol; t += kThreads) {
    const int col = t < grp * kHD ? (hq0 * kHD + t)
                                  : (t < (grp + 1) * kHD ? (a.nq + k.hh) * kHD + t - grp * kHD
                                                         : (a.nq + a.nkv + k.hh) * kHD + t -
                                                               (grp + 1) * kHD);
    tq[t] = qkv_value<T>(qkvp + col, S, QKVW, sv[t], sv[(grp + 2) * kHD + t]);
  }
  __syncthreads();
  for (int t = tid; t < grp * kHD; t += kThreads) {
    const int h = t / kHD, d = t % kHD;
    qs[t] = rnd<T>(__fmul_rn(rope(tq + h * kHD, d, a.cos, a.sin), a.qscale));
  }
  if (self && tid < kHD) {
    const float r = rope(tk, tid, a.cos, a.sin);
    kr[tid] = rnd<T>(r);
    const size_t row = ((size_t)l * a.C + a.pos) * KHD + k.hh * kHD + tid;
    a.kc[row] = from_float<T>(r);
    a.vc[row] = from_float<T>(tv[tid]);
  }
  __syncthreads();
  constexpr int rs = kv_row_bytes<T>();
  const unsigned char* krows = slot;
  const unsigned char* vrows = slot + (size_t)CH * rs;
  for (int h = warp; h < grp; h += kWarps) {
    const float* q = qs + h * kHD;
    float* p = sc + h * CH;
    float mx = -INFINITY;
    for (int i = lane; i < k.nk; i += 32) {
      float s = 0.f;
      if (i == ncached) {                             // the new token
#pragma unroll 8
        for (int d = 0; d < kHD; ++d) s += q[d] * kr[d];
      } else {                                        // 16-byte loads: rows 16 bytes apart in banks
        const T* kv = reinterpret_cast<const T*>(krows + (size_t)i * rs);
#pragma unroll
        for (int d0 = 0; d0 < kHD; d0 += 8) {
          float kf[8];
          ld8s(kv + d0, kf);
#pragma unroll
          for (int d = 0; d < 8; ++d) s += q[d0 + d] * kf[d];
        }
      }
      p[i] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float den = 0.f;
    for (int i = lane; i < k.nk; i += 32) {
      const float e = exp2f(p[i] - mx);
      den += e;
      p[i] = i == ncached ? e : rnd<T>(e);           // cached keys' p in the cache dtype
    }
    den = warp_sum(den);
    __syncwarp();
    float o0 = 0.f, o1 = 0.f;
#pragma unroll 4
    for (int i = 0; i < ncached; ++i) {
      const float pi = p[i];
      const T* vv = reinterpret_cast<const T*>(vrows + (size_t)i * rs);
      o0 += pi * to_float(vv[lane]);
      o1 += pi * to_float(vv[lane + 32]);
    }
    if (self) {
      o0 += p[ncached] * tv[lane];
      o1 += p[ncached] * tv[lane + 32];
    }
    float* out = att + ((size_t)(hq0 + h) * chunks_max(a) + k.c) * kAttnStride;
    if (lane == 0) {
      out[0] = mx;
      out[1] = den;
    }
    out[2 + lane] = o0;
    out[2 + lane + 32] = o1;
  }
}

// Phase C's input: o rows r0 .. r0 + nr of the attention, merged over the
// key chunks: a warp a head computes the chunks' weights exp2(m_c - max m)
// and the merged sum of l_c into wts while every row's first kBatch chunk
// accumulators are in flight; then o = T(sum_c w_c acc_c / sum_c w_c l_c)
template <typename T>
__device__ void merge_rows(const StepArgs<T>& a, const Gemv& g, const float* att, float* vec) {
  constexpr int kBatch = 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cm = chunks_max(a), nch = (a.pos + a.p.chunk) / a.p.chunk;
  const int h0 = g.r0 / kHD, nh = (g.r0 + g.nr - 1) / kHD - h0 + 1;
  float* wts = vec + a.p.rows[kO];                    // [nh][cm + 1]
  const bool row_thread = tid < g.nr;                 // rows <= kThreads (the plan's o rows)
  const int h = row_thread ? (g.r0 + tid) / kHD - h0 : 0, d = (g.r0 + tid) % kHD;
  const float* ap = att + (size_t)(h0 + h) * cm * kAttnStride + 2 + d;
  float v[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u)
    v[u] = row_thread && u < nch ? __ldcg(ap + (size_t)u * kAttnStride) : 0.f;
  for (int hh = warp; hh < nh; hh += kWarps) {
    const float* hp = att + (size_t)(h0 + hh) * cm * kAttnStride;
    // chunk `lane` in registers (one round trip); chunks past 32 reloaded
    const float m0 = lane < nch ? __ldcg(hp + lane * kAttnStride) : -INFINITY;
    const float l0 = lane < nch ? __ldcg(hp + lane * kAttnStride + 1) : 0.f;
    float mx = m0;
    for (int c = lane + 32; c < nch; c += 32) mx = fmaxf(mx, __ldcg(hp + c * kAttnStride));
    mx = warp_max(mx);
    float den = 0.f;
    if (lane < nch) {
      const float e = exp2f(m0 - mx);
      wts[hh * (cm + 1) + lane] = e;
      den = e * l0;
    }
    for (int c = lane + 32; c < nch; c += 32) {
      const float e = exp2f(__ldcg(hp + c * kAttnStride) - mx);
      wts[hh * (cm + 1) + c] = e;
      den += e * __ldcg(hp + c * kAttnStride + 1);
    }
    den = warp_sum(den);
    if (lane == 0) wts[hh * (cm + 1) + cm] = den;
  }
  __syncthreads();
  if (!row_thread) return;
  const float* w = wts + h * (cm + 1);
  float num = 0.f;
#pragma unroll
  for (int u = 0; u < kBatch; ++u) num += u < nch ? w[u] * v[u] : 0.f;
  for (int c = kBatch; c < nch; ++c) num += w[c] * __ldcg(ap + (size_t)c * kAttnStride);
  vec[tid] = rnd<T>(__fdiv_rn(num, w[cm]));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) lm_step_kernel(StepArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float stat[kWarps];
  cg::grid_group grid = cg::this_grid();
  // phase ph's region: its share of this layer, then of the next
  auto region = [&](int ph) { return smem + a.p.region[ph]; };
  float* red = reinterpret_cast<float*>(smem + a.p.region[5]);
  float* vec = red + kWarps * a.p.red;

  const int tid = threadIdx.x, H = a.H, I = a.I;
  const int QKVW = (a.nq + 2 * a.nkv) * kHD, So = a.p.splits[kO], Sd = a.p.splits[kDown];
  // scratch: qkv [S_qkv][QKVW] | attention [nq][chunks][66] | o [S_o][H] |
  // gate/up [S_gu][2][I] | down [S_down][H] | residual stream: x [H], x after
  // attention [H]
  float* qkvp = a.work;
  float* att = qkvp + (size_t)a.p.splits[kQKV] * QKVW;
  float* op = att + (size_t)a.nq * chunks_max(a) * kAttnStride;
  float* gup = op + (size_t)So * H;
  float* dp = gup + (size_t)a.p.splits[kGU] * 2 * I;
  float* y0 = dp + (size_t)Sd * H;
  float* y1 = y0 + H;

  // Each phase commits one group of copies (its share of the next layer), so
  // a phase's own share is the group committed five groups back: wait until
  // at most four are pending.  Layer 0's five shares go out first.
  for (int ph = 0; ph < 5; ++ph) prefetch(a, 0, ph, region(ph));
  for (int l = 0; l < a.L; ++l) {
    // A: x = the last layer's y1 + its down-proj (the input itself at l = 0)
    // -> rms1 -> qkv partials
    {
      const Gemv g = gemv_of(a, l, kQKV);
      cp_async_wait<4>();
      __syncthreads();
      if (g.have) {
        const float* sv = side(g, region(0));         // n1 | the last layer's sd
        residual_rms<T>(l == 0 ? a.y : nullptr, y1, dp, Sd, sv + H, sv,
                        blockIdx.x == 0 ? y0 : nullptr, H, a.eps, vec, stat);
        gemv_slot(g, vec + g.r0, region(0), red, qkvp);
      }
      __syncthreads();                                // region A consumed
      prefetch(a, l + 1, 0, region(0));
    }
    grid.sync();

    // B: attention over key chunks
    {
      const Chunk k = chunk_of(a);
      cp_async_wait<4>();
      __syncthreads();
      if (k.have) attend_chunk<T>(a, l, k, region(1), vec, att);
      __syncthreads();
      prefetch(a, l + 1, 1, region(1));
    }
    grid.sync();

    // C: merge the chunks of this block's o rows -> o-proj partials
    {
      const Gemv g = gemv_of(a, l, kO);
      if (g.have && g.nr > 0) merge_rows<T>(a, g, att, vec);
      cp_async_wait<4>();
      __syncthreads();                                // the merged rows in vec
      if (g.have) gemv_slot(g, vec, region(2), red, op);
      __syncthreads();
      prefetch(a, l + 1, 2, region(2));
    }
    grid.sync();

    // D: y1 = x + o-proj -> rms2 -> gate and up partials
    {
      const Gemv g = gemv_of(a, l, kGU);
      cp_async_wait<4>();
      __syncthreads();
      if (g.have) {
        const float* sv = side(g, region(3));         // n2 | so
        residual_rms<T>(nullptr, y0, op, So, sv + H, sv, blockIdx.x == 0 ? y1 : nullptr, H,
                        a.eps, vec, stat);
        gemv_slot(g, vec + g.r0, region(3), red, gup);
      }
      __syncthreads();
      prefetch(a, l + 1, 3, region(3));
    }
    grid.sync();

    // E: T(silu(g)) * u for this block's rows -> down partials
    {
      const Gemv g = gemv_of(a, l, kDown);
      const int S = a.p.splits[kGU];
      float gs = 0.f, us = 0.f;                       // partial sums in flight before the wait
      if (g.have && tid < g.nr) {
        gs = sum_parts(gup + g.r0 + tid, S, 2 * (size_t)I);
        us = sum_parts(gup + I + g.r0 + tid, S, 2 * (size_t)I);
      }
      cp_async_wait<4>();
      __syncthreads();
      if (g.have) {
        const float* sv = side(g, region(4)) + (g.r0 & 3);   // sg rows | su rows
        for (int r = tid; r < g.nr; r += kThreads) {
          if (r != tid) {
            gs = sum_parts(gup + g.r0 + r, S, 2 * (size_t)I);
            us = sum_parts(gup + I + g.r0 + r, S, 2 * (size_t)I);
          }
          const float gv = rnd<T>(rnd<T>(gs) * rnd<T>(sv[r]));
          const float uv = rnd<T>(rnd<T>(us) * rnd<T>(sv[side_rows(g) + r]));
          const float silu = rnd<T>(gv * (1.f / (1.f + expf(-gv))));
          vec[r] = rnd<T>(silu * uv);
        }
        __syncthreads();
        gemv_slot(g, vec, region(4), red, dp);
      }
      __syncthreads();
      prefetch(a, l + 1, 4, region(4));
    }
    grid.sync();
  }
  cp_async_wait<0>();
  // the step's output: y1 + the last down-proj, a slice of the columns a block
  const float* sd = a.sd + (size_t)(a.L - 1) * H;
  for (int i = blockIdx.x * kThreads + tid; i < H; i += gridDim.x * kThreads) {
    const float sum = sum_parts(dp + i, Sd, H);
    a.y[i] = from_float<T>(__ldcg(y1 + i) + rnd<T>(rnd<T>(sum) * rnd<T>(sd[i])));
  }
}

__global__ void __launch_bounds__(kThreads, 1) sync_probe_kernel(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}

// the exact int8 -> fp32 conversion the GEMVs use, for testing it
__global__ void i8f_kernel(const int8_t* in, float* out, int n) {
  const int i = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
  const uint32_t w = *reinterpret_cast<const uint32_t*>(in + i) ^ 0x80808080u;
  for (int j = 0; j < 4 && i + j < n; ++j) out[i + j] = i8f(w, j);
}

// The plan's shapes for these widths, checked; the slot, reduction and
// vector sizes filled in; the dynamic shared memory the kernel takes.
int check_plan(Plan& p, int H, int I, int nq, int nkv, int C, int itemsize, int grid,
               size_t* smem) {
  const int QKVW = (nq + 2 * nkv) * kHD, grp = nq / nkv;
  const int K[4] = {H, nq * kHD, H, I}, N[4] = {QKVW, H, I, H}, NM[4] = {1, 1, 2, 1};
  size_t need[5];                                     // bytes of each phase's region, A-E
  int red = 0;
  for (int i = 0; i < 4; ++i) {
    const int tc = p.tc[i], tpr = tc * NM[i] / 16;
    if (tc < 16 || tc % 16 || N[i] % tc || tpr > 32 || 32 % tpr || p.splits[i] < 1 ||
        p.rows[i] < 1 || (size_t)p.splits[i] * p.rows[i] < (size_t)K[i] ||
        N[i] / tc * p.splits[i] > grid || p.rows[kO] > kThreads)
      return kErrPlan;
    // weights, then the side vectors: norm weights and the residual's
    // scales (qkv, gate/up), the rows' gate and up scales (down)
    const int side = i == kQKV || i == kGU ? 2 * H : i == kO ? 0 : 2 * ((p.rows[i] + 7) / 4 * 4);
    need[i == kQKV ? 0 : i + 1] =
        ((size_t)NM[i] * p.rows[i] * tc + 15) / 16 * 16 + 4 * (size_t)side;
    red = red > tc * NM[i] ? red : tc * NM[i];
  }
  if (p.chunk < 1 || (size_t)nkv * ((C + p.chunk - 1) / p.chunk) > (size_t)grid) return kErrPlan;
  need[1] = 2 * (size_t)p.chunk * (kHD * itemsize + 16) + 4 * 2 * (size_t)(grp + 2) * kHD;
  size_t off = 0;
  for (int ph = 0; ph < 5; ++ph) {
    p.region[ph] = (int)off;
    off += (need[ph] + 15) / 16 * 16;
  }
  p.region[5] = (int)off;
  const int cm = (C + p.chunk - 1) / p.chunk;        // a head's chunk weights in phase C
  int vec = H;
  if (p.rows[kO] + (p.rows[kO] / kHD + 2) * (cm + 1) > vec)
    vec = p.rows[kO] + (p.rows[kO] / kHD + 2) * (cm + 1);
  if (p.rows[kDown] > vec) vec = p.rows[kDown];
  if (2 * grp * kHD + 3 * kHD + grp * p.chunk > vec) vec = 2 * grp * kHD + 3 * kHD + grp * p.chunk;
  p.red = red;
  *smem = off + 4 * ((size_t)kWarps * red + vec);
  return 0;
}

int coop_grid(const void* kernel, size_t smem, int* grid) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return kErrNoCooperativeLaunch;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return kErrGridTooLarge;
  *grid = sms;                                       // one block an SM
  return 0;
}

int launch_error(cudaError_t e) {
  return e == cudaErrorCooperativeLaunchTooLarge ? kErrGridTooLarge : (int)e;
}

template <typename T>
int launch(StepArgs<T> a, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  size_t smem = 0;
  int rc = check_plan(a.p, a.H, a.I, a.nq, a.nkv, a.C, (int)sizeof(T), sms, &smem);
  if (rc) return rc;
  int grid = 0;
  rc = coop_grid((const void*)lm_step_kernel<T>, smem, &grid);
  if (rc) return rc;
  void* params[] = {&a};
  return launch_error(cudaLaunchCooperativeKernel((const void*)lm_step_kernel<T>, dim3(grid),
                                                  dim3(kThreads), params, smem, stream));
}

}  // namespace

// plan: int[13] = tc[4], splits[4], rows[4], chunk (ops/kernels/lm_step.py
// plan); work: the wrapper's scratch, sized by that plan.
extern "C" int cvt_lm_step(void* y, void* kc, void* vc, const void* cos, const void* sin,
                           const void* wqkv, const void* sqkv, const void* bqkv,
                           const void* wo, const void* so, const void* wg, const void* sg,
                           const void* wu, const void* su, const void* wd, const void* sd,
                           const void* n1, const void* n2, void* work,
                           const int* plan, int L, int H, int I, int nq, int nkv, int C,
                           int pos, float eps, float qscale, int dtype, void* stream) {
  if (L < 1 || H % 64 || I % 64 || nkv < 1 || nq % nkv || pos < 0 || pos >= C)
    return (int)cudaErrorInvalidValue;
  Plan p{};
  for (int i = 0; i < 4; ++i) {
    p.tc[i] = plan[i];
    p.splits[i] = plan[4 + i];
    p.rows[i] = plan[8 + i];
  }
  p.chunk = plan[12];
  cudaStream_t s = (cudaStream_t)stream;
#define K6_ARGS(T)                                                                    \
  StepArgs<T>{(T*)y, (T*)kc, (T*)vc, (const float*)cos, (const float*)sin,            \
              (const int8_t*)wqkv, (const float*)sqkv, (const float*)bqkv,            \
              (const int8_t*)wo, (const float*)so, (const int8_t*)wg, (const float*)sg, \
              (const int8_t*)wu, (const float*)su, (const int8_t*)wd, (const float*)sd, \
              (const float*)n1, (const float*)n2, (float*)work, L, H, I,                 \
              nq, nkv, C, pos, eps, qscale, p}
  if (dtype == kFloat32) return launch<float>(K6_ARGS(float), s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(K6_ARGS(__nv_bfloat16), s);
#undef K6_ARGS
  return (int)cudaErrorInvalidValue;
}

// n_syncs grid barriers on the grid lm_step launches (one block of 512
// threads an SM), to measure the barriers' share of a step; writes the
// grid's block count.
extern "C" int cvt_lm_step_sync_probe(int n_syncs, int* grid_out, void* stream) {
  int grid = 0;
  const int rc = coop_grid((const void*)sync_probe_kernel, 0, &grid);
  if (rc) return rc;
  *grid_out = grid;
  void* params[] = {&n_syncs};
  return launch_error(cudaLaunchCooperativeKernel((const void*)sync_probe_kernel, dim3(grid),
                                                  dim3(kThreads), params, 0,
                                                  (cudaStream_t)stream));
}

// out[i] = float(in[i]) through the GEMVs' int8 conversion; n a multiple of 4
extern "C" int cvt_lm_step_int8_to_float(const void* in, void* out, int n, void* stream) {
  if (n % 4) return (int)cudaErrorInvalidValue;
  const int threads = 128, blocks = (n / 4 + threads - 1) / threads;
  if (blocks)
    i8f_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>((const int8_t*)in, (float*)out, n);
  return (int)cudaGetLastError();
}
