// One-token GQA decode attention over a packed [B, T, KH*D] KV cache, with
// the new token's K/V appended in place at row pos[b].
//
// Replaces: cosyvoice_tpu/ops/pallas/lm_decode_attention.py::lm_decode_attention
// (the TPU kernel of the LM decode step under Qwen2Config.fused_cache_update).
//
// Bound on the H100: bytes on paper, latency in practice.  Each step reads
// 2 * pos * KH * D cache elements and does 4 * G * D flops per cached element
// (G = 7 query heads per KV head), about 14 flops per byte in bf16, far below
// the ~295 where the tensor cores would bound it.  At the decode shapes the
// bytes are few (192 KB at B = 1, pos 364: 0.06 us at 3.35 TB/s), so the time
// is a chain of latencies: launch, a round of loads, the reductions, a store.
// The design spreads the keys over many blocks, so that their loads are in
// flight together, and keeps each block's chain short (split-key decode).
//
// Grid (B, KH, S): block (b, kh, s) owns keys [32 s, 32 s + 32) of row b
// and KV head kh, S = ceil(Tc / 32), so a row gets the same sums at any
// batch size; at Tc = 384 that is 24 blocks at B = 1 where one block per
// (b, kh) gave 2.  (16-key chunks, 48 blocks, were slower: the merge reads
// every split's partial.)  pos lives on the device (the engine passes one
// per row), so a block whose chunk starts at or past pos[b] has no keys and
// only takes its turn at the counter below.  A block with keys copies its
// K/V rows of one head into shared memory with 16-byte loads; one warp a
// query head scores the chunk in fp32 with the bias row (a key a lane),
// takes the chunk's max and sum by shuffles and accumulates p v with each p
// shuffled from its lane, and writes a partial (m, l,
// acc[D]) in fp32 to a scratch buffer.  After the block's barrier one thread
// bumps a per-(b, kh) counter with an acquire-release atomic (the pattern of
// CUTLASS's barriers); the block that arrives last merges the live partials
// (a warp a head for the row max and l, then half the block on every other
// split, 16 bytes a load), folds in the new token's score, writes the output,
// appends k_new/v_new at row pos[b] and resets the counter to 0 for the next
// launch.  The split blocks read only rows < pos[b], and the merge starts
// after every one of them has arrived, so the append races nothing.  The
// wrapper owns the scratch and the zeroed counters, one set per (device,
// stream): launches that share a set run one after another.
//
// Numerics as before the split: an exact max-subtracted softmax in fp32
// (each partial against its chunk's max, rescaled to the row max in the
// merge), p not rounded, the divide floored at 1e-30.  The TPU kernel skipped
// the max subtraction and clamped exp at 75 instead; the two agree wherever
// that clamp does not bind.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;                    // query heads per KV head
constexpr int kD = 64;                       // head_dim
constexpr int kHalf = kThreads / 2;
constexpr int kChunk = 32;                   // keys a block takes, one a lane

template <typename T>
__global__ void __launch_bounds__(kThreads)
lm_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                       const T* __restrict__ v_new, T* __restrict__ ck,
                       T* __restrict__ cv, const float* __restrict__ bias,
                       const int* __restrict__ pos, T* __restrict__ out,
                       float* __restrict__ part_acc, float* __restrict__ part_ml,
                       int* __restrict__ counters, int G, int KH, int Tc, int S,
                       float scale) {
  constexpr int VEC = 16 / sizeof(T);        // elements of one 16-byte load
  constexpr int RV = kD / VEC;               // 16-byte pieces of a head row
  constexpr int LDK = kD + VEC;              // K row padded by 16 bytes
  __shared__ __align__(16) T k_s[kChunk][LDK];
  __shared__ __align__(16) T v_s[kChunk][kD];
  __shared__ __align__(16) float q_s[kMaxG][kD];
  __shared__ float bias_s[kChunk];
  __shared__ T kn_s[kD], vn_s[kD];           // the new token's k and v
  __shared__ float4 odd_s[kMaxG * kD / 4];   // merge: the odd splits' sums
  __shared__ float m_s[kMaxG], self_w_s[kMaxG], inv_l_s[kMaxG];
  __shared__ int is_last;

  const int b = blockIdx.x, kh = blockIdx.y, sp = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int KHD = KH * kD;
  const int pair = b * KH + kh;
  const int j0 = sp * kChunk;
  const int p = pos[b];                      // in flight beside the q loads

  // q of the G heads, 16 bytes a thread, scaled into fp32
  const T* qb = q + (size_t)b * G * KHD + kh * kD;
  for (int idx = tid; idx < G * RV; idx += kThreads) {
    const int g = idx / RV, c = VEC * (idx % RV);
    const uint4 raw = *reinterpret_cast<const uint4*>(qb + (size_t)g * KHD + c);
    const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) q_s[g][c + i] = to_float(x[i]) * scale;
  }
  const size_t nb = (size_t)b * KHD + kh * kD;
  if (tid < kD) kn_s[tid] = k_new[nb + tid];
  else if (tid < 2 * kD) vn_s[tid - kD] = v_new[nb + tid - kD];
  const int n_keys = min(max(p, 0), Tc);

  if (j0 < n_keys) {
    const int nt = min(kChunk, n_keys - j0);
    for (int idx = tid; idx < nt * RV; idx += kThreads) {
      const int jj = idx / RV, c = VEC * (idx % RV);
      const size_t off = ((size_t)b * Tc + j0 + jj) * KHD + kh * kD + c;
      *reinterpret_cast<uint4*>(&k_s[jj][c]) = *reinterpret_cast<const uint4*>(ck + off);
      *reinterpret_cast<uint4*>(&v_s[jj][c]) = *reinterpret_cast<const uint4*>(cv + off);
    }
    if (tid < nt) bias_s[tid] = bias[(size_t)b * Tc + j0 + tid];
    __syncthreads();
    // one warp a query head: lane l scores key l, the chunk's max and sum by
    // shuffles, then acc[d] for head dims l and l + 32 with each p taken
    // from its lane
    for (int g = warp; g < G; g += kWarps) {
      float sc = -INFINITY;
      if (lane < nt) {
        float dot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < kD; c += VEC) {
          const uint4 raw = *reinterpret_cast<const uint4*>(&k_s[lane][c]);
          const T* kv = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            dot[i % 4] = fmaf(q_s[g][c + i], to_float(kv[i]), dot[i % 4]);
        }
        sc = (dot[0] + dot[1]) + (dot[2] + dot[3]) + bias_s[lane];
      }
      const float mx = warp_max(sc);
      const float ref = mx == -INFINITY ? 0.f : mx;   // every key at -inf: p = 0
      sc = expf(sc - ref);
      const float sum = warp_sum(sc);
      float a0 = 0.f, a1 = 0.f;
#pragma unroll 8
      for (int j = 0; j < nt; ++j) {                  // uniform across the warp
        const float pj = __shfl_sync(0xffffffffu, sc, j);
        a0 = fmaf(pj, to_float(v_s[j][lane]), a0);
        a1 = fmaf(pj, to_float(v_s[j][lane + 32]), a1);
      }
      float* acc = part_acc + (((size_t)pair * S + sp) * G + g) * kD;
      acc[lane] = a0;
      acc[lane + 32] = a1;
      if (lane == 0)
        reinterpret_cast<float2*>(part_ml)[((size_t)pair * S + sp) * G + g] =
            make_float2(mx, sum);
    }
  }

  // arrive: one thread's acquire-release add after the block's barrier
  // publishes the block's partial (the pattern of CUTLASS's barriers); the
  // last block of (b, kh) merges
  __syncthreads();
  if (tid == 0) {
    int before;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(before)
                 : "l"(counters + pair)
                 : "memory");
    is_last = before == S - 1;
  }
  __syncthreads();
  if (!is_last) return;

  const int n_live = (n_keys + kChunk - 1) / kChunk;
  const float2* ml = reinterpret_cast<const float2*>(part_ml) + (size_t)pair * S * G;
  const float4* acc = reinterpret_cast<const float4*>(part_acc) + (size_t)pair * S * G * kD / 4;
  // one warp a query head: the new token's score (its cache row is written
  // below, never read), the row max over it and the partials' maxima, the
  // new token's weight and 1 / l
  for (int g = warp; g < G; g += kWarps) {
    // the first 32 partials stay in registers (one a lane)
    const float2 v0 = lane < n_live ? __ldcg(ml + lane * G + g) : make_float2(-INFINITY, 0.f);
    float part = 0.f;
    for (int d = lane; d < kD; d += 32) part += q_s[g][d] * to_float(kn_s[d]);
    const float s_self = warp_sum(part);
    float mx = fmaxf(s_self, v0.x);
    for (int s = lane + 32; s < n_live; s += 32) mx = fmaxf(mx, __ldcg(ml + s * G + g).x);
    mx = warp_max(mx);
    // a chunk whose keys are all at -inf adds nothing
    float l = v0.x != -INFINITY ? expf(v0.x - mx) * v0.y : 0.f;
    for (int s = lane + 32; s < n_live; s += 32) {
      const float2 v = __ldcg(ml + s * G + g);
      if (v.x != -INFINITY) l += expf(v.x - mx) * v.y;
    }
    l = warp_sum(l);
    if (lane == 0) {
      const float w = expf(s_self - mx);
      m_s[g] = mx;
      self_w_s[g] = w;
      inv_l_s[g] = 1.f / fmaxf(l + w, 1e-30f);
    }
  }
  __syncthreads();
  // the partials' acc, each rescaled to the row max: each half of the block
  // takes every other live split, one (query head, 4 head dims) a thread
  const int odd = tid / kHalf, hid = tid % kHalf;
  float4 a[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = hid + r * kHalf, g = i / (kD / 4);
    a[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i >= G * kD / 4) continue;
    const float mx = m_s[g];
#pragma unroll 4
    for (int s = odd; s < n_live; s += 2) {
      const float ms = __ldcg(ml + s * G + g).x;
      const float4 y = __ldcg(acc + (size_t)s * G * kD / 4 + i);
      const float w = ms == -INFINITY ? 0.f : expf(ms - mx);
      a[r].x = fmaf(w, y.x, a[r].x);
      a[r].y = fmaf(w, y.y, a[r].y);
      a[r].z = fmaf(w, y.z, a[r].z);
      a[r].w = fmaf(w, y.w, a[r].w);
    }
    if (odd) odd_s[i] = a[r];
  }
  __syncthreads();
  if (!odd) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = hid + r * kHalf;
      if (i >= G * kD / 4) continue;
      const int g = i / (kD / 4), d = 4 * (i % (kD / 4));
      const float w = self_w_s[g], il = inv_l_s[g];
      const float4 e = odd_s[i];
      T* o = out + ((size_t)b * G + g) * KHD + kh * kD + d;
      o[0] = from_float<T>((a[r].x + e.x + w * to_float(vn_s[d])) * il);
      o[1] = from_float<T>((a[r].y + e.y + w * to_float(vn_s[d + 1])) * il);
      o[2] = from_float<T>((a[r].z + e.z + w * to_float(vn_s[d + 2])) * il);
      o[3] = from_float<T>((a[r].w + e.w + w * to_float(vn_s[d + 3])) * il);
    }
  }
  if (p >= 0 && p < Tc && tid < kD) {
    const size_t off = ((size_t)b * Tc + p) * KHD + kh * kD + tid;
    ck[off] = kn_s[tid];
    cv[off] = vn_s[tid];
  }
  if (tid == 0) counters[pair] = 0;
}

template <typename T>
int launch(const void* q, const void* kn, const void* vn, void* ck, void* cv,
           const void* bias, const void* pos, void* out, float* work, int* counters, int B,
           int G, int KH, int Tc, float scale, cudaStream_t stream) {
  const int S = (Tc + kChunk - 1) / kChunk;
  float* part_acc = work;                          // [B * KH, S, G, D]
  float* part_ml = work + (size_t)B * KH * S * G * kD;   // [B * KH, S, G, 2]
  lm_decode_split_kernel<T><<<dim3(B, KH, S), kThreads, 0, stream>>>(
      (const T*)q, (const T*)kn, (const T*)vn, (T*)ck, (T*)cv, (const float*)bias,
      (const int*)pos, (T*)out, part_acc, part_ml, counters, G, KH, Tc, S, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// work: B * KH * ceil(Tc / 32) * G * (D + 2) floats of scratch; counters:
// B * KH ints, zero before the first launch (each launch leaves them zero);
// ck and cv 16-byte aligned (the wrapper checks).
extern "C" int cvt_lm_decode_attention(const void* q, const void* k_new, const void* v_new,
                                       void* ck, void* cv, const void* bias,
                                       const void* pos, void* out, void* work,
                                       void* counters, int B, int G, int KH, int D, int Tc,
                                       float scale, int dtype, void* stream) {
  if (G < 1 || G > kMaxG || D != kD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kFloat32)
    return launch<float>(q, k_new, v_new, ck, cv, bias, pos, out, (float*)work,
                         (int*)counters, B, G, KH, Tc, scale, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(q, k_new, v_new, ck, cv, bias, pos, out, (float*)work,
                                 (int*)counters, B, G, KH, Tc, scale, s);
  return (int)cudaErrorInvalidValue;
}
