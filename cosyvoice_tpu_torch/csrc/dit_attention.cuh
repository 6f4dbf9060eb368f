// K2's bf16 tensor-core attention launcher (csrc/dit_attention.cu), shared
// with K4 (csrc/dit_block.cu), whose attention phase is this kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// out[b, t, h*64 ..] = softmax over keys j < lengths[b] of q k^T (q scaled by
// qscale = sm_scale * log2 e, exp2) times v, 64-wide heads; q, k and v rows
// read through batch and row strides (elements), 16-byte aligned.
void dit_attention_tc_launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
                             const __nv_bfloat16* v, __nv_bfloat16* out, const int* lengths,
                             int B, int T_len, int H, long long in_bstride, long long in_rstride,
                             long long out_bstride, long long out_rstride, float qscale,
                             cudaStream_t stream);
