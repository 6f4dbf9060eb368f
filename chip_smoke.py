#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of CosyVoice2 (and CosyVoice v1) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repo root; needs one CUDA GPU
    python3 chip_smoke.py --flow-stage TREE --label L   # the flow stage alone,
                                     # on the package of the checkout at TREE

Phases, each printing JSON lines:
  1. device  - the card's name and power limit (nvidia-smi);
  2. build   - compile the port's CUDA kernels from cosyvoice_tpu_torch/csrc;
  3. kernels - hold each kernel against its plain PyTorch version (fp32, bf16):
     K1 at B = 4 with per-row frontiers and at B = 1 on each side of the
     split kernel's chunk boundaries (pos 0, 1, chunk - 1, chunk, chunk + 1,
     Tc - 1 at three cache lengths), the cache equal after each call; K2 at
     T = 640, 1152 and 700 with lengths 0, 1, 63, 64, 65 and T, packed and
     unpacked (bf16 bar: K2_BF16_ULPS ulps at max |plain| of each (batch
     row, head));
  4. reference - a small stack on the GPU (kernels) against the same stack on
     the CPU (plain versions): greedy tokens exact, waveform within 1e-2;
  5. main path - build the full-width serving stack (Qwen2-0.5B int8 LM over
     the packed decode cache, bf16 flow with fused attention/norm, bf16 HiFT)
     on seeded random weights and answer 3 zero-shot requests through
     CosyVoice2.inference_zero_shot; every kernel must launch; then the
     last request again (its seed, text and decode cap) under
     utils/profiling.trace (phase `trace`): the device busy share, the
     trace's kernel time (the union of its kernel intervals) over the
     request's wall, beside the main path's untraced run of it;
  6. fused_step - the main path's int8 LM (same weights) with greedy
     sampling from the first request's prompt, 200 steps, through
     lm_generate (K1 in every layer) and lm_generate_fused_step (one K6
     launch a step): ms/token of each, K6 launches (must equal the decode
     steps), the free-running token match and the teacher-forced argmax
     agreement of K6 against the K1 path;
  7. int4    - one full-width zero-shot request with the LM quantized to
     packed int4 (group 128) from the same seeded bf16 weights: latency,
     RTF, LM ms/token, K5 launches (must be > 0), a finite waveform, and
     the teacher-forced argmax agreement with the bf16 LM; then the same
     weights quantized to int4xla (nibble values, group 128, PyTorch ops)
     without and with AWQ (calibrated by collect_act_stats on one seeded
     request): 100 greedy steps each (ms/step, K1 launches exactly 24 x
     99, no K5), peak memory, the teacher-forced agreement with the bf16
     LM and the device time of a step's 168 projections at one row
     (dev_time; beside bf16's, int8's and int4's); and the small stack's
     LM in int4xla, fp32, card against CPU (logits within 2e-5, 40 greedy
     tokens equal), without and with AWQ;
  8. batched - BatchedSynthesizer.synthesize_batch over 8 zero-shot requests
     (the main path's weights and prompt, decode caps spread over 100-200
     tokens) with the estimator's fused_block on: one warm-up batch, then
     one timed batch: wall time, LM / flow / HiFT seconds, seconds of audio,
     aggregate RTF, peak memory, K4 launches (must be 56 DiT blocks x 10
     Euler steps) and K1 launches, and the mel difference between
     fused_block on and off for the same flow inputs;
  9. engine  - ServingEngine.generate, 16 requests through 8 slots (staggered
     admission, slot reuse): on a small fp32 stack (greedy tokens must equal
     a B=1 lm_generate of each request), then on the main path's int8 LM
     with greedy sampling (K1's per-row pos mode), caps of 50-100 tokens:
     tokens/s, segments, K1
     launches and the share of the first 8 requests equal to a B=1
     lm_generate (no gate
     at full width in bf16: a batch-dependent order of sums can flip a
     near-tied argmax);
 10. bigvgan - the BigVGAN token->wav vocoder at the full width of the
     recipe (examples/tts_vc/cosyvoice2/conf/cosyvoice2_bigvgan_tts.yaml:
     two 512-d conformer encoders, rates [8, 5, 3, 2], 1536 initial
     channels) on seeded random weights, every anti-aliased activation
     through K7 (snake_aa) on the convolutions' channels-first memory: 4
     rows of 250/200/150/100 tokens (10/8/6/4 s of 24 kHz audio), one
     warm-up and one timed forward: wall time, seconds of audio, RTF, peak
     memory, K7 launches (must be 73: 4 stages x 3 resblocks x 6, plus
     activation_post; 18/18/18/19 by stage shape) and the layout of each
     input, a finite wav in [-1, 1], K7's device time and share (every
     kernel named snake_aa*; must be > 0) beside the copy kernels' device
     time and launches a forward, and the wav difference and the wall time
     with the composite activations instead (printed only: the first and
     last ~6 samples of each activation differ by design);
 11. stream  - one full-width zero-shot request streamed through
     CosyVoice2.inference_zero_shot(stream=True) with the main path's
     weights, greedy sampling and a STREAM_CAP-token cap, after one warm-up
     stream: first-chunk latency, per-chunk seconds (each split into
     frontend, LM prefill, flow, HiFT and decode/host), wall, RTF, the chunk
     lengths (must follow the hop-50 / lookahead-3 / 8-frame-cache formula),
     the token count (must equal a non-streaming greedy decode's) and the
     K1/K2/K3 launches (each must be > 0);
 12. continuous - ContinuousSynthesizer: on the small fp32 stack, 4 greedy
     requests through 2 slots on the card, windowed (batch_chunks on and
     off; tokens exact and every chunk within CONT_WAV_TOL of the same
     stack's sequential tts(stream=True) on the CPU) and incremental (the
     stream family; within INC_WAV_TOL of its one-shot stream-masked flow
     vocoded with the same windows); then at full width bench.py's engine
     traffic at CONT_TOKENS a stream (8 streams through 8 slots,
     hop_scale 2.0),
     windowed (flow_context_tokens 250) and incremental: first-chunk latency
     a stream and the segments before it, wall, audio, RTF, chunks,
     segments, peak memory and K1-K3 launches (windowed all > 0,
     incremental K1 and K3 > 0), beside the stream phase's B=1 first chunk;
 13. serve   - the HTTP server (bin/serve.py, continuous worker) over the
     full-width stack: GET /health, 4 concurrent streamed zero-shot
     requests (time to first data chunk), one request each to sft,
     cross_lingual, instruct2 and vc; every response a 200 with a
     well-formed 24 kHz WAV and no exception on a worker's queue; then over
     the small fp32 stack (sequential flush, deterministic cuDNN) the PCM
     equal to pcm16 of a direct ContinuousSynthesizer run;
 14. checkpoint - a model directory in the released format, written with the
     port alone: (a) a small fp32 one loaded by from_pretrained on the card
     and on the CPU (text ids and S3 speech tokens exact, CAMPPlus speaker
     vector within 5e-4, greedy tokens exact, waveform within 1e-2); (b) a
     full-width one (LMConfig, FlowConfig, HiFTConfig, CAMPPlusConfig,
     S3Config; fp32 .pt and .onnx files, ~3 GB) loaded with fp16=True,
     quant="int8": seconds a file, the frontend's milliseconds for a 3 s and
     a 10 s prompt (CAMPPlus, S3 tokenizer, prompt mel), and 3 zero-shot
     requests from raw 16 kHz prompt audio (CKPT_CAP-token cap): latency, RTF,
     launches (K2 must be > 0), then one request loaded with quant="int4"
     (K5 must be > 0); (c) `python -m cosyvoice_tpu_torch.bin.serve` over
     (b) in a subprocess: cold start (launch to /health 200) and one
     streamed zero-shot request, a well-formed chunked WAV;
 15. v1      - CosyVoice-300M at full width on seeded random weights
     (TransformerLMConfig() fp32 with non_random_ras, FlowV1Config() with its
     two-level non-causal estimator in bf16 on the K2 + K3 route, unpadded,
     the 22.05 kHz HiFT; frontend at 22.05 kHz with the port's CAMPPlus, a
     seeded speech-token callable and WhisperTiktokenTokenizer): a small
     fp32 v1 stack on the card against the CPU (greedy tokens exact,
     waveform within 1e-2); two zero-shot requests (3 s prompt, cap 200), one
     streamed (its tokens equal to a one-shot decode on the same generator,
     chunk lengths the v1 formula's: hop 50, overlap 20, 68-frame mel fade,
     20-frame HiFT caches), one instruct request: latency, RTF, LM ms/token,
     flow and HiFT seconds, first chunk, peak memory; K2 / K3 launches equal
     to 640 / 1280 a flow call; K2 and K3 against their plain versions at
     the estimator's shapes (B = 2, an odd T and ceil(T / 2)) and timed there;
 16. phoneme - the phoneme LMs: (a) small fp32 stacks on the card against
     the CPU: the Src2 LM's greedy tokens through phoneme_lm_generate (two
     ragged rows) and the engine (5 requests through 2 slots at three
     phoneme buckets, each also equal to a B=1 decode), a 2-stream phoneme
     ContinuousSynthesizer (tokens exact, every chunk within CONT_WAV_TOL)
     and the v1 phoneme LM's greedy tokens (spk_adapt on); (b) at full
     width cosyvoice2_pho.yaml's Qwen2LM_Phoneme_Src2 (PhonemeLMConfig: the
     Qwen2-0.5B body int8 in bf16 over the packed cache, the 6 x 1024
     phoneme conformer and the fusion in bf16) with the main path's flow at
     a 512-d speaker vector and its HiFT: one B=1 greedy decode of
     PHO_TOKENS tokens (prefix ms: encoder + fusion, then the prefill; ms a token),
     then 8 streams of 40 seeded phonemes, PHO_TOKENS tokens each, through 8
     slots, windowed (flow_context_tokens 250), hop_scale 2.0, from a 3 s
     prompt: first-chunk latency, wall, RTF, peak memory, launches (K1, K2
     and K3 must be > 0); (c) cosyvoice_phoneme.yaml's v1 LM
     (V1PhonemeLMConfig, fp32): PHO_TOKENS greedy tokens, prefill ms and ms a
     token;
 17. lam     - the LAM stack: (a) small fp32 stacks on the card against
     the CPU, the noise drawn on CPU generators: a SpeakerEmbedding's
     vector of a seeded 3 s 24 kHz prompt through speaker_embed (within
     5e-4), a VITS wav of two ragged rows with two upsample conformers at
     noise_scale 0.5 (within 1e-2), and TransformerLMPhonemeWithSpk's
     greedy tokens from the prompt's features through encode_speaker and
     v1_phoneme_generate (exact); (b) at full width in fp32 on seeded
     weights: SpeakerEmbeddingConfig() on a 3 s and a 10 s prompt (ms a
     prompt, the median of 5, split into features, CAMPPlus, posterior +
     style encoders, GST + fuser) and VITS at its recipe
     (examples/tts_vc/cosyvoice2/conf/cosyvoice2_vits_tts.yaml) over the
     bigvgan phase's 4 rows of 250/200/150/100 tokens (one warm-up, one
     timed inference: wall, audio, RTF, peak memory, a finite wav in
     [-1, 1] of 960 samples a token); (c) one LAM request: the 10 s
     prompt's vector, the phoneme phase's full-width Src2 LM (PHO_TOKENS
     greedy tokens on K1), VITS with g = the vector: speaker ms, LM ms a token,
     VITS s, total, RTF, launches (K1 must be > 0);
 18. multicode - the multi-codebook phoneme LM: (a) a small fp32 one on
     the card against the CPU (greedy delayed codes, steps and done flags
     of two ragged rows equal); (b) examples/tts_vc/cosyvoice2/conf/
     cosyvoice2_multicode.yaml built through the port's config.py (the
     Qwen2-0.5B body, the 6 x 1024 phoneme conformer, 4 fusion layers, 6
     codebooks of 1002 ids) on seeded weights in bf16 over the packed
     decode cache: 40 phonemes + 20 text ids, a 512-d speaker vector, a
     3 s prompt of 120 code rows, MC_STEPS greedy steps at B=1, then 4
     ragged rows: prefix ms, ms a step, the reverted [B, MC_STEPS - 5, 6]
     shape, peak memory, K1 launches (exactly 24 x (MC_STEPS - 1) a call,
     no other kernel);
 19. train   - training on the card, TF32 off, no kernel (the training path
     reaches none; the phase gates on zero launches): (a) the small LM and
     flow of tests/test_train_cli.py's widths, 3 steps on the card and on
     the CPU from one init (each step's loss within 1e-4 relative); (b)
     cosyvoice2.yaml's LM (the Qwen2-0.5B body, fp32) with the recipe's
     train_conf (adam, warmuplr 2500, clip 5, accum_grad 2) on two seeded
     batches of 8 examples (40 text ids, 250 speech tokens), 3 applied
     updates a run: unpacked (naive attention), packed into rows of 2048
     (naive, then block_attention, then block_attention with remat "all"):
     s a micro-step (median; accumulating and applying apart), tokens/s,
     loss and grad_norm a micro-step, peak memory (and a forward +
     backward's alone); gates: packed = unpacked and block = naive = remat
     loss within 1e-4 relative, grad_norm within 1e-3; (c) attention
     forward + backward at the packed rows: block_attention, naive, SDPA
     (a yardstick); (d) cosyvoice2.yaml's flow, fp32, 8 rows of 250 tokens
     and 500 mel frames, 3 applied updates; (e) `python -m
     cosyvoice_tpu_torch.bin.train` on its default device over a seeded
     jsonl corpus at the small widths: one epoch, then a resumed one
     (steps 1..4, every value finite);
 20. gan     - GAN training of the three vocoders on the card, no kernel (the
     phase gates on zero launches; K7 refuses gradients): (a) the three
     generators at small widths against MPD + MRD, two D + G pairs on the
     card and on the CPU from one init (every loss term within 1e-4
     relative); (b) cosyvoice2_hift_tts.yaml, cosyvoice2_bigvgan_tts.yaml
     and cosyvoice2_vits_tts.yaml at full width with their gan_conf
     discriminator (MPD + MRD) and train_conf optimizers, on a seeded batch
     of 4 rows of 10 s (the recipes' 2000-frame cap, GAN_BATCH): one warm
     D + G pair, then 1 (HiFT 3, VITS 9): s a pair (median), peak memory,
     every loss term and grad_norm finite, HiFT's largest log-magnitude a
     pair, VITS's KL at its last pair below its first; (c) `python -m
     cosyvoice_tpu_torch.bin.train --model hift|bigvgan|vits` on its
     default device at the small widths (steps 1, 2, both nets saved);
 21. deploy  - finetune -> average -> assemble -> serve at full width:
     train/checkpoint.save_checkpoint of a seeded LM, flow and HiFT (once
     each), bin/average_model.py, bin/ckpt_resave.py --out_dir (with a
     --ref_audio speaker), from_pretrained (fp16, int8, greedy, K1 and K3
     on) and one zero-shot request, against the same weights written
     straight to a model directory: the tokens equal, K1-K3 launched;
     seconds of each step, RTF, peak memory; then
     bin/export_serving_lm.py of the averaged LM, its model.safetensors
     equal to the re-headed tensors;
 22. pho_train - phoneme-LM training on online labels, and LoRA to a served
     model: (a) cosyvoice2_pho.yaml's Qwen2LMPhonemeSrc2 at full width,
     random init, through bin/train.py --data_format spk_json (static
     batches of 8, accum_grad 2) over a seeded 4-speaker x 4-utterance
     corpus of 3-8 s clips with prosody-marked phonemes and MFA
     durations, its speech tokens and speaker vectors labelled every batch
     by the full-width S3 tokenizer and SpeakerEmbedding (random, frozen):
     2 micro-steps, then 2 more resumed from the checkpoint; seconds a
     micro-step and a batch's labels, peak memory; (b) cosyvoice2.yaml's
     LM with --lora (r 8, alpha 16, q/k/v/o), 4 micro-steps, lora.npz
     merged by ckpt_resave --lora_npz into a model directory that
     from_pretrained serves one request from (K1-K3 counted around it),
     its greedy tokens equal to those of an in-memory merge_lora; (c) at
     small widths, card against CPU: the phoneme LM's loss, the multi-code
     focal loss and TransformerLMPhonemeWithSpk's loss with VICReg (pinned
     SpecAugment masks); (d) at small widths through the CLI:
     qwen2lm_phoneme and qwen2lm_phoneme_src (spk_json, online labels),
     transformer_lm (parquet) and the flow with lora_conf; no kernel
     launched in any training;
 22b. export - bin/export_aot.export_flow_estimator on the main path's bf16
     estimator at T 100, 200 and 500 (K2 + K3 nodes) and with fused_block
     at T 200 (K4 nodes): each .pt2 reloaded and held to eager (rtol 1e-2,
     atol 1e-5), run once more with the launch counts at 0 (K2 and K3, or
     K4, must launch inside it), timed beside eager;
 23. multi_card - more than one card's code paths, two ranks on the one
     card (torch.distributed, gloo over CUDA tensors: NCCL refuses two
     ranks on one device, which the phase confirms and prints): K1 at the
     TP-local heads of Qwen2-0.5B at model 2 (KH 1, G 7, cache 384, B = 1
     and 8) against its plain version and timed; then the two ranks run
     (b) the small fp32 stack in BatchedSynthesizer at DP(2) and TP(2)
     against one process (tokens exact, wavs within MC_SMALL_WAV_TOL), (a)
     the full-width stack (the main path's int8 LM, K4 flow, HiFT) on 4
     requests, one process, DP(2) and TP(2): RTF, greedy rows equal to one
     process (printed), teacher-forced logits within MC_LOGITS_REL_TOL of
     one process's and their argmax agreement, K1-K4 launches, and (c)
     cosyvoice2.yaml's LM in fp32 at DP(2), 3 micro-steps on the train
     phase's batch with data rank 1's speech cut to MC_TRAIN_SHORT tokens,
     against one process (loss and grad_norm within MC_TRAIN_REL_TOL; s a
     micro-step and peak a rank); (d) `python -m torch.distributed.run
     --nproc_per_node 2 -m cosyvoice_tpu_torch.bin.train --mesh_model 2`
     for 2 steps, then a one-process resume (steps 3, 4); (e) the small
     stack's ContinuousSynthesizer with flow_device="cpu" against the
     all-card run (CONT_WAV_TOL); (f) the full-width LM in packed int4
     (group 128) greedy at B=1 over MC_INT4_ROWS requests, MC_INT4_CAP
     steps each, one process then TP(2) (the MLP sharded: K5 at [1, 896] -> 2432 and
     [1, 2432] -> 896 a rank; attention whole): rows equal to one process
     (printed), teacher-forced logits within MC_LOGITS_REL_TOL, K5's
     launches by shape; (g) cosyvoice2_pho.yaml's LM (dropout off) one
     DP(2) step and (h) cosyvoice2.yaml's LM with LoRA one TP(2) step, each
     against one process (loss and grad_norm within MC_TRAIN_REL_TOL); K5
     at the two local shapes against its plain version, timed beside
     torch._weight_int4pack_mm (kernels-line rows).  NCCL between cards and
     the flow's overlap on a second card are not measured (one card);
 24. timing  - at the main path's shapes: each kernel against its plain
     version on the same inputs, then the kernel, the plain version and the
     one PyTorch call that computes the same function, timed (CUDA events);
     K1 also at the engine's shape (B = 8, cache 384, per-row frontiers)
     beside SDPA with a boolean key mask;
     K4 at the batched phase's flow shape, beside the port's unfused block;
     K7 fp32 at the recipe's four stage shapes with x channels-first (the
     path's layout) and channels-last (nested), beside the composite
     anti_alias_activation (no one PyTorch call computes K7) and, at the
     third stage, the layout copy AAAct no longer makes;
     K5 one row a projection shape and a decode step's 168 launches, beside
     torch._weight_int4pack_mm (PyTorch's group-wise int4 matmul, zero
     points 0) on the same inputs.  Every row and yardstick also gets its
     device time (dev_time: the median of three CUDA-graph replays, all
     three printed).
Phase 3 also holds K3 on both of its routes (K3_CASES), K5 (int4_matmul;
its decode route's block count at K5_MIN_BLOCKS) and K6 (lm_step) against
their plain versions at the shapes phases 6 and 7 give them (K5 at 1, 3, 8
and 200 rows), K6's launch plan (at most one item a block a phase, a grid of
one block an SM, two launches bit-identical), K4 (dit_block) at the
estimator's full width with ragged lengths and a ragged T, and K7 (snake_aa)
at the recipe's first and last stage shapes and its edge cases in both
layouts, and its copy of sinf's fast path against sinf over every float
below 105615.  The timing
phase's K6 row adds its grid, plan, barrier share (sync_dev_ms: its 5 x L
grid barriers alone) and hbm_share (bytes / device time / 3.35 TB/s); the K4
row its launches' device times by kernel (phase_ms: LN1 + qkv, K2's
attention kernel, out-proj + LN3 + FFN) and K2 alone at the block's qkv
shape (k2_dev_ms); every row adds launches_continuous, its launches in the
continuous phase's windowed and incremental runs, launches_checkpoint, its
launches in the checkpoint phase's int8 and int4 requests, launches_v1,
its launches in the v1 phase's four requests, launches_phoneme, its
launches in the phoneme phase's three full-width runs, launches_lam, its
launches in the lam phase's chain, launches_multicode, its launches in
the multicode phase's B=1 and B=4 decodes, launches_gan, its launches in
the gan phase (all zero), launches_deploy, its launches in the deploy
phase's request from the assembled directory, launches_pho_train, its
launches in the pho_train phase (the LoRA-merged request's alone), and
launches_multi_card, its launches in the multi_card phase's ranks (summed)
under DP(2) and TP(2) (and int4_tp, the int4 TP decode's K5 launches),
and launches_export, its launches inside the export phase's reloaded
programs; two K1 rows at the TP-local heads (launches: the ranks'
full-width TP runs) and two K5 rows at the TP-local MLP shards (launches:
the int4 TP decode's one-row calls at the row's shape, both ranks) follow
the timing rows; the K2 and K3 rows add
v1_shapes, their times at the v1 estimator's two levels.  The line
before the card's line gives the whole run's seconds and each phase's.
The last line is {"ok": true, "device": {...}}.  Any failure exits non-zero.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12            # dense bf16 tensor-core peak
FP32_FLOPS = 67e12             # fp32 outside the tensor cores (K7's work)
# K7's fp32 operations per output: two upsampled samples of 6 taps and a
# snake (~20 with its sin) each, then the 12-tap decimation
K7_FLOPS_PER_OUTPUT = 2 * (6 * 2 + 20) + 12 * 2
# the recipe's four stage shapes, where the bigvgan phase runs K7: 4 rows of
# up to 250 tokens after the two 2x encoders and rates 8, 8*5, 8*5*3 and
# 8*5*3*2, with 1536 / 2^(i+1) channels
K7_STAGES = ((4, 8000, 768), (4, 40000, 384), (4, 120000, 192), (4, 240000, 96))
# K7 cases of phase 3 (each in both layouts): the recipe's first and last
# stage shapes, then T = 1, T = 5 with C = 3 (both edges clamp), beta absent,
# linear-scale alpha/beta, and C not a multiple of the channels-last route's
# 32-channel warp (T = 5, 130: the channels-first route's scalar loads)
K7_CASES = (((4, 8000, 768), True, True), ((4, 240000, 96), True, True),
            ((1, 1, 40), True, True), ((2, 5, 3), False, True), ((3, 700, 3), True, False),
            ((1, 130, 100), False, False))
# (atol, rtol) of a kernel against its plain version.  Both compute in fp32.
# fp32: they differ only in the order of the sums (~1e-6 at these shapes).
# bf16: both round one fp32 result to bf16 once, so they may differ by one
# bf16 ulp of |y| (<= 2**-7 |y|) and, near zero, by the fp32 difference.
CHECK_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-4, 2.0 ** -7)}
# K6 (lm_step) bar: max |kernel - plain| <= rel * max |plain| over the output
# hidden state and every layer's new k/v.  fp32: the two differ only in the
# order of fp32 sums (measured 1e-6 of max |y| at 24 layers).  bf16: both
# round every intermediate the way the JAX step does, but a sum that lands
# next to a bf16 rounding boundary can round the other way in one of them,
# and 24 random layers carry and grow that ulp: measured 2.6e-2 of max |y|
# (5.5 ulps of |y| ~ 13) on an H100, so the bar is twice that.
K6_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 6e-2}
# the LM's projection shapes (in, out) at Qwen2-0.5B width: q/o, k/v, gate/up, down
K5_SHAPES = ((896, 896), (896, 128), (896, 4864), (4864, 896))
# the projections of one decode step of a layer: q, k, v, o, gate, up, down
K5_STEP = ((896, 896), (896, 128), (896, 128), (896, 896), (896, 4864), (896, 4864),
           (4864, 896))
# K5's row counts in phase 3: decode (1 row, the split route) and 3, 8 and
# 200 rows (the 8-row prefill kernel)
K5_ROWS = (1, 3, 8, 200)
# the least blocks K5's decode route may launch at one row: one an SM at the
# three wide shapes; 896 -> 128 has only 57 KB of packed weights
K5_MIN_BLOCKS = {(896, 896): 132, (896, 128): 56, (896, 4864): 132, (4864, 896): 132}
# K3 cases of phase 3 (rows, C, x's offset in elements from a 16-byte boundary)
K3_CASES = ((2304, 256, 0), (1281, 256, 0), (37, 1024, 0), (37, 64, 0), (37, 96, 0),
            (100, 256, 1))
# K4 (dit_block) bar in bf16, on y and, on its own, on the attention output o
# (before the out projection; y is dominated by the residual, so a partial
# attention fault could hide in it): max |kernel - plain| <= K4_BF16_ULPS
# bf16 ulps at max |plain| of that tensor.  Both round at the TPU kernel's
# points, but a sum taken in another order (or p rounded against the online
# softmax's running max) can land across a bf16 rounding boundary, so o and
# the residual sums x1 and y may each move by one ulp.  fp32: CHECK_TOL.
K4_BF16_ULPS = 2
# K2 (dit_attention) bar in bf16: |kernel - plain| <= K2_BF16_ULPS bf16 ulps
# at the max |plain| of each (batch row, head) over its valid rows.  Both
# round q * sm_scale * log2 e and p to bf16 (the TPU kernel's points), but the
# kernel rounds p against the online softmax's running max and the plain
# version against the row max, so a p may round apart, a difference relative
# to the row and head's own magnitude; where the terms of an output cancel,
# that moves it by more than the elementwise CHECK_TOL allows a small |o|
# (each such check prints the share of elements outside CHECK_TOL).  fp32:
# CHECK_TOL.
K2_BF16_ULPS = 2
# K1's shape in the engine and batched phases: 8 rows of a 384-row cache with
# per-row frontiers spread over 100-380
K1_BATCH_POS = (100, 140, 180, 220, 260, 300, 340, 380)
# the continuous phase's bars on the small fp32 stack: each chunk of the
# windowed server on the card against the same stack's sequential
# tts(stream=True) on the CPU (the reference phase's bar), and the
# incremental server against the one-shot stream-masked flow on the card
# vocoded with the same windows (both fp32 on the card: sums in other orders)
CONT_WAV_TOL = 1e-2
INC_WAV_TOL = 1e-3
# the continuous phase's full-width traffic (bench.py's engine section): 8
# streams through 8 slots, 500 tokens a stream (min = max = 20 tokens a byte
# of a 25-byte text), hop_scale 2.0
CONT_STREAMS, CONT_TOKENS = 8, 150      # cut from 500 for the script's time
CONT_TEXT = "The quick brown fox jumps"
# the stream phase's decode cap (cut from 200 for the script's time)
STREAM_CAP = 60
# the batched phase: new-text lengths of 5-10 bytes give decode caps of 100-200
BATCH_TEXTS = ("Hello", "Hi there", "Good night", "See you", "Thank you", "Go ahead",
               "Next one", "Hi you")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def timed(stage: dict, key: str, fn):
    """fn, adding its synchronised host time to stage[key] on every call."""
    def run(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        stage[key] += time.perf_counter() - t0
        return out
    return run


def time_ms(fn, iters: int = 50) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rand_init_(module: torch.nn.Module, seed: int) -> None:
    """Seeded fan-in-scaled random weights: matrices and conv kernels
    ~ N(0, 1/sqrt(fan_in)), embedding tables ~ N(0, 0.02), 1-D non-bias
    params (norm scales, snake alphas) = 1, biases = 0."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.ndim >= 2:
                std = 0.02 if "embed" in name else (p.numel() // p.shape[0]) ** -0.5
                p.copy_(torch.randn(p.shape, generator=g, device="cuda") * std)
            elif "bias" not in name:
                p.fill_(1.0)
            else:
                p.zero_()


def check(name, dtype, got, want, phase="kernels"):
    """got against want within CHECK_TOL; every value finite."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    finite = bool(torch.isfinite(got).all())
    atol, rtol = CHECK_TOL[dtype]
    ok = bool(torch.allclose(got, want, atol=atol, rtol=rtol)) and finite
    emit({"phase": phase, "check": name, "dtype": str(dtype).split(".")[1],
          "max_abs_err": err, "atol": atol, "rtol": rtol, "finite": finite, "ok": ok})
    if not ok:
        raise AssertionError(f"{name} ({dtype}) disagrees with its plain version: {err}")
    return err


def check_attention(name, dtype, got, want, lengths, phase="kernels") -> float:
    """K2's [B, T, H, D] output against its plain version on the valid rows
    (t < lengths[b]): within CHECK_TOL (fp32), or (bf16) within K2_BF16_ULPS
    bf16 ulps at the max |plain| of each (batch row, head); every value
    finite."""
    got, want = got.float(), want.float()
    valid = (torch.arange(got.shape[1], device=got.device)[None, :]
             < lengths[:, None])[:, :, None, None].expand_as(got)
    diff = torch.where(valid, (got - want).abs(), 0.0)
    err = float(diff.max())
    finite = bool(torch.isfinite(got).all())
    atol, rtol = CHECK_TOL[dtype]
    outside = float((diff > atol + rtol * want.abs())[valid].float().mean())
    if dtype == torch.bfloat16:
        top = torch.where(valid, want.abs(), 0.0).amax(dim=(1, 3), keepdim=True)
        limit = K2_BF16_ULPS * torch.where(top > 0, torch.exp2(torch.floor(torch.log2(top)) - 7),
                                           0.0)
        live = limit > 0
        ok = bool((diff <= limit).all())
        bar = dict(bf16_ulps=K2_BF16_ULPS, limit_min=float(limit[live].min()),
                   limit_max=float(limit[live].max()),
                   worst_err_over_limit=float((diff.amax(dim=(1, 3), keepdim=True)
                                               / limit)[live].max()),
                   outside_check_tol=outside)
    else:
        ok, bar = outside == 0.0, dict(atol=atol, rtol=rtol)
    ok = ok and finite
    emit({"phase": phase, "check": name, "dtype": str(dtype).split(".")[1],
          "max_abs_err": err, **bar, "finite": finite, "ok": ok})
    if not ok:
        raise AssertionError(f"{name} ({dtype}) disagrees with its plain version: {err}")
    return err


def check_k1(K1, dtype, q, kn, vn, ck, cv, bias, pos, name="lm_decode_attention",
             phase="kernels") -> float:
    """One K1 step against its plain version on copies of the cache: the
    output within CHECK_TOL, the cache (with its appended rows) equal."""
    ck2, cv2 = ck.clone(), cv.clone()
    o, _, _ = K1.lm_decode_attention(q, kn, vn, ck, cv, bias, pos, 64, 0.125)
    o_ref, _, _ = K1.lm_decode_attention_plain(q, kn, vn, ck2, cv2, bias, pos, 64, 0.125)
    err = check(name, dtype, o, o_ref, phase=phase)
    if not (torch.equal(ck, ck2) and torch.equal(cv, cv2)):
        raise AssertionError(f"{name}: the cache differs from the plain version's")
    return err


def kernel_checks(K1, K2, K3) -> dict:
    """Each kernel against its plain version on the edge cases the main path
    may give it; returns the max error per kernel (bf16)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        r = lambda *s: torch.randn(*s, generator=g, device=dev).to(dtype)
        # K1: per-row frontiers incl. pos 0, pad bias, in-place append
        B, T, KHD = 4, 512, 128
        bias = torch.where(torch.rand(B, T, generator=g, device=dev) < 0.1, -1e9, 0.0)
        pos = torch.tensor([0, 17, 300, 511], dtype=torch.int32, device=dev)
        e = [check_k1(K1, dtype, r(B, 7, KHD), r(B, 1, KHD), r(B, 1, KHD), r(B, T, KHD),
                      r(B, T, KHD), bias, pos)]
        # K1 at B = 1 on each side of the split kernel's 32-key chunk
        # boundaries, at the main path's cache length (12 splits) and at 4096
        # and 8448 (128 and 264 splits: the merge's long loops), one cache
        # written step after step
        c = K1.CHUNK
        for Tc in (384, 4096, 8448):
            ck, cv = r(1, Tc, KHD), r(1, Tc, KHD)
            bias = torch.where(torch.rand(1, Tc, generator=g, device=dev) < 0.1, -1e9, 0.0)
            for p in (0, 1, c - 1, c, c + 1, Tc - 1):
                e.append(check_k1(K1, dtype, r(1, 7, KHD), r(1, 1, KHD), r(1, 1, KHD), ck, cv,
                                  bias, p, name=f"lm_decode_attention_Tc{Tc}_pos{p}"))
        errs["lm_decode_attention"] = max(e)
        # K2: T = 640, 1152 and 700 (a ragged query tail), lengths around the
        # 64-key tile and a length-0 row (valid rows only), packed and not
        e = []
        for Tq in (640, 1152, 700):
            qkv = r(6, Tq, 3 * 512)
            lens = torch.tensor([0, 1, 63, 64, 65, Tq], dtype=torch.int32, device=dev)
            q3, k3, v3 = (qkv[..., i * 512:(i + 1) * 512].reshape(6, Tq, 8, 64)
                          for i in range(3))
            o_ref = K2.dit_attention_plain(q3, k3, v3, lens, 0.125)
            o = K2.dit_attention_packed(qkv, lens, 0.125, 64).reshape(6, Tq, 8, 64)
            e.append(check_attention(f"dit_attention_T{Tq}", dtype, o, o_ref, lens))
            if o[0].abs().max() != 0:
                raise AssertionError("dit_attention: the length-0 row is not zero")
            o_un = K2.dit_attention(q3.contiguous(), k3.contiguous(), v3.contiguous(), lens,
                                    0.125)
            e.append(check_attention(f"dit_attention_unpacked_T{Tq}", dtype, o_un, o_ref,
                                     lens))
        errs["dit_attention"] = max(e)
        # K3: LayerNorm with and without the fused mish, on both routes: the
        # vector route at the estimator's width (an odd row count leaves a
        # warp's second row absent) and at C = 1024; the element route at
        # C = 64 and 96 and for an x that is not 16-byte aligned
        e = []
        for N, C, off in K3_CASES:
            x = (r(N * C + off) * 3)[off:].view(N, C)
            w, b = r(C), r(C)
            for act in ("none", "mish"):
                name = f"fused_layer_norm_{N}x{C}{'_unaligned' if off else ''}_{act}"
                e.append(check(name, dtype, K3.fused_layer_norm(x, w, b, 1e-5, act),
                               K3.layer_norm_plain(x, w, b, 1e-5, act)))
        errs["fused_layer_norm"] = max(e)
    return errs


def bf16_ulp(v: float) -> float:
    """The spacing of bf16 numbers at magnitude v (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(v)) - 7) if v > 0 else 0.0


def check_block(name, dtype, got, want, phase="kernels") -> float:
    """K4 against its plain version, each given as (y, o): y and the attention
    output o each finite and within CHECK_TOL (fp32) or K4_BF16_ULPS bf16
    ulps at its own max |plain| (bf16).  Returns the error of y."""
    parts, ok = {}, True
    for part, g, w in (("y", got[0], want[0]), ("attention", got[1], want[1])):
        g, w = g.float(), w.float()
        err = float((g - w).abs().max())
        finite = bool(torch.isfinite(g).all())
        if dtype == torch.float32:
            atol, rtol = CHECK_TOL[dtype]
            within, bar = bool(torch.allclose(g, w, atol=atol, rtol=rtol)), dict(atol=atol,
                                                                                 rtol=rtol)
        else:
            limit = K4_BF16_ULPS * bf16_ulp(float(w.abs().max()))
            within, bar = err <= limit, dict(limit=limit, bf16_ulps=K4_BF16_ULPS)
        parts[part] = dict(max_abs_err=err, **bar, finite=finite, ok=within and finite)
        ok = ok and within and finite
    emit({"phase": phase, "check": name, "dtype": str(dtype).split(".")[1], **parts, "ok": ok})
    if not ok:
        raise AssertionError(f"{name} ({dtype}) disagrees with its plain version: {parts}")
    return parts["y"]["max_abs_err"]


def block_checks(K4) -> float:
    """K4 against its plain version at the estimator's full width (dim 256,
    8 x 64 heads, ff 1024) in fp32 and bf16: the batched phase's shape
    [16, 640], T = 1152 (a multiple of 128 that is not a power of two) and
    T = 600 (a ragged last row tile), each with one L = T row, one L = 0 row
    and ragged rows; every row is compared.  Returns the largest bf16
    error."""
    g = torch.Generator(device="cuda").manual_seed(8)
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for B, T in ((16, 640), (4, 1152), (4, 600)):
            lens = [T, 0] + [int(T * (1 - 0.06 * i)) for i in range(1, B - 1)]
            x = torch.randn(B, T, 256, generator=g, device="cuda").to(dtype)
            w = K4.random_block_weights(256, 8, 64, 1024, dtype, g, "cuda")
            L = torch.tensor(lens, dtype=torch.int32, device="cuda")
            kw = dict(sm_scale=0.125, heads=8, head_dim=64, return_attention=True)
            e = check_block(f"dit_block_{B}x{T}", dtype, K4.dit_block_fused(x, L, *w, **kw),
                            K4.dit_block_plain(x, L, *w, **kw))
            if dtype == torch.bfloat16:
                err = max(err, e)
    return err


def step_inputs(K6, dtype, seed: int, L: int = 24, C: int = 384, pos: int = 364) -> dict:
    """One full-width B=1 decode step's inputs for K6: seeded random int8 step
    weights at Qwen2-0.5B widths, x, caches [L, C, 128], RoPE at pos."""
    from cosyvoice_tpu_torch.models.qwen2 import rope_cos_sin

    g = torch.Generator(device="cuda").manual_seed(seed)
    w = K6.random_step_weights(L, 896, 4864, 14, 2, 64, g, "cuda")
    x = torch.randn(1, 896, generator=g, device="cuda").to(dtype)
    kc, vc = (torch.randn(L, C, 128, generator=g, device="cuda").to(dtype) for _ in range(2))
    cos, sin = (t[0, 0] for t in rope_cos_sin(torch.tensor([[pos]], device="cuda"), 64,
                                              1e6, torch.float32))
    return dict(w=w, x=x, kc=kc, vc=vc, pos=pos, cos=cos, sin=sin)


def run_step(K6, inp: dict, plain: bool = False, kc=None, vc=None):
    fn = K6.lm_step_plain if plain else K6.lm_step
    return fn(inp["w"], inp["x"], inp["kc"] if kc is None else kc,
              inp["vc"] if vc is None else vc, inp["pos"], inp["cos"], inp["sin"],
              nq=14, nkv=2, hd=64)


def check_step(K6, inp: dict, dtype, phase="kernels") -> float:
    """K6 against its plain version: the output hidden state and every
    layer's new k/v row; the rest of the cache must stay untouched."""
    kc2, vc2 = inp["kc"].clone(), inp["vc"].clone()
    y = run_step(K6, inp)
    y_ref = run_step(K6, inp, plain=True, kc=kc2, vc=vc2)
    pos, rel = inp["pos"], K6_REL_TOL[dtype]
    errs, ok = {}, True
    for name, got, want in (("y", y, y_ref), ("new_k", inp["kc"][:, pos], kc2[:, pos]),
                            ("new_v", inp["vc"][:, pos], vc2[:, pos])):
        got, want = got.float(), want.float()
        errs[name] = float((got - want).abs().max())
        ok &= errs[name] <= rel * float(want.abs().max())
    rest = [c[:, r] for c in (inp["kc"], kc2, inp["vc"], vc2)
            for r in (slice(0, pos), slice(pos + 1, None))]
    untouched = all(torch.equal(rest[i], rest[i + 2]) for i in (0, 1, 4, 5))
    emit({"phase": phase, "check": "lm_step", "dtype": str(dtype).split(".")[1],
          "max_abs_err": errs, "max_abs_plain": float(y_ref.float().abs().max()),
          "rel_tol": rel, "cache_rest_untouched": untouched, "ok": ok and untouched})
    if not (ok and untouched):
        raise AssertionError(f"lm_step ({dtype}) disagrees with its plain version: {errs}")
    return max(errs.values())


def step_plan(K6, C: int, dev) -> dict:
    """K6's launch plan for a full-width step with a C-row cache on this card."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return K6.plan(896, 4864, 14, 2, C, sms)


def quant_kernel_checks(K5, K6) -> dict:
    """K5's launch plan at one row (at least K5_MIN_BLOCKS blocks), then K5
    at the LM's projection shapes (K5_ROWS rows, group 128) and K6 for one
    full-width step at pos 364, each against its plain version in fp32 and
    bf16; returns the max error per kernel (bf16)."""
    g = torch.Generator(device="cuda").manual_seed(5)
    errs = {"int4_matmul": 0.0, "lm_step": 0.0}
    for (IN, OUT), need in K5_MIN_BLOCKS.items():
        p = K5.plan(1, IN, OUT, 128)
        ok = p["route"] == "split" and p["blocks"] >= need
        emit({"phase": "kernels", "check": f"int4_matmul_plan_1x{IN}x{OUT}", **p,
              "min_blocks": need, "ok": ok})
        if not ok:
            raise AssertionError(f"int4_matmul at 1x{IN}x{OUT} launches {p}")
    for dtype in (torch.float32, torch.bfloat16):
        for IN, OUT in K5_SHAPES:
            w = K5.pack_int4(torch.randint(-7, 8, (IN, OUT), generator=g, device="cuda"))
            scale = torch.rand(IN // 128, OUT, generator=g, device="cuda") * 0.02 + 1e-3
            for rows in K5_ROWS:
                x = torch.randn(rows, IN, generator=g, device="cuda").to(dtype)
                e = check(f"int4_matmul_{rows}x{IN}x{OUT}", dtype, K5.int4_matmul(x, w, scale),
                          K5.int4_matmul_plain(x, w, scale))
                errs["int4_matmul"] = max(errs["int4_matmul"], e)
        errs["lm_step"] = check_step(K6, step_inputs(K6, dtype, 6), dtype)
    # K6's plan: at most one item a block in every phase, on a grid of one
    # block an SM; two launches on the same inputs give the same bits (fixed
    # merge order)
    p = step_plan(K6, 384, "cuda")
    items = {k: p[k]["items"] for k in ("qkv", "o", "gate_up", "down", "attention")}
    inp = step_inputs(K6, torch.bfloat16, 6)
    caches = [(inp["kc"].clone(), inp["vc"].clone()) for _ in range(2)]
    y1, y2 = (run_step(K6, inp, kc=kc, vc=vc) for kc, vc in caches)
    same = bool(torch.equal(y1, y2)) and all(torch.equal(a, b) for a, b in zip(*caches))
    grid = K6.sync_probe(1, "cuda")                  # the grid lm_step launches
    ok = max(items.values()) <= p["blocks"] == grid and same
    emit({"phase": "kernels", "check": "lm_step_plan", "blocks": p["blocks"], "grid": grid,
          "items": items, "region_bytes": p["region_bytes"], "smem_bytes": p["smem_bytes"],
          "two_launches_bit_identical": same, "ok": ok})
    if not ok:
        raise AssertionError(f"lm_step plan {items} on {p['blocks']} blocks (grid {grid}), "
                             f"bit-identical: {same}")
    return errs


def snake_inputs(shape, beta: bool, logscale: bool, g):
    """x [B, T, C] ~ N(0, 1) and per-channel alpha, beta: 0.3 N under
    logscale, 1 + 0.3 N otherwise (near each init); beta None if absent."""
    C = shape[-1]
    x = torch.randn(*shape, generator=g, device="cuda")
    a, b = (torch.randn(C, generator=g, device="cuda") * 0.3 + (0.0 if logscale else 1.0)
            for _ in range(2))
    return x, a, (b if beta else None), logscale


def channels_first(x: torch.Tensor) -> torch.Tensor:
    """x [B, T, C] with the same values in channels-first memory, as
    BigVGAN's convolutions leave it (x.transpose(1, 2) contiguous)."""
    return x.transpose(1, 2).contiguous().transpose(1, 2)


def snake_checks(K7) -> float:
    """K7 against its plain version, fp32, every sample (edges included),
    on the full-width stage shapes and the edge cases of K7_CASES, each with
    x channels-last and channels-first (y must come back with x's strides);
    then the kernel's copy of sinf's fast path against sinf itself, bit for
    bit, over every float below 105615."""
    g = torch.Generator(device="cuda").manual_seed(10)
    err = 0.0
    for shape, beta, logscale in K7_CASES:
        x, a, b, ls = snake_inputs(shape, beta, logscale, g)
        want = K7.snake_aa_plain(x, a, b, ls)
        for layout, xx in ((K7.CHANNELS_LAST, x), (K7.CHANNELS_FIRST, channels_first(x))):
            name = ("snake_aa_" + "x".join(map(str, shape)) + ("" if beta else "_nobeta")
                    + ("" if logscale else "_linear") + "_" + layout)
            y = K7.snake_aa(xx, a, b, ls)
            if y.stride() != xx.stride():
                raise AssertionError(f"{name}: y strides {y.stride()}, x {xx.stride()}")
            err = max(err, check(name, torch.float32, y, want))
    mismatches = K7.sin2_mismatches("cuda")
    emit({"phase": "kernels", "check": "snake_aa_sin2_equals_sinf", "mismatches": mismatches,
          "ok": mismatches == 0})
    if mismatches:
        raise AssertionError(f"snake_aa: sin2 differs from sinf on {mismatches} floats")
    return err


def small_stack(device: str, max_decode_tokens: int = 60, stream: bool = False):
    """A small fp32 stack whose widths the kernels take (head_dim 64, C % 32 == 0);
    `stream` gives its flow the stream family's estimator (2 chunks of left
    context, the incremental flow's configuration)."""
    from cosyvoice_tpu_torch.models.conformer import ConformerConfig
    from cosyvoice_tpu_torch.models.flow import (CausalMaskedDiffWithXvec, EstimatorConfig,
                                                 FlowConfig)
    from cosyvoice_tpu_torch.models.hift import HiFTConfig, HiFTGenerator
    from cosyvoice_tpu_torch.models.llm import LMConfig, Qwen2LM, SamplingConfig
    from cosyvoice_tpu_torch.models.qwen2 import Qwen2Config
    from cosyvoice_tpu_torch.runtime.model import CosyVoice2Model

    torch.manual_seed(0)
    llm = Qwen2LM(LMConfig(128, 128, 64, sampling=SamplingConfig(method="greedy"),
                           qwen=Qwen2Config(vocab_size=300, hidden_size=128, num_layers=2,
                                            num_heads=4, num_kv_heads=2, head_dim=64,
                                            intermediate_size=256, rope_theta=10000.0,
                                            fused_cache_update=True)))
    flow = CausalMaskedDiffWithXvec(FlowConfig(
        64, 80, 24, 67, encoder=ConformerConfig(64, 4, 128, 1, 64, static_chunk_size=50),
        estimator=EstimatorConfig(in_channels=320, channels=(64,), n_blocks=1,
                                  num_mid_blocks=1, num_heads=2, attention_head_dim=64,
                                  fused_attention=True, fused_norm=True, approx_gelu=True,
                                  stream=stream, left_chunks=2 if stream else -1)))
    hift = HiFTGenerator(HiFTConfig(base_channels=64, nb_harmonics=2, f0_cond_channels=32,
                                    resblock_kernel_sizes=(3,),
                                    resblock_dilation_sizes=((1, 3),)), deterministic=True)
    return CosyVoice2Model(llm=llm, flow=flow, hift=hift, max_decode_tokens=max_decode_tokens,
                           device=device)


def reference_check() -> dict:
    """The same small stack and inputs on the GPU (kernels) and on the CPU
    (plain versions): greedy tokens exact, waveform within 1e-2."""
    rng = np.random.default_rng(3)
    inputs = dict(text_tokens=rng.integers(0, 256, 20), prompt_text_len=5,
                  llm_prompt_speech_token=rng.integers(0, 64, 25),
                  flow_prompt_speech_token=rng.integers(0, 64, 25),
                  prompt_speech_feat=rng.standard_normal((50, 80)).astype(np.float32),
                  flow_embedding=rng.standard_normal(24).astype(np.float32))
    out = {}
    for device in ("cuda", "cpu"):
        model = small_stack(device)
        tokens = model.llm_generate(inputs["text_tokens"], 5,
                                    inputs["llm_prompt_speech_token"], None)
        wav = next(model.tts(**inputs, gen=torch.Generator().manual_seed(0)))["tts_speech"]
        out[device] = (tokens, wav)
    (tok_g, wav_g), (tok_c, wav_c) = out["cuda"], out["cpu"]
    err = float(np.abs(wav_g - wav_c).max()) if wav_g.shape == wav_c.shape else float("inf")
    res = {"phase": "reference", "tokens": len(tok_g), "tokens_equal": bool(
        np.array_equal(tok_g, tok_c)), "wav_samples": len(wav_g), "wav_max_abs_err": err,
        "tol": 1e-2}
    emit(res)
    if not res["tokens_equal"] or not err <= 1e-2 or not np.isfinite(wav_g).all():
        raise AssertionError(f"GPU stack disagrees with the CPU stack: {res}")
    return res


def serving_flow(seed: int):
    """The full-width bf16 serving flow (FlowConfig() with the estimator's
    fused attention and norm, K2 + K3) on the card, seeded random weights."""
    import dataclasses

    from cosyvoice_tpu_torch.models.flow import CausalMaskedDiffWithXvec, FlowConfig

    fcfg = FlowConfig()
    with torch.device("cuda"):
        flow = CausalMaskedDiffWithXvec(dataclasses.replace(
            fcfg, encoder_dtype="bfloat16", estimator=dataclasses.replace(
                fcfg.estimator, dtype="bfloat16", fused_attention=True, fused_norm=True,
                approx_gelu=True)))
    rand_init_(flow, seed)
    flow.encoder.to(torch.bfloat16)
    flow.decoder.estimator.to(torch.bfloat16)
    return flow


def full_width_stack():
    """The full-width serving stack (LMConfig/FlowConfig/HiFTConfig defaults)
    on seeded random weights."""
    import dataclasses

    from cosyvoice_tpu_torch.models.hift import HiFTConfig, HiFTGenerator
    from cosyvoice_tpu_torch.models.llm import LMConfig, Qwen2LM
    from cosyvoice_tpu_torch.utils.quant import quantize_qwen_int8

    lm_cfg = LMConfig()
    with torch.device("cuda"):      # build the modules on the card directly
        fp = Qwen2LM(lm_cfg)
        rand_init_(fp, 12345)
        state = quantize_qwen_int8(fp.to(torch.bfloat16).state_dict())
        del fp
        llm = Qwen2LM(dataclasses.replace(lm_cfg, qwen=dataclasses.replace(
            lm_cfg.qwen, quant="int8", fused_cache_update=True))).to(torch.bfloat16)
        llm.load_state_dict(state, strict=True)
        del state
        flow = serving_flow(12346)
        hift = HiFTGenerator(dataclasses.replace(HiFTConfig(), dtype="bfloat16",
                                                 approx_sin=True))
        rand_init_(hift, 12347)
        hift.to(torch.bfloat16)
    return llm, flow, hift


def main_path(K1, K2, K3, smi: str) -> dict:
    from cosyvoice_tpu_torch.runtime.api import CosyVoice2
    from cosyvoice_tpu_torch.runtime.frontend import CosyVoiceFrontEnd
    from cosyvoice_tpu_torch.runtime.model import CosyVoice2Model
    from cosyvoice_tpu_torch.tokenizer.text import ByteTokenizer

    t0 = time.perf_counter()
    llm, flow, hift = full_width_stack()
    model = CosyVoice2Model(llm=llm, flow=flow, hift=hift, max_decode_tokens=200,
                            device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def seeded(wav):
        return np.random.default_rng(int(np.abs(wav).sum() * 1e3) % (1 << 32))

    frontend = CosyVoiceFrontEnd(
        tokenizer=ByteTokenizer(),
        speech_tokenizer=lambda wav: seeded(wav).integers(0, 6561, len(wav) * 25 // 16000),
        spk_embedder=lambda wav: seeded(wav).standard_normal(192).astype(np.float32))
    cv = CosyVoice2(frontend=frontend, model=model)
    decodes, prompts, stage = [], [], {"lm_s": 0.0, "flow_s": 0.0, "hift_s": 0.0}

    def recording_generate(text_tokens, prompt_text_len, prompt_speech, gen):
        tokens = generate(text_tokens, prompt_text_len, prompt_speech, gen)
        decodes.append((len(text_tokens), len(prompt_speech), len(tokens)))
        prompts.append((np.asarray(text_tokens), np.asarray(prompt_speech)))
        return tokens

    generate = timed(stage, "lm_s", model.llm_generate)
    model.llm_generate = recording_generate
    model._flow_chunk = timed(stage, "flow_s", model._flow_chunk)
    model._vocode = timed(stage, "hift_s", model._vocode)
    t = np.arange(48000) / 16000.0
    prompt = (0.3 * np.sin(2 * np.pi * 220 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
              + 0.01 * np.random.default_rng(0).standard_normal(len(t))).astype(np.float32)
    texts = ["Hello there.", "The quick brown fox jumps over the lazy dog.",
             "The port runs the whole zero-shot path on the card, one kernel at a time."]

    def request(i, text):
        for key in stage:
            stage[key] = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wavs = [o["tts_speech"] for o in cv.inference_zero_shot(
            text, "A short prompt.", prompt, gen=torch.Generator().manual_seed(i))]
        torch.cuda.synchronize()
        latency = time.perf_counter() - t0
        n_tok = decodes[-1][2]
        wav = np.concatenate(wavs)
        if len(wavs) != 1 or wav.shape != (n_tok * 2 * 480,) or not np.isfinite(wav).all() \
                or n_tok == 0:
            raise AssertionError(f"request {i}: wav {wav.shape} for {n_tok} tokens")
        return {"text_bytes": len(text.encode()), "speech_tokens": n_tok,
                "wav_samples": len(wav), "latency_s": latency,
                "rtf": latency / (len(wav) / 24000.0), **stage,
                "lm_ms_per_token": stage["lm_s"] * 1e3 / n_tok}

    for mod in (K1, K2, K3):
        mod.launches = 0
    torch.cuda.reset_peak_memory_stats()
    requests = [request(i, text) for i, text in enumerate(texts)]
    launches = {"lm_decode_attention": K1.launches, "dit_attention": K2.launches,
                "fused_layer_norm": K3.launches}
    res = {"phase": "main_path", "card": smi, "setup_s": setup_s, "requests": requests,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30, "launches": launches}
    emit(res)
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    res.update(last_decode=decodes[-1], first_prompt=prompts[0], first_text=texts[0],
               prompt_wav=prompt, stack=(llm, flow, hift, frontend), model=model,
               request=request, texts=texts)
    return res


def teacher_forced_argmax(lm, step_w, text, psp, forced, cache_len: int, fused: bool):
    """Feed `forced` token by token after the prefill, through the K1 decode
    path (forward_hidden at T=1) or one K6 launch a step; -> the argmax of
    the logits after each fed token."""
    from cosyvoice_tpu_torch.models.qwen2 import (KVCache, causal_prefill_bias, rms_norm,
                                                  rope_cos_sin)
    from cosyvoice_tpu_torch.ops.kernels.lm_step import cache_to_step_layout, lm_step
    from cosyvoice_tpu_torch.ops.masks import NEG_INF

    q, dev = lm.cfg.qwen, text.device
    emb, seq_len = lm.prefill_embeds(text, torch.tensor([text.shape[1]], device=dev), psp,
                                     torch.tensor([psp.shape[1]], device=dev))
    Tp = emb.shape[1]
    cache = KVCache.create(q, 1, cache_len, emb.dtype, dev)
    _, cache = lm.forward_hidden(emb, torch.arange(Tp, device=dev)[None],
                                 causal_prefill_bias(Tp, cache_len, seq_len, 1, emb.dtype, dev),
                                 cache)
    kc, vc = cache_to_step_layout(cache.k, cache.v, cache_len)
    slot = torch.arange(cache_len, device=dev)
    out = []
    for t, tok in enumerate(forced.tolist()):
        pos = Tp + t
        e = lm.speech_emb(torch.tensor([[tok]], device=dev))
        if fused:
            cos, sin = rope_cos_sin(torch.tensor([[pos]], device=dev), q.head_dim,
                                    q.rope_theta, torch.float32)
            y = lm_step(step_w, e[0], kc, vc, pos, cos[0, 0], sin[0, 0], nq=q.num_heads,
                        nkv=q.num_kv_heads, hd=q.head_dim, eps=q.rms_norm_eps)
            h = rms_norm(y, lm.body.norm.weight, q.rms_norm_eps)[None]
        else:
            bias = torch.where(slot <= pos, 0.0, NEG_INF).to(emb.dtype)[None, None, None]
            h, cache = lm.forward_hidden(e, torch.tensor([[pos]], device=dev), bias, cache)
        out.append(lm.decode_logits(h)[0, 0].argmax())
    return torch.stack(out)


@torch.no_grad()
def fused_step_phase(llm, prompt, K1, K6, smi: str, n: int = 200) -> dict:
    """The main path's int8 LM (its weights, shared) with greedy sampling,
    from the first request's prompt, n steps (EOS masked throughout):
    lm_generate (K1 in every layer) against lm_generate_fused_step (K6)."""
    from cosyvoice_tpu_torch.models.llm import (Qwen2LM, SamplingConfig, lm_generate,
                                                lm_generate_fused_step, lm_step_supported)
    from cosyvoice_tpu_torch.ops.kernels.lm_step import pack_step_weights
    from cosyvoice_tpu_torch.runtime.model import round_up

    cfg = dataclasses.replace(llm.cfg, sampling=SamplingConfig(method="greedy"))
    if not lm_step_supported(cfg.qwen):
        raise AssertionError(f"the main path's LM is not one lm_step takes: {cfg.qwen}")
    with torch.device("cuda"):
        lm = Qwen2LM(cfg)
    lm.load_state_dict(llm.state_dict(), strict=True, assign=True)
    lm.eval()
    step_w = pack_step_weights(lm.body.state_dict(), cfg.qwen.num_layers)
    text_tokens, prompt_speech = prompt
    text = torch.as_tensor(text_tokens, dtype=torch.long, device="cuda")[None]
    psp = torch.as_tensor(prompt_speech, dtype=torch.long, device="cuda")[None]
    cache_len = round_up(2 + text.shape[1] + psp.shape[1] + n, 128)
    lens = [torch.tensor([v], device="cuda") for v in (text.shape[1], psp.shape[1], n, n)]
    args = (text, lens[0], psp, lens[1], lens[2], lens[3], None)
    decode_logits, heads = lm.decode_logits, [0]

    def counting_head(h):       # one call per sampled token: decode steps + 1
        heads[0] += 1
        return decode_logits(h)

    lm.decode_logits = counting_head
    runs = {}
    for name, fn in (("k1_path", lambda: lm_generate(lm, *args, max_steps=n,
                                                     cache_len=cache_len)),
                     ("fused_step", lambda: lm_generate_fused_step(
                         lm, step_w, *args, max_steps=n, cache_len=cache_len))):
        K1.launches = K6.launches = heads[0] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, cnt = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        count = int(cnt[0])
        runs[name] = dict(tokens=count, decode_steps=heads[0] - 1, s=wall,
                          ms_per_token=wall * 1e3 / max(count, 1),
                          k1_launches=K1.launches, k6_launches=K6.launches,
                          out=out[0, :count].cpu())
    lm.decode_logits = decode_logits
    a, b = runs["k1_path"]["out"], runs["fused_step"]["out"]
    m = min(len(a), len(b))
    differ = torch.nonzero(a[:m] != b[:m]).flatten()
    match = int(differ[0]) if len(differ) else m
    tf = [teacher_forced_argmax(lm, step_w, text, psp, a[:-1], cache_len, fused)
          for fused in (False, True)]
    agree = float((tf[0] == tf[1]).float().mean())
    for r in runs.values():
        del r["out"]
    res = {"phase": "fused_step", "card": smi, "steps": n, "runs": runs,
           "free_running_match_tokens": match, "teacher_forced_steps": len(tf[0]),
           "teacher_forced_agreement": agree, "agreement_gate": 0.9,
           "k6_launches": runs["fused_step"]["k6_launches"]}
    emit(res)
    fs = runs["fused_step"]
    if fs["k6_launches"] != fs["decode_steps"] or fs["decode_steps"] < 1:
        raise AssertionError(f"K6 launched {fs['k6_launches']} times for "
                             f"{fs['decode_steps']} decode steps")
    del step_w, lm
    return res


@torch.no_grad()
def int4_phase(res_main: dict, K1, K5, smi: str) -> dict:
    """One full-width zero-shot request (the main path's first) with the LM
    quantized to packed int4 at group 128 from the same seeded bf16 weights;
    then the teacher-forced argmax agreement of the int4 LM with the bf16 LM
    over the request's generated tokens.  Then int4xla (PyTorch ops, no
    TPU kernel; decode attention on K1) from the same weights, without and
    with AWQ: int4xla_small_checks, and int4xla_run for each (gates: tokens
    equal and logits close on the small stack; INT4XLA_TOKENS steps, K1
    exactly 24 x (steps - 1), no K5 launch at full width)."""
    from cosyvoice_tpu_torch.models.llm import LMConfig, Qwen2LM
    from cosyvoice_tpu_torch.models.qwen2 import causal_prefill_bias
    from cosyvoice_tpu_torch.runtime.api import CosyVoice2
    from cosyvoice_tpu_torch.runtime.model import CosyVoice2Model
    from cosyvoice_tpu_torch.utils.quant import quantize_qwen_int4

    _, flow, hift, frontend = res_main["stack"]
    lm_cfg = LMConfig()
    with torch.device("cuda"):
        fp = Qwen2LM(lm_cfg)
        rand_init_(fp, 12345)           # the seed full_width_stack() draws the LM from
        fp = fp.to(torch.bfloat16).eval()
        llm4 = Qwen2LM(dataclasses.replace(lm_cfg, qwen=dataclasses.replace(
            lm_cfg.qwen, quant="int4", quant_group=128, fused_cache_update=True)))
    llm4.load_state_dict(quantize_qwen_int4(fp.state_dict(), group_size=128), strict=True,
                         assign=True)
    model = CosyVoice2Model(llm=llm4, flow=flow, hift=hift, max_decode_tokens=200,
                            device="cuda")
    cv = CosyVoice2(frontend=frontend, model=model)
    generate, got, lm_s = model.llm_generate, [], [0.0]

    def timed_generate(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens = generate(*a)
        torch.cuda.synchronize()
        lm_s[0] += time.perf_counter() - t0
        got.append(tokens)
        return tokens

    model.llm_generate = timed_generate
    K5.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wavs = [o["tts_speech"] for o in cv.inference_zero_shot(
        res_main["first_text"], "A short prompt.", res_main["prompt_wav"],
        gen=torch.Generator().manual_seed(0))]
    torch.cuda.synchronize()
    latency = time.perf_counter() - t0
    k5_launches = K5.launches
    wav = np.concatenate(wavs)
    n_tok = len(got[-1])

    text_tokens, prompt_speech = res_main["first_prompt"]
    seq = np.concatenate([prompt_speech, got[-1]])
    text = torch.as_tensor(text_tokens, dtype=torch.long, device="cuda")[None]
    sp = torch.as_tensor(seq, dtype=torch.long, device="cuda")[None]

    def tf_argmax(m):
        emb, seq_len = m.prefill_embeds(text, torch.tensor([text.shape[1]], device="cuda"), sp,
                                        torch.tensor([sp.shape[1]], device="cuda"))
        T = emb.shape[1]
        h, _ = m.forward_hidden(emb, torch.arange(T, device="cuda")[None],
                                causal_prefill_bias(T, T, seq_len, 1, emb.dtype, "cuda"))
        # the predictions of the n_tok generated tokens
        return m.decode_logits(h)[0, T - n_tok - 1:T - 1].argmax(-1)

    want = tf_argmax(fp)
    agree = float((tf_argmax(llm4) == want).float().mean()) if n_tok else 0.0
    # the device time of one decode step's 168 projections at one row, by
    # weight format (int8: the main path's LM)
    proj = {name: dev_time(projection_step(m))
            for name, m in (("bf16", fp), ("int8", res_main["stack"][0]), ("int4", llm4))}
    del model, cv, llm4
    torch.cuda.empty_cache()
    xla = {"small_fp32": int4xla_small_checks(),
           **{name: int4xla_run(fp, awq, K1, K5, tf_argmax, want)
              for name, awq in (("plain", False), ("awq", True))}}
    res = {"phase": "int4", "card": smi, "speech_tokens": n_tok, "wav_samples": len(wav),
           "latency_s": latency, "rtf": latency / max(len(wav) / 24000.0, 1e-9),
           "lm_s": lm_s[0], "lm_ms_per_token": lm_s[0] * 1e3 / max(n_tok, 1),
           "k5_launches": k5_launches, "wav_finite": bool(np.isfinite(wav).all()),
           "teacher_forced_agreement_vs_bf16": agree, "projections_step_dev": proj,
           "int4xla": xla}
    emit(res)
    if not k5_launches or not res["wav_finite"] or n_tok == 0 \
            or wav.shape != (n_tok * 2 * 480,):
        raise AssertionError(f"int4 request failed: {res}")
    small = xla["small_fp32"]
    gates = [small[k]["tokens_equal"] and small[k]["logits_close"] and small[k]["tokens"] > 0
             for k in ("plain", "awq")]
    gates += [xla[k]["steps"] == INT4XLA_TOKENS and xla[k]["k1_launches"] == xla[k][
        "k1_launches_expected"] and xla[k]["k5_launches"] == 0 for k in ("plain", "awq")]
    if not all(gates):
        raise AssertionError(f"int4xla failed: {gates} {xla}")
    return res


# the int4 phase's int4xla runs: greedy tokens a decode, the group size
INT4XLA_TOKENS, INT4XLA_GROUP = 50, 128      # steps cut from 200 for the script's time


def projection_step(lm):
    """A callable that runs every QDense of lm's Qwen2 body once on one row
    of its input width (a decode step's projections, attention left out)."""
    from cosyvoice_tpu_torch.models.qwen2 import QDense

    dtype = lm.llm_embedding.weight.dtype
    width = {"int4xla": lambda w: w.shape[0], "int4": lambda w: 2 * w.shape[0]}
    calls = [(m, torch.randn(1, width.get(m.quant, lambda w: w.shape[1])(m.weight),
                             device="cuda", dtype=dtype))
             for m in lm.body.modules() if isinstance(m, QDense)]
    return lambda: [m(x) for m, x in calls]


def int4xla_calibration(device: str, vocab: int, speech: int, seed: int) -> tuple:
    """One seeded calibration request (20 text ids, a 75-token prompt) on
    `device` -> collect_act_stats's arguments."""
    rng = np.random.default_rng(seed)
    t = lambda x: torch.as_tensor(np.asarray(x), device=device)
    return t(rng.integers(0, vocab, (1, 20))), t([20]), t(rng.integers(0, speech, (1, 75))), t([75])


def int4xla_lm(fp, act_amax, device: str, group: int = INT4XLA_GROUP):
    """`fp`'s weights quantized to int4xla (AWQ first with `act_amax`) in a
    Qwen2LM of fp's dtype on `device`, greedy, over the packed decode
    cache."""
    from cosyvoice_tpu_torch.models.llm import Qwen2LM, SamplingConfig
    from cosyvoice_tpu_torch.utils.quant import quantize_qwen_int4xla

    cfg = fp.cfg
    cfg = dataclasses.replace(cfg, sampling=SamplingConfig(method="greedy"),
                              qwen=dataclasses.replace(cfg.qwen, quant="int4xla",
                                                       quant_group=group,
                                                       fused_cache_update=True))
    state = quantize_qwen_int4xla(fp.state_dict(), group_size=group, act_amax=act_amax)
    dtype = fp.llm_embedding.weight.dtype
    with torch.device(device):
        lm = Qwen2LM(cfg).to(dtype)
    lm.load_state_dict(state, strict=True)
    return lm.eval()


@torch.no_grad()
def int4xla_small_checks() -> dict:
    """The small stack's LM (small_stack) quantized to int4xla at group 64,
    without and with AWQ (calibrated on the CPU), in fp32 on the card
    against the CPU: teacher-forced logits within 2e-5 and 40 greedy
    tokens equal."""
    from cosyvoice_tpu_torch.models.llm import collect_act_stats, lm_generate
    from cosyvoice_tpu_torch.models.qwen2 import causal_prefill_bias

    fp = small_stack("cpu").llm
    stats = collect_act_stats(fp, *int4xla_calibration("cpu", 300, 64, 61))
    rng = np.random.default_rng(62)
    text, psp = rng.integers(0, 300, (1, 12)), rng.integers(0, 64, (1, 30))
    out = {}
    for name, amax in (("plain", None), ("awq", stats)):
        got = {}
        for dev in ("cuda", "cpu"):
            lm = int4xla_lm(fp, amax, dev, group=64)
            t = lambda x: torch.as_tensor(np.asarray(x), device=dev)
            emb, seq_len = lm.prefill_embeds(t(text), t([12]), t(psp), t([30]))
            T = emb.shape[1]
            h, _ = lm.forward_hidden(emb, torch.arange(T, device=dev)[None],
                                     causal_prefill_bias(T, T, seq_len, 1, emb.dtype, dev))
            toks, cnt = lm_generate(lm, t(text), t([12]), t(psp[:, :6]), t([6]), t([40]),
                                    t([40]), None, 40, 128)
            got[dev] = (lm.decode_logits(h).cpu(), toks[0, :int(cnt[0])].cpu())
        (lg, tg), (lc, tc) = got["cuda"], got["cpu"]
        out[name] = dict(logits_max_abs_err=float((lg - lc).abs().max()),
                         logits_close=bool(torch.allclose(lg, lc, atol=2e-5, rtol=2e-5)),
                         tokens=len(tg), tokens_equal=bool(torch.equal(tg, tc)))
    return out


def int4xla_run(fp, awq: bool, K1, K5, tf_argmax, want) -> dict:
    """The main path's bf16 LM (fp) quantized to int4xla, with AWQ
    calibrated by collect_act_stats on one seeded request or without:
    INT4XLA_TOKENS greedy decode steps (EOS masked throughout; an id past
    EOS is a step that emits no token) after a short warm-up, ms a step, K1
    launches, peak memory, and the teacher-forced argmax agreement with the
    bf16 LM (tf_argmax over the int4 request's tokens, want its bf16
    result)."""
    from cosyvoice_tpu_torch.models.llm import (collect_act_stats, lm_decode_chunk,
                                                lm_generate, lm_prefill_stream)

    t0 = time.perf_counter()
    stats = None
    if awq:
        stats = collect_act_stats(fp, *int4xla_calibration(
            "cuda", fp.cfg.qwen.vocab_size, fp.cfg.speech_token_size, 63))
    torch.cuda.reset_peak_memory_stats()
    lm = int4xla_lm(fp, stats, "cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(64)
    t = lambda x: torch.as_tensor(np.asarray(x), device="cuda")
    args = (t(rng.integers(0, fp.cfg.qwen.vocab_size, (1, 20))), t([20]),
            t(rng.integers(0, fp.cfg.speech_token_size, (1, 75))), t([75]))
    n = INT4XLA_TOKENS
    lm_generate(lm, *args, t([5]), t([5]), None, 5, 256)
    K1.launches = K5.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = lm_decode_chunk(lm, lm_prefill_stream(lm, *args, t([n]), t([n]), None, n, 384),
                            n).gen
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    agree = float((tf_argmax(lm) == want).float().mean())
    proj = dev_time(projection_step(lm))
    res = dict(awq=awq, group=INT4XLA_GROUP, setup_s=setup_s, steps=state.step,
               projections_step_dev=proj,
               tokens=int(state.count[0]), ms_per_step=decode_s * 1e3 / max(state.step, 1),
               k1_launches=K1.launches,
               k1_launches_expected=fp.cfg.qwen.num_layers * (state.step - 1),
               k5_launches=K5.launches, peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               teacher_forced_agreement_vs_bf16=agree)
    del lm
    torch.cuda.empty_cache()
    return res


def dit_blocks(flow) -> list:
    from cosyvoice_tpu_torch.models.flow import DiTBlock

    return [m for m in flow.modules() if isinstance(m, DiTBlock)]


def set_fused_block(flow, on: bool) -> None:
    """Route every DiT block of `flow` through K4 (on) or through K2, K3 and
    cuBLAS (off), the same weights either way."""
    for blk in dit_blocks(flow):
        blk.fused_block = on


@torch.no_grad()
def batched_phase(res_main: dict, K1, K4, smi: str) -> dict:
    """BatchedSynthesizer over 8 zero-shot requests at full width with the
    main path's weights and prompt, every DiT block through K4: a warm-up
    batch, then a timed one; then the same flow inputs through the unfused
    blocks, for the mel difference K4 makes."""
    from cosyvoice_tpu_torch.runtime.model import CosyVoice2Model
    from cosyvoice_tpu_torch.runtime.serving import BatchedSynthesizer, TTSRequest

    llm, flow, hift, frontend = res_main["stack"]
    synth = BatchedSynthesizer(CosyVoice2Model(llm=llm, flow=flow, hift=hift,
                                               max_decode_tokens=200, device="cuda"))
    reqs = []
    for text in BATCH_TEXTS:
        mi = frontend.frontend_zero_shot(text, "A short prompt.", res_main["prompt_wav"])
        reqs.append(TTSRequest(
            text_tokens=np.concatenate([mi["prompt_text"], mi["text"]]),
            prompt_text_len=len(mi["prompt_text"]),
            prompt_speech_tokens=mi["llm_prompt_speech_token"],
            prompt_feat=mi["prompt_speech_feat"], embedding=mi["flow_embedding"]))
    stage, seen = {"lm_s": 0.0, "flow_s": 0.0, "hift_s": 0.0}, {}

    def timed_seen(key, fn):
        def run(*args):
            seen[key] = (args, fn(*args))
            return seen[key][1]
        return timed(stage, key, run)

    flow_batch = synth.flow_batch
    synth.generate = timed_seen("lm_s", synth.generate)
    synth.flow_batch = timed_seen("flow_s", flow_batch)
    synth.vocode_batch = timed_seen("hift_s", synth.vocode_batch)
    set_fused_block(flow, True)
    synth.synthesize_batch(reqs, gen=torch.Generator().manual_seed(0))      # warm-up
    for key in stage:
        stage[key] = 0.0
    K1.launches = K4.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wavs = synth.synthesize_batch(reqs, gen=torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k4, k1 = K4.launches, K1.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    tokens = seen["lm_s"][1]
    mel_on, tls, pfl = seen["flow_s"][1]
    set_fused_block(flow, False)
    mel_off = flow_batch(reqs, tokens)[0]
    diff = max(float((mel_on[i, p:2 * n] - mel_off[i, p:2 * n]).abs().max())
               for i, (n, p) in enumerate(zip(tls, pfl)))
    n_blocks = len(dit_blocks(flow))
    audio_s = sum(len(w) for w in wavs) / 24000.0
    # the flow's CFG batch: 2B rows, mel frames padded to 128, per-row lengths
    T_pad = -(-mel_on.shape[1] // 128) * 128
    lens = [2 * n for n in tls] * 2
    res = {"phase": "batched", "card": smi, "requests": len(reqs),
           "speech_tokens": [len(t) for t in tokens], "wall_s": wall, **stage,
           "audio_s": audio_s, "rtf": wall / max(audio_s, 1e-9), "peak_mem_gb": peak,
           "k4_launches": k4, "k4_launches_expected": n_blocks * 10, "k1_launches": k1,
           "flow_cfg_rows": 2 * len(reqs), "flow_frames_padded": T_pad,
           "mel_max_abs_diff_fused_block_on_vs_off": diff,
           "mel_max_abs": float(mel_off.abs().max())}
    emit(res)
    ok = all(np.isfinite(w).all() and w.shape == (len(t) * 2 * 480,)
             for w, t in zip(wavs, tokens))
    if k4 != n_blocks * 10 or not ok or not np.isfinite(diff) or not k1:
        raise AssertionError(f"batched phase failed: {res}")
    res["block_shape"] = (2 * len(reqs), T_pad, lens)
    return res


@torch.no_grad()
def engine_phase(res_main: dict, K1, smi: str) -> dict:
    """ServingEngine.generate, 16 requests of mixed lengths through 8 slots, on
    the small fp32 stack (greedy tokens must equal a B=1 lm_generate of each
    request) and on the main path's int8 LM with greedy sampling."""
    from cosyvoice_tpu_torch.models.llm import Qwen2LM, SamplingConfig, lm_generate
    from cosyvoice_tpu_torch.runtime.engine import GenRequest, ServingEngine

    rng = np.random.default_rng(11)

    def run(lm, reqs, compare: int = 16, **kw) -> dict:
        """The engine over reqs; the first `compare` requests' tokens
        against a B=1 lm_generate each."""
        segments = [0]
        K1.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = ServingEngine(lm, device="cuda", **kw).generate(
            reqs, on_segment=lambda: segments.__setitem__(0, segments[0] + 1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1 = K1.launches
        t = lambda *a: torch.as_tensor(np.asarray(a), dtype=torch.long, device="cuda")
        equal, first_diff = 0, []
        for r, toks in zip(reqs[:compare], got):
            n, mo = len(r.text), kw["max_out"]
            mn = r.min_len if r.min_len is not None else int(2 * n)
            mx = min(r.max_len if r.max_len is not None else 20 * n, mo)
            out, cnt = lm_generate(lm, t(r.text), t(n), t(r.prompt_speech),
                                   t(len(r.prompt_speech)), t(mn), t(mx), None, max_steps=mo,
                                   cache_len=kw["cache_len"])
            ref = out[0, :int(cnt[0])].cpu().numpy()
            equal += int(np.array_equal(toks, ref))
            # tokens before the first difference (the whole length if none)
            diff = np.nonzero(toks[:len(ref)] != ref[:len(toks)])[0]
            first_diff.append(int(diff[0]) if len(diff) else min(len(toks), len(ref)))
        n_tok = sum(len(g) for g in got)
        return dict(requests=len(reqs), slots=kw["num_slots"], tokens=n_tok, wall_s=wall,
                    tokens_per_s=n_tok / wall, segments=segments[0], k1_launches=k1,
                    equal_to_lm_generate=equal, compared=compare,
                    share_equal=equal / compare,
                    tokens_before_first_difference=first_diff,
                    request_tokens=[len(g) for g in got])

    small = small_stack("cuda").llm
    small_reqs = [GenRequest(text=rng.integers(0, 256, 2 + i % 11),
                             prompt_speech=rng.integers(0, 64, (i * 7) % 26))
                  for i in range(16)]
    small_run = run(small, small_reqs, num_slots=8, cache_len=256, max_out=96,
                    segment_steps=16, text_bucket=8, speech_bucket=8)
    llm = res_main["stack"][0]
    cfg = dataclasses.replace(llm.cfg, sampling=SamplingConfig(method="greedy"))
    with torch.device("cuda"):
        lm = Qwen2LM(cfg)
    lm.load_state_dict(llm.state_dict(), strict=True, assign=True)
    # decode caps of 50-100 tokens (cut from 100-200 for the script's
    # time); the longest request needs 3 + 32 text + 128 speech +
    # 200 cache rows <= 384
    full_reqs = [GenRequest(text=rng.integers(0, 256, 6 + (i * 5) % 25),
                            prompt_speech=rng.integers(0, 6561, 20 + (i * 11) % 56),
                            max_len=50 + (i * 13) % 51)
                 for i in range(16)]
    # 8 of the 16 against B=1 (cut from all 16 for the script's time)
    full_run = run(lm, full_reqs, compare=8, num_slots=8, cache_len=384, max_out=200,
                   segment_steps=50, text_bucket=32, speech_bucket=64)
    res = {"phase": "engine", "card": smi, "small_fp32": small_run, "full_width_int8": full_run,
           "gate": "small_fp32 share_equal == 1 (exact greedy parity); full width: printed"}
    emit(res)
    if small_run["share_equal"] != 1.0 or not full_run["tokens"] or not full_run["k1_launches"]:
        raise AssertionError(f"engine phase failed: {res}")
    return res


@torch.no_grad()
def bigvgan_phase(K7, smi: str) -> dict:
    """BigVGAN at the recipe's full width on seeded random weights, every
    AAAct through K7: a warm-up forward and a timed one over 4 rows of
    250/200/150/100 tokens, the timed one counting K7's launches by stage
    shape and the memory layout each AAAct hands K7 (forward hooks); then
    the device time of K7 and of the copy kernels (torch.profiler), and the
    same input through the composite activations (warm-up, timed): the wall
    time and the wav difference."""
    from cosyvoice_tpu_torch.models.bigvgan import RECIPE, AAAct, BigVGAN

    cfg = dataclasses.replace(RECIPE, use_pallas_act=True)
    with torch.device("cuda"):
        model = BigVGAN(cfg)
    rand_init_(model, 12348)
    model.eval()
    lens = [250, 200, 150, 100]
    T = max(lens)
    g = torch.Generator(device="cuda").manual_seed(13)
    tlen = torch.tensor(lens, device="cuda")
    valid = torch.arange(T, device="cuda")[None] < tlen[:, None]
    token = torch.where(valid, torch.randint(0, cfg.vocab_size, (4, T), generator=g,
                                             device="cuda"), -1)
    spk = torch.randn(4, cfg.speaker_embedding_dim, generator=g, device="cuda")
    upsample = math.prod(cfg.upsample_rates) * 2 ** 2      # 2x per conformer encoder
    acts = [m for m in model.modules() if isinstance(m, AAAct)]

    def forward():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wav, mel = model(token, tlen, spk)
        torch.cuda.synchronize()
        return wav, mel, time.perf_counter() - t0

    # K7 launches by stage shape (T, C) and the layouts AAAct hands K7
    by_stage, layouts, before = {}, [], []

    def pre(module, args):
        layouts.append(K7.memory_layout(args[0]))
        before.append(K7.launches)

    def post(module, args, out):
        key = "x".join(map(str, args[0].shape[1:]))
        by_stage[key] = by_stage.get(key, 0) + K7.launches - before.pop()

    forward()                                               # warm-up
    hooks = [h for m in acts for h in (m.register_forward_pre_hook(pre),
                                       m.register_forward_hook(post))]
    K7.launches = 0
    torch.cuda.reset_peak_memory_stats()
    wav, mel, wall = forward()
    k7 = K7.launches
    for h in hooks:
        h.remove()
    peak = torch.cuda.max_memory_allocated() / 2**30
    kernels = kernel_times(lambda: model(token, tlen, spk), n=1)
    device_ms = sum(ms for ms, _ in kernels.values())
    k7_ms = sum(ms for name, (ms, _) in kernels.items()
                if kernel_key(name).startswith("snake_aa"))
    copies = {name: v for name, v in kernels.items() if "copy" in name.lower()}
    for m in acts:
        m.use_kernel = False
    forward()
    wav_off, _, wall_off = forward()
    for m in acts:
        m.use_kernel = True
    expected = len(cfg.upsample_rates) * sum(2 * len(d) for d in cfg.resblock_dilation_sizes) + 1
    audio_s = sum(lens) * upsample / 24000.0
    finite = bool(torch.isfinite(wav).all())
    res = {"phase": "bigvgan", "card": smi, "config": "cosyvoice2_bigvgan_tts.yaml",
           "rows_tokens": lens, "wav_shape": list(wav.shape), "mel_shape": list(mel.shape),
           "wall_s": wall, "audio_s": audio_s, "rtf": wall / audio_s, "peak_mem_gb": peak,
           "k7_launches": k7, "k7_launches_expected": expected,
           "k7_launches_by_stage": by_stage,
           "k7_input_layouts": {lay: layouts.count(lay) for lay in sorted(set(layouts))},
           "k7_device_ms": k7_ms, "device_ms": device_ms, "k7_device_share": k7_ms / device_ms,
           # every copy kernel of the forward (the convolutions' F.pad among
           # them): device ms and launches a forward, by kernel name
           "copy_device_ms": sum(ms for ms, _ in copies.values()),
           "copy_launches": sum(n for _, n in copies.values()),
           "copy_kernels": {name[:160]: v for name, v in copies.items()},
           "wav_finite": finite, "wav_max_abs": float(wav.abs().max()),
           "composite_wall_s": wall_off,
           "wav_max_abs_diff_kernel_vs_composite": float((wav - wav_off).abs().max())}
    emit(res)
    if (k7 != expected or len(acts) != expected or not finite or res["wav_max_abs"] > 1.0
            or tuple(wav.shape) != (4, T * upsample) or (k7 and not k7_ms)
            or sum(by_stage.values()) != k7):
        raise AssertionError(f"bigvgan phase failed: {res}")
    return res


@torch.no_grad()
def stream_phase(res_main: dict, K1, K2, K3, smi: str) -> dict:
    """One full-width zero-shot request streamed through
    inference_zero_shot(stream=True): the main path's weights with greedy
    sampling, a STREAM_CAP-token cap, after one warm-up stream of the same
    request.
    Each chunk's seconds split into frontend, LM prefill, flow and HiFT
    (synchronised host timers) and the rest: decode steps and host work."""
    from cosyvoice_tpu_torch.models.llm import Qwen2LM, SamplingConfig
    from cosyvoice_tpu_torch.runtime.api import CosyVoice2
    from cosyvoice_tpu_torch.runtime.model import CosyVoice2Model

    llm, flow, hift, frontend = res_main["stack"]
    cfg = dataclasses.replace(llm.cfg, sampling=SamplingConfig(method="greedy"))
    with torch.device("cuda"):
        lm = Qwen2LM(cfg)
    lm.load_state_dict(llm.state_dict(), strict=True, assign=True)
    model = CosyVoice2Model(llm=lm.eval(), flow=flow, hift=hift, max_decode_tokens=STREAM_CAP,
                            device="cuda")
    cv = CosyVoice2(frontend=frontend, model=model)
    prefills, streamed = [], []
    prefill, token2wav = model._prefill, model.token2wav

    def recording_prefill(*args):
        prefills.append(args[:3])
        return prefill(*args)

    def recording_token2wav(tokens, *args, **kwargs):
        streamed.append(tokens[:kwargs.get("n_tokens")].cpu().numpy())
        return token2wav(tokens, *args, **kwargs)

    stage = dict.fromkeys(("frontend_s", "prefill_s", "flow_s", "hift_s"), 0.0)
    model.token2wav = recording_token2wav
    model._prefill = timed(stage, "prefill_s", recording_prefill)
    model._flow_chunk = timed(stage, "flow_s", model._flow_chunk)
    model._vocode = timed(stage, "hift_s", model._vocode)
    frontend.frontend_zero_shot = timed(stage, "frontend_s", frontend.frontend_zero_shot)

    def stream():
        torch.cuda.synchronize()
        t0 = last = time.perf_counter()
        chunk_s, lens, splits = [], [], []
        stage.update(dict.fromkeys(stage, 0.0))
        for out in cv.inference_zero_shot(res_main["first_text"], "A short prompt.",
                                          res_main["prompt_wav"], stream=True):
            torch.cuda.synchronize()
            now = time.perf_counter()
            chunk_s.append(now - last)
            lens.append(len(out["tts_speech"]))
            splits.append(dict(stage, decode_and_host_s=now - last - sum(stage.values())))
            stage.update(dict.fromkeys(stage, 0.0))
            last = now
        return chunk_s, lens, splits, last - t0

    stream()                                                # warm-up
    for mod in (K1, K2, K3):
        mod.launches = 0
    streamed.clear()
    chunk_s, lens, splits, wall = stream()
    del frontend.frontend_zero_shot                         # the shared frontend's own method
    launches = {"lm_decode_attention": K1.launches, "dit_attention": K2.launches,
                "fused_layer_norm": K3.launches}
    tokens = streamed[-1]
    ref = model.llm_generate(*prefills[-1], None)
    hop, la, cache, hs = model.token_hop_len, model.pre_lookahead_len, model.mel_cache_len, \
        model.hop_samples
    k, n = len(lens) - 1, len(tokens)
    want = ([(2 * (hop + la) - cache) * hs] * min(k, 1) + [2 * (hop + la) * hs] * max(k - 1, 0)
            + [((cache if k else 0) + 2 * (n - hop * k)) * hs])
    audio_s = sum(lens) / 24000.0
    res = {"phase": "stream", "card": smi, "speech_tokens": n,
           "nonstream_greedy_tokens": len(ref), "tokens_equal": bool(np.array_equal(tokens, ref)),
           "chunks": len(lens), "chunk_samples": lens, "chunk_samples_expected": want,
           "first_chunk_latency_s": chunk_s[0], "chunk_s": chunk_s, "chunk_split_s": splits,
           "wall_s": wall,
           "audio_s": audio_s, "rtf": wall / max(audio_s, 1e-9), "launches": launches}
    emit(res)
    if lens != want or n != len(ref) or not res["tokens_equal"] or not all(launches.values()):
        raise AssertionError(f"stream phase failed: {res}")
    return res


class EngineRecord:
    """Within the block, runtime/serving.py's ContinuousSynthesizer runs a
    ServingEngine that records the tokens each request streams (in admission
    order, which is submission order), counts its segments and stamps the
    host clock at the end of each (before its flush)."""

    def __enter__(self):
        from cosyvoice_tpu_torch.runtime import serving

        rec, base = self, serving.ServingEngine
        self.tokens, self.segments, self.segment_end, self._base = [], 0, [], base

        class Recording(base):
            def serve(self, submissions, gen=None, on_segment=None):
                class Sub:
                    @staticmethod
                    def get(block=True):
                        item = submissions.get(block=block)
                        if item is None:
                            return None
                        req, cb = item
                        toks: list = []
                        rec.tokens.append(toks)
                        return req, lambda new, fin: (toks.extend(new.tolist()), cb(new, fin))

                def segment():
                    rec.segments += 1
                    rec.segment_end.append(time.perf_counter())
                    on_segment()
                return base.serve(self, Sub(), gen=gen, on_segment=segment)

        serving.ServingEngine = Recording
        return self

    def __exit__(self, *exc):
        from cosyvoice_tpu_torch.runtime import serving

        serving.ServingEngine = self._base


def biased_small_stack(device: str, stream: bool = False):
    """small_stack with its LM head biased away from EOS and the ids it does
    not emit, so that every request decodes to the 160-token cap: three
    streamed chunks and a final one a request at hop 50."""
    model = small_stack(device, max_decode_tokens=160, stream=stream)
    with torch.no_grad():
        model.llm.llm_decoder.bias[model.llm.cfg.speech_token_size:] = -30.0
    return model


def small_continuous_checks() -> dict:
    """ContinuousSynthesizer on the card over the small fp32 stack, 4 greedy
    requests through 2 slots: windowed (batch_chunks on and off) against the
    same stack's sequential tts(stream=True) on the CPU (tokens exact, every
    chunk within CONT_WAV_TOL), and incremental on the stream family against
    its one-shot stream-masked flow (chunk_anchor) on the card, vocoded with
    the same windows (INC_WAV_TOL)."""
    from cosyvoice_tpu_torch.runtime.serving import ContinuousSynthesizer, TTSRequest

    rng = np.random.default_rng(21)
    reqs = [TTSRequest(text_tokens=rng.integers(0, 256, n), prompt_text_len=0,
                       prompt_speech_tokens=rng.integers(0, 64, p),
                       prompt_feat=(rng.standard_normal((2 * p, 80)) * 0.3).astype(np.float32),
                       embedding=rng.standard_normal(24).astype(np.float32))
            for n, p in ((9, 25), (12, 10), (8, 18), (10, 30))]
    kw = dict(num_slots=2, cache_len=256, text_bucket=16, speech_bucket=32)
    cpu = biased_small_stack("cpu")
    want = [(cpu.llm_generate(r.text_tokens, 0, r.prompt_speech_tokens, None),
             [o["tts_speech"] for o in cpu.tts(r.text_tokens, 0, r.prompt_speech_tokens,
                                                r.prompt_speech_tokens, r.prompt_feat,
                                                r.embedding, stream=True)])
            for r in reqs]
    gpu = biased_small_stack("cuda")
    out = {}
    for batch_chunks in (True, False):
        got = [[] for _ in reqs]
        with EngineRecord() as rec:
            ContinuousSynthesizer(gpu, batch_chunks=batch_chunks, **kw).synthesize_batch(
                reqs, on_chunk=lambda i, wav, fin: got[i].append(wav))
        shapes = [[len(c) for c in g] for g in got]
        same_shapes = shapes == [[len(c) for c in w[1]] for w in want]
        out[f"windowed_batch_chunks_{batch_chunks}"] = dict(
            tokens=[len(t) for t in rec.tokens],
            tokens_equal=all(np.array_equal(t, w[0]) for t, w in zip(rec.tokens, want)),
            chunk_samples=shapes, chunk_samples_equal=same_shapes,
            max_abs_err=max(float(np.abs(a - b).max()) for g, w in zip(got, want)
                            for a, b in zip(g, w[1])) if same_shapes else float("inf"),
            tol=CONT_WAV_TOL)
    stream = biased_small_stack("cuda", stream=True)
    with EngineRecord() as rec:
        got = ContinuousSynthesizer(stream, incremental=True, **kw).synthesize_batch(reqs)
    hop, la = stream.token_hop_len, stream.pre_lookahead_len
    errs = []
    for r, toks, wav in zip(reqs, rec.tokens, got):
        toks = np.asarray(toks)
        seq = np.concatenate([r.prompt_speech_tokens, toks])
        mel = stream.flow.inference(
            torch.as_tensor(seq[None], device="cuda"), torch.tensor([len(seq)], device="cuda"),
            torch.as_tensor(r.prompt_feat[None], device="cuda"),
            torch.as_tensor(r.embedding[None], device="cuda"), streaming=True,
            chunk_anchor=torch.tensor([len(r.prompt_speech_tokens)], device="cuda"))
        session, parts, off = stream.new_session(), [], 0
        while len(toks) - off >= hop + la:
            parts += stream.mel2wav_stream_group(mel, [0], [2 * off], [session],
                                                 win_rows=2 * hop)
            off += hop
        parts += stream.mel2wav_final_group(mel, [0], [2 * off], [mel.shape[1] - 2 * off],
                                            [session])
        ref = np.concatenate(parts)
        errs.append(float(np.abs(wav - ref).max()) if wav.shape == ref.shape else float("inf"))
    out["incremental"] = dict(tokens=[len(t) for t in rec.tokens], max_abs_err=max(errs),
                              tol=INC_WAV_TOL)
    return out


def continuous_full(model, reqs, K1, K2, K3, incremental: bool) -> dict:
    """One run of ContinuousSynthesizer at full width over `reqs` (all
    submitted at once): first-chunk latency a stream (submission to its first
    on_chunk) and the segments before it, wall, audio, RTF, chunks,
    segments, K1-K3 launches, peak memory."""
    from cosyvoice_tpu_torch.runtime.serving import ContinuousSynthesizer

    synth = ContinuousSynthesizer(model, num_slots=len(reqs), cache_len=768,
                                  max_out=CONT_TOKENS, hop_scale=2.0, incremental=incremental)
    first, first_segment, lens = {}, {}, [[] for _ in reqs]
    for mod in (K1, K2, K3):
        mod.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with EngineRecord() as rec:
        t0 = time.perf_counter()

        def on_chunk(i, wav, fin):
            first.setdefault(i, time.perf_counter() - t0)
            first_segment.setdefault(i, rec.segments)
            lens[i].append(len(wav))

        wavs = synth.synthesize_batch(reqs, gen=torch.Generator().manual_seed(0),
                                      on_chunk=on_chunk)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    audio_s = sum(len(w) for w in wavs) / 24000.0
    lat = [first[i] for i in range(len(reqs))]
    return dict(streams=len(reqs), tokens=[len(t) for t in rec.tokens],
                first_chunk_s=lat, first_chunk_median_s=float(np.median(lat)),
                first_chunk_max_s=max(lat),
                # the first segment's end: what the first chunk waits for
                # before its flush (flow and vocoder)
                first_segment_end_s=rec.segment_end[0] - t0,
                segments_before_first_chunk=[first_segment[i] for i in range(len(reqs))],
                wall_s=wall, audio_s=audio_s, rtf=wall / max(audio_s, 1e-9),
                chunks=sum(len(x) for x in lens), chunk_samples=lens[0], segments=rec.segments,
                launches={"lm_decode_attention": K1.launches, "dit_attention": K2.launches,
                          "fused_layer_norm": K3.launches},
                peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
                finite=all(np.isfinite(w).all() and len(w) > 0 for w in wavs))


@torch.no_grad()
def continuous_phase(res_main: dict, b1_first_chunk_s: float, K1, K2, K3, smi: str) -> dict:
    """The small-stack gates (small_continuous_checks), then at full width the
    main path's weights under bench.py's engine traffic: CONT_STREAMS streams
    through as many slots, CONT_TOKENS tokens a stream, hop_scale 2.0, once
    windowed (flow_context_tokens 250) and once incremental (the stream
    family: left_chunks 2, static_chunk_size 50)."""
    from cosyvoice_tpu_torch.models.flow import CausalMaskedDiffWithXvec
    from cosyvoice_tpu_torch.models.llm import Qwen2LM
    from cosyvoice_tpu_torch.runtime.model import CosyVoice2Model
    from cosyvoice_tpu_torch.runtime.serving import TTSRequest

    small = small_continuous_checks()
    llm, flow, hift, frontend = res_main["stack"]
    ratio = CONT_TOKENS / len(CONT_TEXT)       # min = max = CONT_TOKENS tokens
    with torch.device("cuda"):
        lm = Qwen2LM(dataclasses.replace(llm.cfg, min_token_text_ratio=ratio,
                                         max_token_text_ratio=ratio))
        iflow = CausalMaskedDiffWithXvec(dataclasses.replace(
            flow.cfg, estimator=dataclasses.replace(flow.cfg.estimator, stream=True,
                                                    left_chunks=2, static_chunk_size=50)))
    lm.load_state_dict(llm.state_dict(), strict=True, assign=True)
    iflow.load_state_dict(flow.state_dict(), strict=True, assign=True)
    mi = frontend.frontend_zero_shot(CONT_TEXT, "A short prompt.", res_main["prompt_wav"])
    req = TTSRequest(text_tokens=np.concatenate([mi["prompt_text"], mi["text"]]),
                     prompt_text_len=len(mi["prompt_text"]),
                     prompt_speech_tokens=mi["flow_prompt_speech_token"],
                     prompt_feat=mi["prompt_speech_feat"], embedding=mi["flow_embedding"])
    reqs = [req] * CONT_STREAMS
    model = lambda f, **kw: CosyVoice2Model(llm=lm.eval(), flow=f, hift=hift,
                                            max_decode_tokens=CONT_TOKENS, device="cuda", **kw)
    windowed = continuous_full(model(flow, flow_context_tokens=250), reqs, K1, K2, K3, False)
    incremental = continuous_full(model(iflow.eval()), reqs, K1, K2, K3, True)
    res = {"phase": "continuous", "card": smi, "small_fp32": small,
           "traffic": {"streams": CONT_STREAMS, "slots": CONT_STREAMS,
                       "tokens_a_stream": CONT_TOKENS, "hop_scale": 2.0,
                       "prompt_speech_tokens": len(req.prompt_speech_tokens)},
           "windowed": windowed, "incremental": incremental,
           "b1_stream_first_chunk_s": b1_first_chunk_s}
    emit(res)
    gates = [g["tokens_equal"] and g["chunk_samples_equal"] and g["max_abs_err"] <= g["tol"]
             for k, g in small.items() if k.startswith("windowed")]
    gates.append(small["incremental"]["max_abs_err"] <= small["incremental"]["tol"])
    gates += [windowed["finite"], incremental["finite"],
              all(windowed["launches"].values()),
              incremental["launches"]["lm_decode_attention"] > 0,
              incremental["launches"]["fused_layer_norm"] > 0]
    if not all(gates):
        raise AssertionError(f"continuous phase failed: {res}")
    return res


def _post(port: int, path: str, body: dict, stream: bool) -> dict:
    """POST a JSON body; -> status, the whole body, and for a stream the
    seconds to its first data chunk (after the 44-byte WAV header)."""
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    c.request("POST", path, json.dumps(dict(body, stream=stream)),
              {"Content-Type": "application/json"})
    r = c.getresponse()
    first_s = None
    if stream and r.status == 200:
        head = r.read(44)
        data = r.read(2)
        first_s = time.perf_counter() - t0
        data = head + data + r.read()
    else:
        data = r.read()
    return {"status": r.status, "data": data, "first_data_s": first_s,
            "total_s": time.perf_counter() - t0}


def _wav_ok(resp: dict, sample_rate: int) -> bool:
    """A 200 with a well-formed 16-bit mono RIFF/WAV at `sample_rate` and a
    non-empty PCM payload."""
    import struct

    d = resp["data"]
    return (resp["status"] == 200 and len(d) > 44 and d[:4] == b"RIFF" and d[8:12] == b"WAVE"
            and d[36:40] == b"data" and struct.unpack("<I", d[24:28])[0] == sample_rate
            and struct.unpack("<H", d[34:36])[0] == 16 and (len(d) - 44) % 2 == 0)


def _served(cv, worker=None):
    """The port's HTTP server over cv (continuous) on a free local port, in a
    thread; its worker records every Exception it hands the handler."""
    import threading

    from cosyvoice_tpu_torch.bin.serve import serve

    httpd = serve(cv, host="127.0.0.1", port=0, continuous=True, worker=worker)
    errors, submit = [], httpd.worker.submit

    class Watched:
        def __init__(self, q):
            self.q = q

        def get(self):
            piece = self.q.get()
            if isinstance(piece, Exception):
                errors.append(repr(piece))
            return piece

    httpd.worker.submit = lambda mode, body: Watched(submit(mode, body))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, errors


def _concurrently(calls: list) -> list:
    import threading

    out = [None] * len(calls)

    def run(i):
        out[i] = calls[i]()
    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(calls))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def serve_phase(res_main: dict, smi: str) -> dict:
    """The port's HTTP server (continuous) over the full-width CosyVoice2 on
    the main path's weights: GET /health, 4 concurrent streaming zero-shot
    requests, then one request each to sft (a speaker registered here),
    cross-lingual, instruct2 and vc, all at once.  Then the same server over
    the small fp32 stack with the sequential flush (batch_chunks off, so a
    chunk does not depend on which streams share its flush) and cuDNN's
    deterministic convolutions (its default ones give the same call
    different last bits from run to run): its PCM must equal pcm16 of a
    direct ContinuousSynthesizer run of the same requests."""
    import base64
    import http.client

    from cosyvoice_tpu_torch.bin.serve import ContinuousWorker, pcm16, tts_requests
    from cosyvoice_tpu_torch.runtime.api import CosyVoice2
    from cosyvoice_tpu_torch.runtime.frontend import CosyVoiceFrontEnd
    from cosyvoice_tpu_torch.runtime.model import CosyVoice2Model
    from cosyvoice_tpu_torch.runtime.serving import ContinuousSynthesizer
    from cosyvoice_tpu_torch.tokenizer.text import ByteTokenizer

    llm, flow, hift, frontend = res_main["stack"]
    rng = np.random.default_rng(31)
    frontend.spk2info = {"speaker": {"embedding": rng.standard_normal(192).astype(np.float32)}}
    # a 100-token cap a request (cut from 200 to keep the script inside its time)
    cv = CosyVoice2(frontend=frontend, model=CosyVoice2Model(
        llm=llm, flow=flow, hift=hift, max_decode_tokens=100, device="cuda"))
    prompt = {"prompt_wav_b64": base64.b64encode(
        res_main["prompt_wav"].astype("<f4").tobytes()).decode()}
    source = (0.3 * np.sin(2 * np.pi * 180 * np.arange(32000) / 16000.0)).astype("<f4")
    httpd, errors = _served(cv)
    port = httpd.server_address[1]
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    c.request("GET", "/health")
    r = c.getresponse()
    health = {"status": r.status, "body": json.loads(r.read())}
    texts = ["Hello there.", "The quick brown fox jumps over the lazy dog.",
             "Streams share the slot engine.", "One more request, please."]
    streams = _concurrently([
        lambda t=t: _post(port, "/tts/zero_shot", dict(prompt, text=t, prompt_text="A short "
                                                       "prompt."), stream=True)
        for t in texts])
    modes = {"sft": {"text": "Good morning.", "spk_id": "speaker"},
             "cross_lingual": dict(prompt, text="Good morning."),
             "instruct2": dict(prompt, text="Good morning.", instruct_text="Speak slowly."),
             "vc": dict(prompt, source_wav_b64=base64.b64encode(source.tobytes()).decode())}
    others = dict(zip(modes, _concurrently([
        lambda m=m, b=b: _post(port, f"/tts/{m}", b, stream=False) for m, b in modes.items()])))
    httpd.shutdown()
    httpd.worker.close()

    def seeded(wav):
        return np.random.default_rng(int(np.abs(wav).sum() * 1e3) % (1 << 32))

    small = CosyVoice2(frontend=CosyVoiceFrontEnd(
        tokenizer=ByteTokenizer(),
        speech_tokenizer=lambda wav: seeded(wav).integers(0, 64, len(wav) * 25 // 16000),
        spk_embedder=lambda wav: seeded(wav).standard_normal(24).astype(np.float32)),
        model=biased_small_stack("cuda"))
    torch.backends.cudnn.deterministic = True
    worker = ContinuousWorker(small, num_slots=2, batch_chunks=False)
    httpd, small_errors = _served(small, worker=worker)
    port = httpd.server_address[1]
    small_texts = ["Hello there, my friend.", "A second request.", "And a third one."]
    body = dict(prompt, prompt_text="A short prompt.")
    small_resp = _concurrently([
        lambda i=i: _post(port, "/tts/zero_shot", dict(body, text=small_texts[i]),
                          stream=i > 0) for i in range(3)])
    httpd.shutdown()
    worker.close()
    reqs = [r for t in small_texts for r in tts_requests(small, "zero_shot", dict(body, text=t))]
    direct = ContinuousSynthesizer(small.model, num_slots=2,
                                   batch_chunks=False).synthesize_batch(reqs)
    torch.backends.cudnn.deterministic = False
    pcm_equal = [len(reqs) == 3 and resp["data"][44:] == pcm16(w)
                 for resp, w in zip(small_resp, direct)]
    summary = lambda resp: {"status": resp["status"], "bytes": len(resp["data"]),
                            "wav_ok": _wav_ok(resp, cv.sample_rate),
                            "first_data_s": resp["first_data_s"], "total_s": resp["total_s"]}
    res = {"phase": "serve", "card": smi, "health": health,
           "streams": [summary(x) for x in streams],
           "modes": {m: summary(x) for m, x in others.items()},
           "worker_errors": errors + small_errors,
           "small_fp32": {"requests": len(small_resp),
                          "wav_ok": [_wav_ok(x, small.sample_rate) for x in small_resp],
                          "pcm_equal_direct": pcm_equal}}
    emit(res)
    ok = (health == {"status": 200, "body": {"status": "ok"}} and not res["worker_errors"]
          and all(x["wav_ok"] for x in res["streams"] + list(res["modes"].values()))
          and all(x["first_data_s"] is not None for x in res["streams"])
          and all(res["small_fp32"]["wav_ok"]) and all(pcm_equal))
    if not ok:
        raise AssertionError(f"serve phase failed: {res}")
    return res


# ---- checkpoint: a released-format model directory -------------------------

# the merges of the hand-built byte-level tokenizer (GPT-2 byte alphabet,
# "Ġ" is a space): enough to merge a few common English pieces
# the full-width requests from assembled directories (checkpoint, deploy,
# pho_train): cut from 200 for the script's time
CKPT_CAP = 100
CKPT_MERGES = (("Ġ", "t"), ("h", "e"), ("Ġt", "he"), ("i", "n"), ("e", "r"), ("Ġ", "a"),
               ("o", "n"), ("r", "e"), ("Ġ", "s"), ("e", "n"), ("Ġ", "p"), ("o", "r"))


def write_tokenizer_json(path: str) -> None:
    """A byte-level BPE tokenizer.json in the GPT-2 form (ByteLevel with its
    regex): the 256 byte symbols, CKPT_MERGES and <|endoftext|>; and the
    tokenizer_config.json that lets `transformers` load the directory."""
    import os

    from cosyvoice_tpu_torch.tokenizer.text import bytes_to_unicode

    vocab = {c: b for b, c in bytes_to_unicode().items()}
    for a, b in CKPT_MERGES:
        vocab[a + b] = len(vocab)
    byte_level = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
                  "use_regex": True}
    spec = {"version": "1.0", "truncation": None, "padding": None,
            "added_tokens": [{"id": len(vocab), "content": "<|endoftext|>",
                              "single_word": False, "lstrip": False, "rstrip": False,
                              "normalized": False, "special": True}],
            "normalizer": None, "pre_tokenizer": byte_level, "post_processor": None,
            "decoder": byte_level,
            "model": {"type": "BPE", "dropout": None, "unk_token": None,
                      "continuing_subword_prefix": None, "end_of_word_suffix": None,
                      "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                      "vocab": vocab, "merges": [list(m) for m in CKPT_MERGES]}}
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", "model_max_length": 32768}, f)


def write_model_dir(d: str, llm, flow, hift, camp, s3, spk_dim: int, seed: int) -> None:
    """A model directory in the released format, with the port alone:
    llm.pt (plus the tied lm_head a released file carries), flow.pt, hift.pt
    under `generator.`, campplus.onnx (BatchNorm's counters left out, as in
    an export), speech_tokenizer_v2.onnx (whisper names), spk2info.pt and
    CosyVoice-BlankEN/tokenizer.json; fp32 throughout."""
    import os

    from cosyvoice_tpu_torch.models.s3tokenizer import s3tokenizer_state_dict
    from cosyvoice_tpu_torch.utils.onnx_io import write_onnx_tensors

    cpu = lambda m: {k: v.detach().float().cpu() if v.is_floating_point() else  # noqa: E731
                     v.detach().cpu() for k, v in m.state_dict().items()}
    os.makedirs(d, exist_ok=True)
    sd = cpu(llm)
    sd["llm.model.lm_head.weight"] = sd["llm.model.model.embed_tokens.weight"]
    torch.save(sd, os.path.join(d, "llm.pt"))
    del sd
    torch.save(cpu(flow), os.path.join(d, "flow.pt"))
    torch.save({f"generator.{k}": v for k, v in cpu(hift).items()}, os.path.join(d, "hift.pt"))
    write_onnx_tensors(os.path.join(d, "campplus.onnx"),
                       {k: v.numpy() for k, v in cpu(camp).items()
                        if not k.endswith("num_batches_tracked")})
    write_onnx_tensors(os.path.join(d, "speech_tokenizer_v2.onnx"), s3tokenizer_state_dict(s3))
    g = torch.Generator().manual_seed(seed)
    torch.save({"speaker": {"embedding": torch.randn(spk_dim, generator=g)}},
               os.path.join(d, "spk2info.pt"))
    write_tokenizer_json(os.path.join(d, "CosyVoice-BlankEN"))


def seeded_frontend_models(camp_cfg, s3_cfg, seed: int):
    """A CAMPPlus (seeded_campplus) and an S3 tokenizer on the card with
    seeded random weights."""
    from cosyvoice_tpu_torch.models.s3tokenizer import S3TokenizerV2

    with torch.device("cuda"):
        s3 = S3TokenizerV2(s3_cfg)
    rand_init_(s3, seed + 1)
    return seeded_campplus(camp_cfg, seed), s3


def seeded_campplus(camp_cfg, seed: int):
    """A CAMPPlus on the card with seeded random weights and perturbed
    BatchNorm statistics (so eval-mode BN is not an identity)."""
    from cosyvoice_tpu_torch.models.campplus import CAMPPlus

    with torch.device("cuda"):
        camp = CAMPPlus(camp_cfg)
    rand_init_(camp, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    with torch.no_grad():
        for m in camp.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                m.running_mean += 0.1 * torch.randn(m.running_mean.shape, generator=g,
                                                    device="cuda")
                m.running_var *= 0.75 + 0.5 * torch.rand(m.running_var.shape, generator=g,
                                                         device="cuda")
    return camp


def recording_generate(cv) -> list:
    """Record the tokens of every LM decode of cv (a list it appends to)."""
    got, generate = [], cv.model.llm_generate

    def run(*a):
        tokens = generate(*a)
        got.append(np.asarray(tokens).copy())
        return tokens
    cv.model.llm_generate = run
    return got


def prompt_16k(seconds: float, seed: int) -> np.ndarray:
    t = np.arange(int(16000 * seconds)) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 220 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
            + 0.01 * np.random.default_rng(seed).standard_normal(len(t))).astype(np.float32)


def small_checkpoint_checks(d: str) -> dict:
    """(a) A small fp32 directory loaded with device="cuda" and "cpu": text
    ids and speech tokens exact, the speaker vector within 5e-4, greedy
    tokens exact, the waveform within 1e-2."""
    from cosyvoice_tpu_torch.models.campplus import CAMPPlusConfig
    from cosyvoice_tpu_torch.models.conformer import ConformerConfig
    from cosyvoice_tpu_torch.models.flow import (CausalMaskedDiffWithXvec, EstimatorConfig,
                                                 FlowConfig)
    from cosyvoice_tpu_torch.models.hift import HiFTConfig, HiFTGenerator
    from cosyvoice_tpu_torch.models.llm import LMConfig, Qwen2LM, SamplingConfig
    from cosyvoice_tpu_torch.models.qwen2 import Qwen2Config
    from cosyvoice_tpu_torch.models.s3tokenizer import S3Config
    from cosyvoice_tpu_torch.runtime.api import from_pretrained

    cfgs = dict(
        lm_cfg=LMConfig(128, 128, 64, sampling=SamplingConfig(method="greedy"),
                        qwen=Qwen2Config(vocab_size=300, hidden_size=128, num_layers=2,
                                         num_heads=4, num_kv_heads=2, head_dim=64,
                                         intermediate_size=256, rope_theta=10000.0)),
        flow_cfg=FlowConfig(64, 80, 24, 67, encoder=ConformerConfig(64, 4, 128, 1, 64,
                                                                    static_chunk_size=50),
                            estimator=EstimatorConfig(in_channels=320, channels=(64,), n_blocks=1,
                                                      num_mid_blocks=1, num_heads=2,
                                                      attention_head_dim=64,
                                                      fused_attention=True)),
        hift_cfg=HiFTConfig(base_channels=64, nb_harmonics=2, f0_cond_channels=32,
                            resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),)),
        campplus_cfg=CAMPPlusConfig(embedding_size=24, growth_rate=8, bn_size=2,
                                    init_channels=32, blocks=((2, 3, 1), (2, 3, 2), (2, 3, 2))),
        s3_cfg=S3Config(dim=128, heads=2, layers=2, fsq_dim=3))      # 27 ids
    with torch.device("cuda"):
        llm, flow = Qwen2LM(cfgs["lm_cfg"]), CausalMaskedDiffWithXvec(cfgs["flow_cfg"])
        hift = HiFTGenerator(cfgs["hift_cfg"])
    for i, m in enumerate((llm, flow, hift)):
        rand_init_(m, 500 + i)
    with torch.no_grad():           # no stop id: every decode runs to the 60-token cap
        llm.llm_decoder.bias[64:] = -30.0
    camp, s3 = seeded_frontend_models(cfgs["campplus_cfg"], cfgs["s3_cfg"], 510)
    write_model_dir(d, llm, flow, hift, camp, s3, 24, 520)
    prompt, text, ptext = prompt_16k(2.3, 7), "The quick brown fox.", "A short prompt."
    out = {}
    for device in ("cuda", "cpu"):
        cv = from_pretrained(d, max_decode_tokens=60, device=device, **cfgs)
        tokens = recording_generate(cv)
        fe = cv.frontend.frontend_zero_shot(text, cv.frontend.text_normalize(ptext, False),
                                            prompt)
        wav = np.concatenate([o["tts_speech"] for o in cv.inference_zero_shot(
            text, ptext, prompt)])
        out[device] = (fe, tokens[0], wav)
    (fe_g, tok_g, wav_g), (fe_c, tok_c, wav_c) = out["cuda"], out["cpu"]
    ids_equal = all(np.array_equal(fe_g[k], fe_c[k]) for k in (
        "text", "prompt_text", "llm_prompt_speech_token"))
    spk_err = float(np.abs(fe_g["flow_embedding"] - fe_c["flow_embedding"]).max())
    wav_err = (float(np.abs(wav_g - wav_c).max()) if wav_g.shape == wav_c.shape
               else float("inf"))
    res = {"text_ids": len(fe_g["text"]), "prompt_speech_tokens":
           len(fe_g["llm_prompt_speech_token"]), "ids_and_speech_tokens_equal": ids_equal,
           "speaker_vector_max_abs_err": spk_err, "speaker_tol": 5e-4,
           "greedy_tokens": len(tok_g), "greedy_tokens_equal": bool(np.array_equal(tok_g, tok_c)),
           "wav_samples": len(wav_g), "wav_max_abs_err": wav_err, "wav_tol": 1e-2}
    res["ok"] = bool(ids_equal and spk_err <= 5e-4 and res["greedy_tokens_equal"]
                     and len(tok_g) > 0 and wav_err <= 1e-2 and np.isfinite(wav_g).all())
    return res


def frontend_ms(cv, prompts: dict, reps: int = 5) -> dict:
    """Milliseconds of each prompt's CAMPPlus vector, S3 tokens and 24 kHz
    mel: every part warmed up on every prompt first, then the median of
    `reps` calls a part and prompt."""
    from cosyvoice_tpu_torch.runtime.frontend import resample_poly

    fe = cv.frontend
    parts = {"campplus_ms": fe.spk_embedder, "s3_tokenizer_ms": fe.speech_tokenizer,
             "prompt_mel_ms": lambda w: fe._extract_speech_feat(
                 resample_poly(w, 16000, fe.sample_rate))}
    for fn in parts.values():
        for wav in prompts.values():
            fn(wav)
    out = {}
    for name, wav in prompts.items():
        out[name] = {}
        for key, fn in parts.items():
            times = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(wav)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            out[name][key] = float(np.median(times))
    return out


def serve_cli_check(d: str, prompt: np.ndarray, timeout_s: float = 600.0) -> dict:
    """(c) `python -m cosyvoice_tpu_torch.bin.serve --model_dir d --fp16 --quant
    int8 --continuous --num_slots 2` in a subprocess on a free port: seconds from launch to
    /health 200 (load, warm-up and bind), one streamed zero-shot request
    (a well-formed chunked WAV), then the server is terminated."""
    import base64
    import http.client
    import os
    import threading

    # a 60-token cap: the warm-up's rounds and the request decode up to it;
    # 2 slots: warm-up rounds of 1 and 2 streams (the serve phase drives 8);
    # both cut to keep the script inside its time
    cmd = [sys.executable, "-m", "cosyvoice_tpu_torch.bin.serve", "--model_dir", d, "--fp16",
           "--quant", "int8", "--continuous", "--host", "127.0.0.1", "--port", "0",
           "--max-decode-tokens", "60", "--num_slots", "2"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines, ready = [], threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line.rstrip())
            if line.startswith("serving on"):
                ready.set()
        ready.set()
    threading.Thread(target=read, daemon=True).start()
    res = {"command": " ".join(cmd[1:])}
    try:
        ready.wait(timeout_s)
        serving = [ln for ln in lines if ln.startswith("serving on")]
        if not serving:
            raise AssertionError(f"the server did not start (exit {proc.poll()}): "
                                 f"{lines[-20:]}")
        port = int(serving[0].rsplit(":", 1)[1])
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        c.request("GET", "/health")
        r = c.getresponse()
        health = (r.status, json.loads(r.read()))
        res["cold_start_s"] = time.perf_counter() - t0
        body = {"text": "The quick brown fox jumps over the lazy dog.",
                "prompt_text": "A short prompt.",
                "prompt_wav_b64": base64.b64encode(prompt.astype("<f4").tobytes()).decode()}
        resp = _post(port, "/tts/zero_shot", body, stream=True)
        res.update(health_ok=health == (200, {"status": "ok"}), stream_status=resp["status"],
                   stream_bytes=len(resp["data"]), stream_wav_ok=_wav_ok(resp, 24000),
                   first_data_s=resp["first_data_s"], stream_total_s=resp["total_s"],
                   server_log=[ln for ln in lines if ln.startswith(("loaded", "continuous warmup",
                                                                    "serving on"))])
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=60)
    res["exit_code"] = proc.returncode
    return res


def checkpoint_phase(res_main: dict, K1, K2, K3, K5, smi: str) -> dict:
    """Every user starts from a model directory: (a) a small fp32 directory
    loaded on the card and on the CPU (small_checkpoint_checks); (b) a
    full-width one (LMConfig, FlowConfig, HiFTConfig, CAMPPlusConfig,
    S3Config; fp32 .pt and .onnx files as released, seeded random weights)
    loaded with fp16=True, quant="int8": seconds a file, the frontend's
    milliseconds for a 3 s and a 10 s prompt, and 3 zero-shot requests from
    raw 16 kHz prompt audio (CKPT_CAP-token cap): latency, RTF, K2 launches (must
    be > 0: fp16 on the card takes the fused DiT attention); then one
    request loaded with quant="int4" (K5 launches must be > 0); (c) the
    command-line server over the same directory (serve_cli_check).  The
    directories live under build/ and are deleted at the end."""
    import os
    import shutil
    import tempfile

    from cosyvoice_tpu_torch.models.campplus import CAMPPlusConfig
    from cosyvoice_tpu_torch.models.flow import CausalMaskedDiffWithXvec, FlowConfig
    from cosyvoice_tpu_torch.models.hift import HiFTConfig, HiFTGenerator
    from cosyvoice_tpu_torch.models.llm import LMConfig, Qwen2LM
    from cosyvoice_tpu_torch.models.s3tokenizer import S3Config
    from cosyvoice_tpu_torch.runtime.api import from_pretrained

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="checkpoint_", dir=root)
    kernels = {"lm_decode_attention": K1, "dit_attention": K2, "fused_layer_norm": K3,
               "int4_matmul": K5}
    try:
        small = small_checkpoint_checks(os.path.join(tmp, "small"))
        full = os.path.join(tmp, "full")
        t0 = time.perf_counter()
        with torch.device("cuda"):
            llm, flow, hift = Qwen2LM(LMConfig()), CausalMaskedDiffWithXvec(FlowConfig()), \
                HiFTGenerator(HiFTConfig())
        for i, m in enumerate((llm, flow, hift)):
            rand_init_(m, 600 + i)
        camp, s3 = seeded_frontend_models(CAMPPlusConfig(), S3Config(), 610)
        write_model_dir(full, llm, flow, hift, camp, s3, 192, 620)
        del llm, flow, hift, camp, s3
        torch.cuda.empty_cache()
        write_s = time.perf_counter() - t0
        files_mb = {f: os.path.getsize(os.path.join(full, f)) / 2**20 for f in sorted(
            os.listdir(full)) if os.path.isfile(os.path.join(full, f))}

        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cv = from_pretrained(full, fp16=True, quant="int8", max_decode_tokens=CKPT_CAP,
                             device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        prompts = {"3s": res_main["prompt_wav"], "10s": prompt_16k(10.0, 11)}
        frontend = frontend_ms(cv, prompts)
        texts = ["Hello there.", "The quick brown fox jumps over the lazy dog.",
                 "The port loads a released model directory and answers from raw audio."]
        tokens = recording_generate(cv)
        requests = []
        for name in kernels:
            kernels[name].launches = 0
        for i, text in enumerate(texts):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wav = np.concatenate([o["tts_speech"] for o in cv.inference_zero_shot(
                text, "A short prompt.", prompts["3s"], gen=torch.Generator().manual_seed(i))])
            torch.cuda.synchronize()
            latency = time.perf_counter() - t0
            requests.append({"text_bytes": len(text.encode()), "speech_tokens": len(tokens[-1]),
                             "wav_samples": len(wav), "finite": bool(np.isfinite(wav).all()),
                             "latency_s": latency,
                             "rtf": latency / max(len(wav) / cv.sample_rate, 1e-9)})
        launches = {k: m.launches for k, m in kernels.items()}
        int8 = {"load_s": load_s, "load_seconds": cv.load_seconds, "frontend_ms": frontend,
                "requests": requests, "launches": launches,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
        del cv
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        cv = from_pretrained(full, fp16=True, quant="int4", max_decode_tokens=CKPT_CAP,
                             device="cuda")
        torch.cuda.synchronize()
        load4_s = time.perf_counter() - t0
        for name in kernels:
            kernels[name].launches = 0
        t0 = time.perf_counter()
        wav4 = np.concatenate([o["tts_speech"] for o in cv.inference_zero_shot(
            texts[1], "A short prompt.", prompts["3s"], gen=torch.Generator().manual_seed(1))])
        torch.cuda.synchronize()
        int4 = {"load_s": load4_s, "latency_s": time.perf_counter() - t0,
                "wav_samples": len(wav4), "finite": bool(np.isfinite(wav4).all()),
                "launches": {k: m.launches for k, m in kernels.items()}}
        del cv
        torch.cuda.empty_cache()
        cli = serve_cli_check(full, prompts["3s"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res = {"phase": "checkpoint", "card": smi, "small_fp32": small,
           "full_width": {"files_mb": files_mb, "write_s": write_s, "int8": int8,
                          "int4": int4},
           "serve_cli": cli}
    emit(res)
    gates = [small["ok"], all(r["finite"] and r["wav_samples"] > 0 for r in requests),
             launches["dit_attention"] > 0, int4["finite"],
             int4["launches"]["int4_matmul"] > 0, cli["health_ok"], cli["stream_wav_ok"]]
    if not all(gates):
        raise AssertionError(f"checkpoint phase failed: {res}")
    return res


# the v1 phase's HiFT: CosyVoice-300M's at 22.05 kHz (8 x 8 x 4 = 256 samples a
# mel frame, the hop CosyVoiceV1Model's mel counts assume)
V1_HIFT = dict(sampling_rate=22050, upsample_rates=(8, 8), upsample_kernel_sizes=(16, 16),
               source_resblock_kernel_sizes=(7, 11),
               source_resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)))
V1_TEXTS = ("Hello there, this is the first voice.",
            "The quick brown fox jumps over the lazy dog.")
# a few merges of the v1 phase's ranks file (after the 256 bytes)
V1_MERGES = (b"th", b"he", b" t", b"the", b"in", b"er", b" a", b"re", b"on", b" the",
             b"ou", b"is", b"ll", b"o ", b"ing", b" w")


def v1_tokenizer(d: str):
    """The ported WhisperTiktokenTokenizer over a small ranks file written
    into d: the 256 bytes, then V1_MERGES."""
    import base64
    import os

    from cosyvoice_tpu_torch.tokenizer.text import WhisperTiktokenTokenizer

    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "v1.tiktoken")
    ranks = [bytes([b]) for b in range(256)] + list(V1_MERGES)
    with open(path, "w") as f:
        f.writelines(f"{base64.b64encode(t).decode()} {r}\n" for r, t in enumerate(ranks))
    return WhisperTiktokenTokenizer(path)


def v1_small_stack(device: str):
    """A small fp32 CosyVoice v1 stack whose widths the kernels take (head_dim
    64, C % 32 == 0): the two-level non-causal estimator on the K2 + K3 route,
    greedy LM, deterministic 22.05 kHz HiFT."""
    from cosyvoice_tpu_torch.models.conformer import ConformerConfig
    from cosyvoice_tpu_torch.models.flow import EstimatorConfig, FlowV1Config, MaskedDiffWithXvec
    from cosyvoice_tpu_torch.models.hift import HiFTConfig, HiFTGenerator
    from cosyvoice_tpu_torch.models.llm import SamplingConfig, TransformerLM, TransformerLMConfig
    from cosyvoice_tpu_torch.runtime.model import CosyVoiceV1Model

    torch.manual_seed(0)
    llm = TransformerLM(TransformerLMConfig(
        64, 128, 128, 300, 64, 24, sampling=SamplingConfig(method="greedy"),
        text_encoder=ConformerConfig(128, 4, 256, 1, 64, static_chunk_size=1),
        llm=ConformerConfig(128, 4, 256, 2, 128, static_chunk_size=1,
                            input_layer="linear_legacy", activation="relu")))
    flow = MaskedDiffWithXvec(FlowV1Config(
        64, 80, 24, 64, encoder=ConformerConfig(64, 4, 128, 1, 64),
        estimator=EstimatorConfig(in_channels=320, causal=False, channels=(64, 64), n_blocks=1,
                                  num_mid_blocks=1, num_heads=2, attention_head_dim=64,
                                  fused_attention=True, fused_norm=True),
        regulator_stages=2))
    hift = HiFTGenerator(HiFTConfig(base_channels=64, nb_harmonics=2, f0_cond_channels=32,
                                    resblock_kernel_sizes=(3,),
                                    resblock_dilation_sizes=((1, 3),), **V1_HIFT),
                         deterministic=True)
    return CosyVoiceV1Model(llm=llm, flow=flow, hift=hift, max_decode_tokens=60, device=device)


def v1_reference_check() -> dict:
    """The small v1 stack on the card (kernels) and on the CPU (plain
    versions), same inputs: greedy tokens exact, waveform within 1e-2."""
    rng = np.random.default_rng(13)
    inputs = dict(text_tokens=rng.integers(0, 256, 20), prompt_text_len=5,
                  llm_prompt_speech_token=rng.integers(0, 64, 25),
                  flow_prompt_speech_token=rng.integers(0, 64, 25),
                  prompt_speech_feat=rng.standard_normal((86, 80)).astype(np.float32),
                  flow_embedding=rng.standard_normal(24).astype(np.float32),
                  llm_embedding=rng.standard_normal(24).astype(np.float32))
    out = {}
    for device in ("cuda", "cpu"):
        model = v1_small_stack(device)
        tokens = model.llm_generate(inputs["text_tokens"], 5, inputs["llm_prompt_speech_token"],
                                    inputs["llm_embedding"], None)
        wav = next(model.tts(**inputs))["tts_speech"]
        out[device] = (tokens, wav)
    (tok_g, wav_g), (tok_c, wav_c) = out["cuda"], out["cpu"]
    err = float(np.abs(wav_g - wav_c).max()) if wav_g.shape == wav_c.shape else float("inf")
    res = {"phase": "v1", "check": "reference", "tokens": len(tok_g),
           "tokens_equal": bool(np.array_equal(tok_g, tok_c)), "wav_samples": len(wav_g),
           "wav_max_abs_err": err, "tol": 1e-2, "finite": bool(np.isfinite(wav_g).all())}
    emit(res)
    if not (res["tokens_equal"] and err <= 1e-2 and res["finite"] and len(tok_g)):
        raise AssertionError(f"the small v1 stack disagrees on the card and the CPU: {res}")
    return res


def v1_kernel_checks(K2, K3, T: int) -> dict:
    """K2 and K3 against their plain versions at the v1 estimator's full-width
    shapes for a flow call of T mel rows (the CFG pair, B = 2): K2 at T and
    at the mid level's ceil(T / 2) rows (every key valid), K3 over both
    levels' rows at C = 256, fp32 and bf16.  -> the largest bf16 error each."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(14)
    errs = {"dit_attention": 0.0, "fused_layer_norm": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for rows in (T, -(-T // 2)):
            qkv = torch.randn(2, rows, 1536, generator=g, device=dev).to(dtype)
            lens = torch.full((2,), rows, dtype=torch.int32, device=dev)
            q3, k3, v3 = (qkv[..., i * 512:(i + 1) * 512].reshape(2, rows, 8, 64)
                          for i in range(3))
            e2 = check_attention(f"v1_dit_attention_T{rows}", dtype,
                                 K2.dit_attention_packed(qkv, lens, 0.125, 64).reshape(
                                     2, rows, 8, 64),
                                 K2.dit_attention_plain(q3, k3, v3, lens, 0.125), lens,
                                 phase="v1")
            x = (torch.randn(2 * rows, 256, generator=g, device=dev) * 3).to(dtype)
            w, b = (torch.randn(256, generator=g, device=dev).to(dtype) for _ in range(2))
            e3 = max(check(f"v1_fused_layer_norm_{2 * rows}x256_{act}", dtype,
                           K3.fused_layer_norm(x, w, b, 1e-5, act),
                           K3.layer_norm_plain(x, w, b, 1e-5, act), phase="v1")
                     for act in ("none", "mish"))
            if dtype == torch.bfloat16:
                errs["dit_attention"] = max(errs["dit_attention"], e2)
                errs["fused_layer_norm"] = max(errs["fused_layer_norm"], e3)
    return errs


def v1_kernel_times(K2, K3, T: int) -> dict:
    """bf16 device times of K2 and K3 at the v1 estimator's shapes for a flow
    call of T mel rows (top level T, mid level ceil(T / 2); B = 2, every key
    valid), beside their plain versions and one PyTorch call (SDPA,
    F.layer_norm), with each shape's bound."""
    dev, bf, isz = torch.device("cuda"), torch.bfloat16, 2
    g = torch.Generator(device=dev).manual_seed(15)
    out = {"dit_attention": [], "fused_layer_norm": []}
    for rows in (T, -(-T // 2)):
        qkv = torch.randn(2, rows, 1536, generator=g, device=dev).to(bf)
        lens = torch.full((2,), rows, dtype=torch.int32, device=dev)
        q3, k3, v3 = (qkv[..., i * 512:(i + 1) * 512].reshape(2, rows, 8, 64) for i in range(3))
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q3, k3, v3))
        k2 = lambda: K2.dit_attention_packed(qkv, lens, 0.125, 64)
        sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh)
        t_bytes = 4 * 2 * rows * 512 * isz / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * 4 * 8 * rows * rows * 64 / BF16_FLOPS * 1e3
        out["dit_attention"].append(dict(
            shape=[2, rows, 1536, rows], ms=time_ms(k2), **dev_time(k2),
            plain_ms=time_ms(lambda: K2.dit_attention_plain(q3, k3, v3, lens, 0.125), iters=10),
            library_ms=time_ms(sdpa), **dev_time(sdpa, "library_dev"),
            bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations"))
        x = torch.randn(2 * rows, 256, generator=g, device=dev).to(bf)
        w, b = torch.randn(256, generator=g, device=dev).to(bf), torch.zeros(256, device=dev,
                                                                               dtype=bf)
        k3 = lambda: K3.fused_layer_norm(x, w, b, 1e-5, "none")
        ln = lambda: F.layer_norm(x, (256,), w, b, 1e-5)
        t_bytes = (2 * 2 * rows * 256 + 2 * 256) * isz / HBM_BYTES_PER_S * 1e3
        t_ops = 10 * 2 * rows * 256 / BF16_FLOPS * 1e3
        out["fused_layer_norm"].append(dict(
            shape=[2 * rows, 256], ms=time_ms(k3), **dev_time(k3),
            plain_ms=time_ms(lambda: K3.layer_norm_plain(x, w, b, 1e-5, "none")),
            library_ms=time_ms(ln), **dev_time(ln, "library_dev"),
            bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations"))
    return out


def v1_phase(kernels: dict, smi: str) -> dict:
    """CosyVoice-300M (CosyVoice v1) at full width on seeded random weights:
    TransformerLMConfig() in fp32 (non_random_ras), FlowV1Config() with its
    two-level non-causal estimator in bf16 on the K2 + K3 route (no pad,
    fused_block off), the 22.05 kHz HiFT in fp32; the frontend at 22.05 kHz
    (mel n_fft 1024, hop 256) with the port's CAMPPlus (192-d), a seeded 25
    Hz speech-token callable and the ported WhisperTiktokenTokenizer.
    Gates: the small stack's card-vs-CPU check; K2 and K3 against their plain
    versions at the full-width shapes; then two zero-shot requests from a
    3 s prompt (cap 200), one streamed (its tokens equal to a one-shot
    decode's with the same generator, its chunk lengths the v1 formula's)
    and one instruct request: finite waveforms of the expected length, and
    K2 / K3 launches equal to 640 / 1280 a flow call (10 Euler steps x 64
    DiT blocks, one attention and two LayerNorms each)."""
    import os

    from cosyvoice_tpu_torch.models.campplus import CAMPPlusConfig, make_campplus_frontend_fn
    from cosyvoice_tpu_torch.models.flow import FlowV1Config, MaskedDiffWithXvec
    from cosyvoice_tpu_torch.models.hift import HiFTConfig, HiFTGenerator
    from cosyvoice_tpu_torch.models.llm import TransformerLM, TransformerLMConfig
    from cosyvoice_tpu_torch.runtime import model as runtime_model
    from cosyvoice_tpu_torch.runtime.api import CosyVoice
    from cosyvoice_tpu_torch.runtime.frontend import CosyVoiceFrontEnd
    from cosyvoice_tpu_torch.runtime.model import CosyVoiceV1Model

    K2, K3 = kernels["dit_attention"], kernels["fused_layer_norm"]
    t_phase = time.perf_counter()
    small = v1_reference_check()
    t0 = time.perf_counter()
    fcfg = FlowV1Config()
    fcfg = dataclasses.replace(fcfg, estimator=dataclasses.replace(
        fcfg.estimator, dtype="bfloat16", fused_attention=True, fused_norm=True))
    with torch.device("cuda"):
        llm, flow = TransformerLM(TransformerLMConfig()), MaskedDiffWithXvec(fcfg)
        hift = HiFTGenerator(dataclasses.replace(HiFTConfig(), **V1_HIFT))
    for i, m in enumerate((llm, flow, hift)):
        rand_init_(m, 700 + i)
    flow.decoder.estimator.to(torch.bfloat16)
    camp = seeded_campplus(CAMPPlusConfig(), 710)
    model = CosyVoiceV1Model(llm=llm, flow=flow, hift=hift, max_decode_tokens=200,
                             device="cuda")

    def speech_tokens(wav):
        seed = int(np.abs(wav).sum() * 1e3) % (1 << 32)
        return np.random.default_rng(seed).integers(0, 4096, len(wav) * 25 // 16000)

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "v1_tokenizer")
    frontend = CosyVoiceFrontEnd(tokenizer=v1_tokenizer(build), speech_tokenizer=speech_tokens,
                                 spk_embedder=make_campplus_frontend_fn(camp),
                                 sample_rate=22050, mel_n_fft=1024, mel_hop=256, device="cuda")
    prompt = prompt_16k(3.0, 16)
    frontend.spk2info["speaker"] = {"embedding": frontend._extract_spk_embedding(prompt)}
    cv = CosyVoice(frontend=frontend, model=model)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    est = fcfg.estimator
    per_call = fcfg.cfm.n_timesteps * est.n_blocks * (2 * len(est.channels) + est.num_mid_blocks)
    stage = {"lm_s": 0.0, "flow_s": 0.0, "hift_s": 0.0}
    flow_rows, states, decodes = [], [], []
    inference = flow.inference

    def counted_flow(*a, **kw):
        flow_rows.append(int(a[4].shape[1]))       # the noise's rows: prompt + generated mel
        return inference(*a, **kw)

    generate, prefill = model.llm_generate, model._prefill

    def recording_generate(*a):
        tokens = generate(*a)
        decodes.append(len(tokens))
        return tokens

    def recording_prefill(*a):
        out = prefill(*a)
        states.append((out[0], a[:4]))
        return out

    # the LM's seconds: each prefill and each decode chunk, one-shot or streamed
    decode_chunk = runtime_model.lm_decode_chunk_v1
    runtime_model.lm_decode_chunk_v1 = timed(stage, "lm_s", decode_chunk)
    flow.inference = timed(stage, "flow_s", counted_flow)
    model.llm_generate = recording_generate
    model._prefill = timed(stage, "lm_s", recording_prefill)
    model._vocode = timed(stage, "hift_s", model._vocode)

    def mel_frames(n_tok):
        return int(n_tok / model.fr * model.sample_rate / 256)

    def request(kind, text, seed, stream=False):
        for key in stage:
            stage[key] = 0.0
        gen = torch.Generator().manual_seed(seed)
        calls = (cv.inference_instruct(text, "speaker", "A calm and slow voice.", gen=gen)
                 if kind == "instruct" else
                 cv.inference_zero_shot(text, "A short prompt.", prompt, stream=stream, gen=gen))
        rows0 = len(flow_rows)
        torch.cuda.synchronize()
        t0 = last = time.perf_counter()
        wavs, chunk_s = [], []
        for out in calls:
            torch.cuda.synchronize()
            now = time.perf_counter()
            wavs.append(out["tts_speech"])
            chunk_s.append(now - last)
            last = now
        latency = last - t0
        wav = np.concatenate(wavs)
        if stream:
            st, inputs = states[-1]
            n_tok = int(st.gen.count[0])
            tokens = (st.gen.out[0, :n_tok].cpu().numpy(), inputs)
            k = max((n_tok - model.token_overlap_len) // model.token_min_hop_len, 0)
            M, lap, cache = mel_frames(model.token_min_hop_len + model.token_overlap_len), \
                model.mel_overlap_len, model.mel_cache_len
            tail = mel_frames(n_tok - k * model.token_min_hop_len)
            want = ([M - lap - cache] * min(k, 1) + [M - lap] * max(k - 1, 0)
                    + [(cache if k else 0) + tail])
            want = [f * model.hop_samples for f in want]
        else:
            n_tok, tokens, want = decodes[-1], None, [mel_frames(decodes[-1]) * model.hop_samples]
        r = {"kind": kind, "stream": stream, "text_bytes": len(text.encode()),
             "speech_tokens": n_tok, "chunks": len(wavs), "chunk_samples": [len(w) for w in wavs],
             "chunk_samples_expected": want, "finite": bool(np.isfinite(wav).all()),
             "flow_calls": len(flow_rows) - rows0, "flow_rows": flow_rows[rows0:],
             "latency_s": latency, "first_chunk_s": chunk_s[0],
             "rtf": latency / max(len(wav) / model.sample_rate, 1e-9), **stage,
             "lm_ms_per_token": stage["lm_s"] * 1e3 / max(n_tok, 1)}
        return r, tokens

    for mod in kernels.values():
        mod.launches = 0
    torch.cuda.reset_peak_memory_stats()
    requests = [request("zero_shot", V1_TEXTS[0], 0)[0], request("zero_shot", V1_TEXTS[1], 1)[0]]
    streamed, (stream_tokens, stream_inputs) = request("zero_shot", V1_TEXTS[0], 2, stream=True)
    requests += [streamed, request("instruct", V1_TEXTS[1], 3)[0]]
    launches = {name: mod.launches for name, mod in kernels.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    # the streamed request's tokens against a one-shot decode of its inputs on
    # a generator seeded as its own was
    one_shot = generate(*stream_inputs, torch.Generator().manual_seed(2))
    flow_calls = sum(r["flow_calls"] for r in requests)
    T = max(flow_rows)
    T_odd = T if T % 2 else T + 1
    errs = v1_kernel_checks(K2, K3, T_odd)
    times = v1_kernel_times(K2, K3, T_odd)
    runtime_model.lm_decode_chunk_v1 = decode_chunk
    for m in ("inference", "llm_generate", "_prefill", "_vocode"):
        for obj in (flow, model):
            obj.__dict__.pop(m, None)
    res = {"phase": "v1", "card": smi, "setup_s": setup_s, "small_stack": small,
           "requests": requests, "peak_mem_gb": peak, "launches": launches,
           "flow_calls": flow_calls, "k2_per_flow_call": per_call,
           "k3_per_flow_call": 2 * per_call, "flow_rows_max": T, "kernel_check_T": T_odd,
           "stream_tokens_equal_one_shot": bool(np.array_equal(stream_tokens, one_shot)),
           "kernel_max_abs_err_bf16": errs, "kernel_times": times,
           "phase_s": time.perf_counter() - t_phase}
    emit(res)
    gates = [all(r["finite"] and r["chunk_samples"] == r["chunk_samples_expected"]
                 and r["speech_tokens"] > 0 for r in requests),
             res["stream_tokens_equal_one_shot"],
             launches["dit_attention"] == per_call * flow_calls > 0,
             launches["fused_layer_norm"] == 2 * per_call * flow_calls,
             streamed["chunks"] >= 2]
    if not all(gates):
        raise AssertionError(f"v1 phase failed: {gates} {res}")
    return res


# the phoneme phase: the production phoneme LM (cosyvoice2_pho.yaml's
# Qwen2LM_Phoneme_Src2) at full width, PHO_STREAMS streams of PHO_LEN seeded
# phonemes, PHO_TOKENS tokens a stream (both token ratios PHO_TOKENS /
# PHO_LEN), a 3 s prompt (75 tokens, 150 mel rows)
# PHO_TOKENS cut from 200 for the script's time
PHO_STREAMS, PHO_TOKENS, PHO_LEN, PHO_PROMPT = 8, 100, 40, 75


def pho_ids(rng, n: int, cfg) -> np.ndarray:
    """n seeded (phoneme, tone, lang, prosody) rows within cfg's tables."""
    return np.stack([rng.integers(0, size, n) for size, _ in cfg.tables], axis=-1)


def pho_small_lm(device: str, v1: bool = False):
    """A small fp32 Src2 phoneme LM whose widths the kernels take (head_dim
    64, the packed decode cache), greedy, its head biased away from EOS and
    the ids past it; or (v1) a small TransformerLMPhoneme with a
    speaker-adaptive text encoder.  Built on the CPU from one seed, so both
    devices hold the same weights."""
    from cosyvoice_tpu_torch.models.conformer import ConformerConfig
    from cosyvoice_tpu_torch.models.llm import SamplingConfig
    from cosyvoice_tpu_torch.models.llm_phoneme import (PhonemeEmbedConfig, PhonemeLMConfig,
                                                        Qwen2LMPhonemeSrc2)
    from cosyvoice_tpu_torch.models.llm_v1_phoneme import (TransformerLMPhoneme,
                                                           V1PhonemeLMConfig)
    from cosyvoice_tpu_torch.models.qwen2 import Qwen2Config

    greedy = SamplingConfig(method="greedy")
    pho = PhonemeEmbedConfig(30, 64, 16, 32, 2, 16, 6, 16)           # 128 wide
    torch.manual_seed(5)
    if v1:
        llm = TransformerLMPhoneme(V1PhonemeLMConfig(
            128, 128, 128, 300, 64, 24, sampling=greedy, phoneme=pho, spk_adapt=True,
            text_encoder=ConformerConfig(128, 4, 256, 1, 128, static_chunk_size=1),
            llm=ConformerConfig(128, 4, 256, 2, 128, static_chunk_size=1,
                                input_layer="linear_legacy", activation="relu")))
    else:
        llm = Qwen2LMPhonemeSrc2(PhonemeLMConfig(
            128, 128, 64, 24, sampling=greedy, phoneme=pho,
            encoder=ConformerConfig(128, 4, 256, 1, 128), fusion_heads=2, fusion_ffn=256,
            qwen=Qwen2Config(vocab_size=300, hidden_size=128, num_layers=2, num_heads=4,
                             num_kv_heads=2, head_dim=64, intermediate_size=256,
                             rope_theta=10000.0, fused_cache_update=True)))
        with torch.no_grad():
            llm.llm_decoder.bias[64:] -= 8.0
    return llm.to(device).eval()


def pho_small_checks() -> dict:
    """The small fp32 phoneme stacks on the card against the CPU: greedy
    tokens of phoneme_lm_generate (two ragged rows) and of the engine (5
    requests through 2 slots at three phoneme buckets, each also against a
    B=1 phoneme_lm_generate on the card), a 2-stream ContinuousSynthesizer
    (tokens exact, every chunk within CONT_WAV_TOL) and the v1 phoneme LM's
    greedy tokens."""
    from cosyvoice_tpu_torch.models.llm_phoneme import phoneme_lm_generate
    from cosyvoice_tpu_torch.models.llm_v1_phoneme import v1_phoneme_generate
    from cosyvoice_tpu_torch.runtime.engine import GenRequest, ServingEngine
    from cosyvoice_tpu_torch.runtime.model import CosyVoice2Model
    from cosyvoice_tpu_torch.runtime.serving import ContinuousSynthesizer, TTSRequest

    pcfg = pho_small_lm("cpu").cfg.phoneme
    rng = np.random.default_rng(31)
    B, Tt, Tp, Ts = 2, 12, 16, 10
    batch = dict(text=rng.integers(0, 300, (B, Tt)), text_len=np.array([12, 7]),
                 pho=np.stack([pho_ids(rng, Tp, pcfg) for _ in range(B)]),
                 pho_len=np.array([16, 9]), psp=rng.integers(0, 64, (B, Ts)),
                 psp_len=np.array([10, 4]),
                 emb=rng.standard_normal((B, 24)).astype(np.float32))
    reqs = [GenRequest(text=rng.integers(0, 300, nt), prompt_speech=rng.integers(0, 64, ns),
                       pho_token=pho_ids(rng, npho, pcfg),
                       embedding=rng.standard_normal(24).astype(np.float32),
                       min_len=4, max_len=30, new_text_len=npho)
            for nt, npho, ns in ((6, 7, 4), (4, 5, 2), (8, 13, 3), (5, 3, 6), (7, 11, 1))]
    streams = [TTSRequest(text_tokens=rng.integers(0, 300, 10), prompt_text_len=0,
                          prompt_speech_tokens=rng.integers(0, 64, p),
                          prompt_feat=(rng.standard_normal((2 * p, 80)) * 0.3).astype(np.float32),
                          embedding=rng.standard_normal(24).astype(np.float32),
                          pho_token=pho_ids(rng, 8, pcfg)) for p in (25, 10)]
    v1_in = (pho_ids(rng, 9, pcfg)[None], np.array([9]), rng.integers(0, 64, (1, 5)),
             np.array([5]), rng.standard_normal((1, 24)).astype(np.float32))

    def one(lm, dev, r):
        t = lambda x: torch.as_tensor(np.asarray(x), device=dev)[None]
        n = lambda v: torch.tensor([v], device=dev)
        out, cnt = phoneme_lm_generate(lm, t(r.text), n(len(r.text)), t(r.pho_token),
                                       n(len(r.pho_token)), t(r.prompt_speech),
                                       n(len(r.prompt_speech)), t(r.embedding), n(r.min_len),
                                       n(r.max_len), None, 30, 128)
        return out[0, :int(cnt[0])].cpu().numpy()

    runs = {}
    for dev in ("cuda", "cpu"):
        lm = pho_small_lm(dev)
        t = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        out, cnt = phoneme_lm_generate(lm, t["text"], t["text_len"], t["pho"], t["pho_len"],
                                       t["psp"], t["psp_len"], t["emb"],
                                       torch.tensor([5, 0], device=dev),
                                       torch.tensor([40, 25], device=dev), None, 40, 128)
        gen = [out[b, :int(cnt[b])].cpu().numpy() for b in range(B)]
        eng = ServingEngine(lm, num_slots=2, cache_len=128, max_out=30, segment_steps=6,
                            text_bucket=4, speech_bucket=8, device=dev).generate(reqs)
        b1 = [one(lm, dev, r) for r in reqs]
        base = small_stack(dev, max_decode_tokens=160)
        model = CosyVoice2Model(llm=lm, flow=base.flow, hift=base.hift, max_decode_tokens=160,
                                device=dev)
        chunks = [[], []]
        with EngineRecord() as rec:
            ContinuousSynthesizer(model, num_slots=2, cache_len=256, text_bucket=16,
                                  speech_bucket=32).synthesize_batch(
                streams, on_chunk=lambda i, wav, fin: chunks[i].append(wav))
        v1 = pho_small_lm(dev, v1=True)
        tv = [torch.as_tensor(x, device=dev) for x in v1_in]
        o1, c1 = v1_phoneme_generate(v1, *tv, torch.tensor([40], device=dev), None, 40, 128)
        runs[dev] = dict(gen=gen, eng=eng, b1=b1, stream_tokens=rec.tokens, chunks=chunks,
                         v1=o1[0, :int(c1[0])].cpu().numpy())
    g, c = runs["cuda"], runs["cpu"]
    same = lambda a, b: len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
    shapes = [[len(w) for w in ch] for ch in g["chunks"]]
    shapes_equal = shapes == [[len(w) for w in ch] for ch in c["chunks"]]
    return dict(
        generate_tokens=[len(x) for x in g["gen"]], generate_equal=same(g["gen"], c["gen"]),
        engine_tokens=[len(x) for x in g["eng"]], engine_equal_cpu=same(g["eng"], c["eng"]),
        engine_equal_b1=same(g["eng"], g["b1"]),
        stream_tokens=[len(x) for x in g["stream_tokens"]],
        stream_tokens_equal=same(g["stream_tokens"], c["stream_tokens"]),
        chunk_samples=shapes, chunk_samples_equal=shapes_equal,
        wav_max_abs_err=max(float(np.abs(a - b).max()) for x, y in zip(g["chunks"], c["chunks"])
                            for a, b in zip(x, y)) if shapes_equal else float("inf"),
        wav_tol=CONT_WAV_TOL, finite=all(np.isfinite(w).all() for ch in g["chunks"] for w in ch),
        v1_tokens=len(g["v1"]), v1_equal=bool(np.array_equal(g["v1"], c["v1"])))


def pho_full_width_lm():
    """cosyvoice2_pho.yaml's LM (PhonemeLMConfig defaults: the Qwen2-0.5B
    body int8 weight-only in bf16 over the packed decode cache, the 6 x 1024
    phoneme conformer and the fusion in bf16) on seeded random weights, its
    head biased away from the two ids past EOS."""
    from cosyvoice_tpu_torch.models.llm_phoneme import PhonemeLMConfig, Qwen2LMPhonemeSrc2
    from cosyvoice_tpu_torch.utils.quant import quantize_qwen_int8

    cfg = PhonemeLMConfig()
    with torch.device("cuda"):
        fp = Qwen2LMPhonemeSrc2(cfg)
        rand_init_(fp, 12400)
        state = quantize_qwen_int8(fp.to(torch.bfloat16).state_dict())
        del fp
        llm = Qwen2LMPhonemeSrc2(dataclasses.replace(cfg, qwen=dataclasses.replace(
            cfg.qwen, quant="int8", fused_cache_update=True))).to(torch.bfloat16)
        llm.load_state_dict(state, strict=True)
        # the ids past EOS are never emitted: keep every greedy step a token
        llm.llm_decoder.bias[cfg.eos_token + 1:] = -30.0
    return llm.eval()


def pho_b1_args(cfg, rng, spk_vec=None) -> tuple:
    """A B=1 phoneme request on the card: 20 text ids, PHO_LEN phonemes, a
    PHO_PROMPT-token prompt and a speaker vector (`spk_vec` [1, spk_dim], or
    a seeded random one)."""
    t = lambda x: torch.as_tensor(np.asarray(x), device="cuda")[None]
    n = lambda v: torch.tensor([v], device="cuda")
    text, pho = rng.integers(0, cfg.qwen.vocab_size, 20), pho_ids(rng, PHO_LEN, cfg.phoneme)
    psp = rng.integers(0, cfg.speech_token_size, PHO_PROMPT)
    if spk_vec is None:
        spk_vec = t(rng.standard_normal(cfg.spk_embed_dim).astype(np.float32))
    return t(text), n(20), t(pho), n(PHO_LEN), t(psp), n(PHO_PROMPT), spk_vec


def pho_b1_decode(llm, args: tuple, steps: int):
    """A greedy B=1 decode of exactly `steps` tokens (EOS masked throughout)
    -> (its GenState, (encoder + fusion s, prefill s, decode s))."""
    from cosyvoice_tpu_torch.models.llm import (SamplingConfig, lm_decode_chunk,
                                                lm_prefill_from_embeds)

    cfg = llm.cfg
    llm.cfg = dataclasses.replace(cfg, sampling=SamplingConfig(method="greedy"))
    n = lambda v: torch.tensor([v], device="cuda")
    cache_len = -(-(3 + 20 + PHO_LEN + PHO_PROMPT + steps) // 128) * 128
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embeds, seq_len = llm.prefix_for_decode(*args)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    stream = lm_prefill_from_embeds(llm, embeds, seq_len, n(steps), n(steps), None,
                                    steps, cache_len)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    lm_decode_chunk(llm, stream, steps)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    llm.cfg = cfg
    return stream.gen, (t1 - t0, t2 - t1, t3 - t2)


def pho_b1_generate(llm, kernels: dict, n_tok: int) -> dict:
    """One B=1 greedy decode of n_tok tokens (EOS masked throughout) from a
    PHO_LEN-phoneme request with a 3 s prompt: the prefix's milliseconds
    (phoneme encoder + fusion + packing, then the body's prefill) and the
    decode's milliseconds a token, after one short warm-up decode."""
    args = pho_b1_args(llm.cfg, np.random.default_rng(41))
    pho_b1_decode(llm, args, 5)
    for mod in kernels.values():
        mod.launches = 0
    state, (enc_s, prefill_s, decode_s) = pho_b1_decode(llm, args, n_tok)
    launches = {name: mod.launches for name, mod in kernels.items()}
    return dict(prefix_len=int(PHO_LEN + PHO_PROMPT + 3), tokens=int(state.count[0]),
                steps=state.step, encoder_fusion_ms=enc_s * 1e3, prefill_ms=prefill_s * 1e3,
                prefix_ms=(enc_s + prefill_s) * 1e3,
                decode_ms_per_token=decode_s * 1e3 / max(state.step - 1, 1),
                launches=launches)


def pho_v1_generate(kernels: dict, n_tok: int) -> dict:
    """cosyvoice_phoneme.yaml's v1 LM (V1PhonemeLMConfig defaults, fp32) on
    seeded random weights, EOS's logit biased down: one warm-up, then
    n_tok greedy tokens from a PHO_LEN-phoneme request with a 3 s prompt,
    prefill and decode timed apart."""
    from cosyvoice_tpu_torch.models.llm import (SamplingConfig, lm_decode_chunk_v1,
                                                lm_prefill_stream_v1)
    from cosyvoice_tpu_torch.models.llm_v1_phoneme import (TransformerLMPhoneme,
                                                           V1PhonemeLMConfig)

    cfg = dataclasses.replace(V1PhonemeLMConfig(), sampling=SamplingConfig(method="greedy"))
    with torch.device("cuda"):
        llm = TransformerLMPhoneme(cfg)
    rand_init_(llm, 12410)
    with torch.no_grad():
        llm.llm_decoder.bias[cfg.eos_token] = -30.0
    llm.eval()
    rng = np.random.default_rng(42)
    t = lambda x: torch.as_tensor(np.asarray(x), device="cuda")[None]
    n = lambda v: torch.tensor([v], device="cuda")
    args = (t(pho_ids(rng, PHO_LEN, cfg.phoneme)), n(PHO_LEN),
            t(rng.integers(0, cfg.speech_token_size, PHO_PROMPT)), n(PHO_PROMPT),
            t(rng.standard_normal(cfg.spk_embed_dim).astype(np.float32)))
    cache_len = -(-(3 + PHO_LEN + PHO_PROMPT + n_tok) // 128) * 128

    def run(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stream = lm_prefill_stream_v1(llm, *args, n(steps), None, steps, cache_len)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lm_decode_chunk_v1(llm, stream, steps)
        torch.cuda.synchronize()
        return stream.gen, t1 - t0, time.perf_counter() - t1

    run(5)
    for mod in kernels.values():
        mod.launches = 0
    state, prefill_s, decode_s = run(n_tok)
    res = dict(tokens=int(state.count[0]), steps=state.step, prefill_ms=prefill_s * 1e3,
               decode_ms_per_token=decode_s * 1e3 / max(state.step - 1, 1),
               launches={name: mod.launches for name, mod in kernels.items()})
    del llm
    torch.cuda.empty_cache()
    return res


@torch.no_grad()
def phoneme_phase(res_main: dict, kernels: dict, smi: str) -> dict:
    """The phoneme LMs: (a) pho_small_checks; (b) at full width the
    production LM (pho_full_width_lm) with the main path's flow at a 512-d
    speaker vector (FlowConfig, bf16 on K2 + K3) and its bf16 HiFT: one B=1
    greedy decode of PHO_TOKENS tokens (pho_b1_generate), then PHO_STREAMS
    streams of PHO_LEN seeded phonemes and PHO_TOKENS tokens each (the
    recipe's non_random_ras) through as many slots, windowed
    (flow_context_tokens 250), hop_scale 2.0, from a 3 s prompt (75 tokens,
    a seeded mel and 512-d vector); (c) the v1 phoneme LM (pho_v1_generate).
    Gates: every small-stack comparison; the full-width runs emit every
    token, a finite wav a stream, K1 > 0 in the B=1 decode and K1, K2, K3
    > 0 in the streams.  Every run resets all kernel counts before it and
    reads them after."""
    from cosyvoice_tpu_torch.models.flow import CausalMaskedDiffWithXvec, FlowConfig
    from cosyvoice_tpu_torch.runtime.model import CosyVoice2Model
    from cosyvoice_tpu_torch.runtime.serving import TTSRequest

    K1, K2, K3 = (kernels[k] for k in ("lm_decode_attention", "dit_attention",
                                       "fused_layer_norm"))
    t_phase = time.perf_counter()
    small = pho_small_checks()
    t0 = time.perf_counter()
    llm = pho_full_width_lm()
    fcfg = FlowConfig(spk_embed_dim=llm.cfg.spk_embed_dim)
    with torch.device("cuda"):
        flow = CausalMaskedDiffWithXvec(dataclasses.replace(
            fcfg, encoder_dtype="bfloat16", estimator=dataclasses.replace(
                fcfg.estimator, dtype="bfloat16", fused_attention=True, fused_norm=True,
                approx_gelu=True)))
    rand_init_(flow, 12401)
    flow.encoder.to(torch.bfloat16)
    flow.decoder.estimator.to(torch.bfloat16)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    b1 = pho_b1_generate(llm, kernels, PHO_TOKENS)
    ratio = PHO_TOKENS / PHO_LEN              # min = max = PHO_TOKENS tokens
    llm.cfg = dataclasses.replace(llm.cfg, min_token_text_ratio=ratio,
                                  max_token_text_ratio=ratio)
    rng = np.random.default_rng(43)
    reqs = [TTSRequest(text_tokens=rng.integers(0, llm.cfg.qwen.vocab_size, 20),
                       prompt_text_len=0,
                       prompt_speech_tokens=rng.integers(0, llm.cfg.speech_token_size,
                                                         PHO_PROMPT),
                       prompt_feat=(rng.standard_normal((2 * PHO_PROMPT, 80)) * 0.5
                                    ).astype(np.float32),
                       embedding=rng.standard_normal(llm.cfg.spk_embed_dim).astype(np.float32),
                       pho_token=pho_ids(rng, PHO_LEN, llm.cfg.phoneme))
            for _ in range(PHO_STREAMS)]
    model = CosyVoice2Model(llm=llm, flow=flow, hift=res_main["stack"][2],
                            max_decode_tokens=PHO_TOKENS, device="cuda",
                            flow_context_tokens=250)
    for mod in kernels.values():
        mod.launches = 0
    streams = continuous_full(model, reqs, K1, K2, K3, incremental=False)
    streams["launches"] = {name: mod.launches for name, mod in kernels.items()}
    del model, llm, flow
    torch.cuda.empty_cache()
    v1 = pho_v1_generate(kernels, PHO_TOKENS)
    res = {"phase": "phoneme", "card": smi, "small_fp32": small, "setup_s": setup_s,
           "b1_generate": b1,
           "traffic": {"streams": PHO_STREAMS, "slots": PHO_STREAMS, "phonemes": PHO_LEN,
                       "tokens_a_stream": PHO_TOKENS, "hop_scale": 2.0,
                       "prompt_speech_tokens": PHO_PROMPT, "flow_context_tokens": 250},
           "streams": streams, "v1_generate": v1, "phase_s": time.perf_counter() - t_phase}
    emit(res)
    gates = [small["generate_equal"], small["engine_equal_cpu"], small["engine_equal_b1"],
             small["stream_tokens_equal"], small["chunk_samples_equal"],
             small["wav_max_abs_err"] <= small["wav_tol"], small["finite"], small["v1_equal"],
             min(small["generate_tokens"]) > 0, small["v1_tokens"] > 0,
             b1["tokens"] == PHO_TOKENS, b1["launches"]["lm_decode_attention"] > 0,
             streams["tokens"] == [PHO_TOKENS] * PHO_STREAMS, streams["finite"],
             all(streams["launches"][k] > 0 for k in ("lm_decode_attention", "dit_attention",
                                                      "fused_layer_norm")),
             v1["tokens"] == PHO_TOKENS]
    if not all(gates):
        raise AssertionError(f"phoneme phase failed: {gates} {res}")
    return res


# the lam phase: the LAM speaker stack (SpeakerEmbeddingConfig) on prompts of
# LAM_PROMPTS_S seconds of 24 kHz audio, VITS at its recipe over the bigvgan
# phase's rows (4 rows of 250/200/150/100 tokens, 960 samples a token), and
# the chain 10 s prompt -> speaker vector -> the phoneme phase's LM (200
# greedy tokens) -> VITS; the small stacks of (a) below
LAM_PROMPTS_S, LAM_VITS_ROWS, LAM_REPS = (3.0, 10.0), (250, 200, 150, 100), 5
LAM_SMALL_SPK = dict(inter_channels=32, hidden_channels=32, speaker_emb_dim=24,
                     style_hidden=32, style_layers=2, gst_tokens=64, gst_heads=4, gst_layers=2)
LAM_SMALL_CAMP = dict(embedding_size=16, growth_rate=8, bn_size=2, init_channels=16,
                      blocks=((2, 3, 1), (2, 3, 2), (2, 3, 2)))
LAM_SMALL_VITS = dict(n_vocab=64, inter_channels=32, hidden_channels=32, filter_channels=64,
                      n_heads=2, n_layers=2, resblock_kernel_sizes=(3, 7),
                      resblock_dilation_sizes=((1, 3), (1, 3)), upsample_rates=(4, 3),
                      upsample_initial_channel=64, upsample_kernel_sizes=(8, 7),
                      gin_channels=24)
# the small SpeakerEmbedding's vector, card against CPU (the checkpoint
# phase's CAMPPlus bar); the small VITS wav (the reference phase's bar)
LAM_VEC_TOL, LAM_WAV_TOL = 5e-4, 1e-2


def lam_wav(seconds: float, seed: int) -> np.ndarray:
    """A seeded 24 kHz prompt: two tones with a tremolo and a little noise."""
    t = np.arange(int(24000 * seconds)) / 24000.0
    return (0.3 * np.sin(2 * np.pi * 180 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
            + 0.1 * np.sin(2 * np.pi * 410 * t)
            + 0.01 * np.random.default_rng(seed).standard_normal(len(t))).astype(np.float32)


def lam_small_models(device: str):
    """(SpeakerEmbedding, VitsDecoder, TransformerLMPhonemeWithSpk) at small
    fp32 widths (the speaker stacks on the recipe's 1024 / 300 spectrum, a
    VITS with two 1-block upsample conformers, pho_small_lm's v1 LM), built
    on the CPU from one seed so both devices hold the same weights."""
    from cosyvoice_tpu_torch.models.campplus import CAMPPlusConfig
    from cosyvoice_tpu_torch.models.conformer import ConformerConfig
    from cosyvoice_tpu_torch.models.llm_v1_phoneme import (TransformerLMPhonemeWithSpk,
                                                           WithSpkConfig)
    from cosyvoice_tpu_torch.models.speaker import SpeakerEmbedding, SpeakerEmbeddingConfig
    from cosyvoice_tpu_torch.models.vits import VitsConfig, VitsDecoder

    lm_cfg = pho_small_lm("cpu", v1=True).cfg
    spk_cfg = SpeakerEmbeddingConfig(**LAM_SMALL_SPK,
                                     campplus=CAMPPlusConfig(**LAM_SMALL_CAMP))
    up = ConformerConfig(32, 2, 64, 1, 32)
    torch.manual_seed(61)
    models = (SpeakerEmbedding(spk_cfg),
              VitsDecoder(VitsConfig(**LAM_SMALL_VITS, up_enc1=up, up_enc2=up)),
              TransformerLMPhonemeWithSpk(WithSpkConfig(lm=lm_cfg, spk=spk_cfg)))
    return [m.to(device).eval() for m in models]


def lam_small_checks() -> dict:
    """(a) The small fp32 stacks on the card against the CPU, every noise
    drawn on a CPU generator (the same draws on both): the SpeakerEmbedding
    vector of a 3 s prompt (speaker_embed), the VITS wav of two ragged rows
    at noise_scale 0.5, TransformerLMPhonemeWithSpk's greedy tokens from the
    prompt's features through encode_speaker and v1_phoneme_generate."""
    from cosyvoice_tpu_torch.models.llm_v1_phoneme import v1_phoneme_generate
    from cosyvoice_tpu_torch.models.speaker import speaker_embed, speaker_features

    wav3 = lam_wav(3.0, 60)
    rng = np.random.default_rng(62)
    tokens = rng.integers(0, LAM_SMALL_VITS["n_vocab"], (2, 30))
    tlen = np.array([30, 17])
    g = rng.standard_normal((2, LAM_SMALL_VITS["gin_channels"])).astype(np.float32)
    pho_cfg = pho_small_lm("cpu", v1=True).cfg.phoneme
    pho, psp = pho_ids(rng, 9, pho_cfg)[None], rng.integers(0, 64, (1, 5))
    runs = {}
    for dev in ("cuda", "cpu"):
        spk, vits, with_spk = lam_small_models(dev)
        t = lambda x: torch.as_tensor(np.asarray(x), device=dev)
        vec = speaker_embed(spk, wav3, gen=torch.Generator().manual_seed(63))
        wav = vits.inference(t(tokens), t(tlen), t(g), gen=torch.Generator().manual_seed(64),
                             noise_scale=0.5).cpu().numpy()
        emb = with_spk.encode_speaker(*speaker_features(with_spk.cfg.spk, wav3, dev),
                                      gen=torch.Generator().manual_seed(65))
        out, cnt = v1_phoneme_generate(with_spk.lm, t(pho), t([9]), t(psp), t([5]), emb,
                                       t([40]), None, 40, 128)
        runs[dev] = dict(vec=vec, wav=wav, emb=emb.cpu().numpy(),
                         tokens=out[0, :int(cnt[0])].cpu().numpy())
    g_, c_ = runs["cuda"], runs["cpu"]
    return dict(vec_max_abs_err=float(np.abs(g_["vec"] - c_["vec"]).max()),
                vec_tol=LAM_VEC_TOL, vec_dim=int(g_["vec"].shape[0]),
                wav_max_abs_err=float(np.abs(g_["wav"] - c_["wav"]).max()), wav_tol=LAM_WAV_TOL,
                wav_shape=list(g_["wav"].shape), wav_finite=bool(np.isfinite(g_["wav"]).all()),
                with_spk_vec_max_abs_err=float(np.abs(g_["emb"] - c_["emb"]).max()),
                with_spk_tokens=len(g_["tokens"]),
                with_spk_tokens_equal=bool(np.array_equal(g_["tokens"], c_["tokens"])))


def lam_speaker_ms(spk, wav: np.ndarray, reps: int = LAM_REPS) -> dict:
    """speaker_embed's parts a prompt, synchronised, after one warm-up: the
    features (resample_poly to 16 kHz on the host, kaldi fbank and the linear
    spectrum on the card), CAMPPlus, the posterior + style encoders, the GST
    and the fuser; the median of `reps` runs of each and of their sum."""
    from cosyvoice_tpu_torch.models.speaker import speaker_features

    gen = torch.Generator(device="cuda").manual_seed(66)
    parts = {"features": [], "campplus": [], "posterior_style": [], "gst_fuse": []}
    for rep in range(reps + 1):
        stamps = [time.perf_counter()]
        fb, spec, spec_len = speaker_features(spk.cfg, wav, "cuda")
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        timbre = spk.timbre(fb)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        style = spk.style(spec, spec_len, gen=gen)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        vec = spk.fuse(timbre, style)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        if rep:
            for key, a, b in zip(parts, stamps, stamps[1:]):
                parts[key].append((b - a) * 1e3)
    res = {f"{key}_ms": float(np.median(v)) for key, v in parts.items()}
    res["total_ms"] = float(np.median([sum(x) for x in zip(*parts.values())]))
    res.update(frames_spec=int(spec.shape[1]), frames_fbank=int(fb.shape[1]),
               finite=bool(torch.isfinite(vec).all()))
    return res


def lam_vits_full(vits) -> dict:
    """(b) VITS at RECIPE, fp32: 4 rows of LAM_VITS_ROWS tokens (pad ids 0),
    seeded 512-d speaker vectors, noise from a CUDA generator: a warm-up and
    a timed inference."""
    lens = list(LAM_VITS_ROWS)
    T = max(lens)
    g = torch.Generator(device="cuda").manual_seed(67)
    tlen = torch.tensor(lens, device="cuda")
    valid = torch.arange(T, device="cuda")[None] < tlen[:, None]
    tokens = torch.where(valid, torch.randint(0, vits.cfg.n_vocab, (4, T), generator=g,
                                              device="cuda"), 0)
    spk = torch.randn(4, vits.cfg.gin_channels, generator=g, device="cuda")
    per_token = math.prod(vits.cfg.upsample_rates) * 4        # two 2x conformers

    def forward():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wav = vits.inference(tokens, tlen, spk, gen=g, noise_scale=0.5)
        torch.cuda.synchronize()
        return wav, time.perf_counter() - t0

    forward()
    torch.cuda.reset_peak_memory_stats()
    wav, wall = forward()
    audio_s = sum(lens) * per_token / 24000.0
    return dict(rows_tokens=lens, samples_a_token=per_token, wav_shape=list(wav.shape),
                row_samples=[n * per_token for n in lens], wall_s=wall, audio_s=audio_s,
                rtf=wall / audio_s, peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
                finite=bool(torch.isfinite(wav).all()), wav_max_abs=float(wav.abs().max()))


def lam_chain(spk, vits, kernels: dict) -> dict:
    """(c) One LAM request: the 10 s prompt's speaker vector (speaker_embed),
    cosyvoice2_pho.yaml's Src2 LM at full width (pho_full_width_lm: int8
    body on K1) decoding PHO_TOKENS greedy tokens from the phoneme phase's
    request shape with that vector, then VITS with g = the vector; one
    warm-up chain of 5 tokens first.  Every kernel count is reset before the
    timed chain and read after it."""
    from cosyvoice_tpu_torch.models.speaker import speaker_embed

    llm = pho_full_width_lm()
    wav10 = lam_wav(10.0, 68)
    gen = torch.Generator(device="cuda").manual_seed(69)

    def chain(steps: int):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vec = torch.as_tensor(speaker_embed(spk, wav10, gen=gen), device="cuda")[None]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, lm_s = pho_b1_decode(llm, pho_b1_args(llm.cfg, np.random.default_rng(70),
                                                     vec), steps)
        n = int(state.count[0])
        t2 = time.perf_counter()
        wav = vits.inference(state.out[:, :n], state.count, vec, gen=gen, noise_scale=0.5)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        return vec, n, wav, (t1 - t0, t2 - t1, t3 - t2, lm_s)

    chain(5)
    for mod in kernels.values():
        mod.launches = 0
    vec, n, wav, (spk_s, lm_s, vits_s, (enc_s, prefill_s, decode_s)) = chain(PHO_TOKENS)
    launches = {name: mod.launches for name, mod in kernels.items()}
    layers = llm.cfg.qwen.num_layers
    del llm
    torch.cuda.empty_cache()
    total = spk_s + lm_s + vits_s
    audio_s = wav.shape[1] / 24000.0
    return dict(prompt_s=10.0, tokens=n, speaker_ms=spk_s * 1e3, lm_s=lm_s,
                lm_prefix_ms=(enc_s + prefill_s) * 1e3,
                lm_ms_per_token=decode_s * 1e3 / max(n - 1, 1), vits_s=vits_s, total_s=total,
                audio_s=audio_s, rtf=total / audio_s, wav_shape=list(wav.shape),
                wav_finite=bool(torch.isfinite(wav).all()),
                wav_max_abs=float(wav.abs().max()), vec_norm=float(vec.norm()),
                launches=launches, k1_launches_expected=layers * (PHO_TOKENS - 1))


@torch.no_grad()
def lam_phase(kernels: dict, smi: str) -> dict:
    """The LAM stack: (a) lam_small_checks; (b) SpeakerEmbeddingConfig() in
    fp32 on seeded fan-in-scaled weights (CAMPPlus with perturbed BatchNorm
    statistics) on the 3 s and 10 s prompts (lam_speaker_ms), VITS at its
    recipe (lam_vits_full); (c) lam_chain.  Gates: every small-stack bar;
    finite vectors of 512; a finite full-width wav in [-1, 1] of the rows'
    shape; the chain's PHO_TOKENS tokens, a finite wav of 960 samples a
    token and K1 > 0."""
    from cosyvoice_tpu_torch.models.speaker import SpeakerEmbedding, SpeakerEmbeddingConfig
    from cosyvoice_tpu_torch.models.vits import RECIPE, VitsDecoder

    t_phase = time.perf_counter()
    small = lam_small_checks()
    cfg = SpeakerEmbeddingConfig()
    with torch.device("cuda"):
        spk = SpeakerEmbedding(cfg)
        vits = VitsDecoder(RECIPE)
    rand_init_(spk, 12430)
    spk.speaker_encoder = seeded_campplus(cfg.campplus, 12431)
    rand_init_(vits, 12432)
    spk.eval()
    vits.eval()
    speaker = {f"{s:g}s": lam_speaker_ms(spk, lam_wav(s, 71)) for s in LAM_PROMPTS_S}
    full = lam_vits_full(vits)
    chain = lam_chain(spk, vits, kernels)
    del spk, vits
    torch.cuda.empty_cache()
    res = {"phase": "lam", "card": smi, "small_fp32": small,
           "speaker_config": "SpeakerEmbeddingConfig() fp32", "speaker_ms": speaker,
           "vits_config": "cosyvoice2_vits_tts.yaml (models/vits.py RECIPE) fp32",
           "vits": full, "chain": chain, "phase_s": time.perf_counter() - t_phase}
    emit(res)
    T = max(LAM_VITS_ROWS)
    gates = [small["vec_max_abs_err"] <= LAM_VEC_TOL, small["wav_max_abs_err"] <= LAM_WAV_TOL,
             small["wav_finite"], small["with_spk_tokens_equal"], small["with_spk_tokens"] > 0,
             all(r["finite"] for r in speaker.values()),
             full["finite"], full["wav_max_abs"] <= 1.0,
             full["wav_shape"] == [4, T * full["samples_a_token"]],
             chain["tokens"] == PHO_TOKENS, chain["wav_finite"], chain["wav_max_abs"] <= 1.0,
             chain["wav_shape"] == [1, PHO_TOKENS * full["samples_a_token"]],
             chain["launches"]["lm_decode_attention"] > 0]
    if not all(gates):
        raise AssertionError(f"lam phase failed: {gates} {res}")
    return res


# the multicode phase: cosyvoice2_multicode.yaml's LM, built through the
# port's config.py; B=1 requests of MC_TEXT text ids and MC_PHONEMES
# phonemes with a 3 s prompt of MC_PROMPT aligned code rows (40 Hz) and a
# 512-d speaker vector, MC_STEPS greedy steps; then MC_ROWS ragged rows
MC_RECIPE = "cosyvoice2/conf/cosyvoice2_multicode.yaml"
# MC_STEPS cut from 200 for the script's time
MC_STEPS, MC_TEXT, MC_PHONEMES, MC_PROMPT = 100, 20, 40, 120
MC_ROWS = ((20, 40, 120), (16, 33, 100), (12, 26, 80), (8, 19, 60))   # text, phonemes, prompt


def mc_small_lm(device: str):
    """A small fp32 multi-code LM whose widths the kernels take (head_dim
    64, the packed decode cache), greedy, its head biased away from EOS and
    BOS; built on the CPU from one seed, so both devices hold the same
    weights."""
    from cosyvoice_tpu_torch.models.conformer import ConformerConfig
    from cosyvoice_tpu_torch.models.llm import SamplingConfig
    from cosyvoice_tpu_torch.models.llm_multicode import (MultiCodeLMConfig,
                                                          Qwen2LMPhonemeMultiCode)
    from cosyvoice_tpu_torch.models.llm_phoneme import PhonemeEmbedConfig
    from cosyvoice_tpu_torch.models.qwen2 import Qwen2Config

    torch.manual_seed(6)
    llm = Qwen2LMPhonemeMultiCode(MultiCodeLMConfig(
        128, 128, 64, 24, sampling=SamplingConfig(method="greedy"),
        phoneme=PhonemeEmbedConfig(30, 64, 16, 32, 2, 16, 6, 16),
        encoder=ConformerConfig(128, 4, 256, 1, 128), fusion_heads=2, fusion_ffn=256,
        qwen=Qwen2Config(vocab_size=300, hidden_size=128, num_layers=2, num_heads=4,
                         num_kv_heads=2, head_dim=64, intermediate_size=256,
                         rope_theta=10000.0, fused_cache_update=True),
        codebooknum=3, src_attn_layers=2))
    with torch.no_grad():
        C = llm.cfg.codebooknum
        llm.ar_decoder.model.bias[llm.cfg.eos_id * C:] -= 8.0
    return llm.to(device).eval()


def mc_args(cfg, rows, rng, device: str) -> tuple:
    """Ragged multi-code requests: rows of (text ids, phonemes, prompt code
    rows) -> the padded tensors multicode_generate takes (speaker vectors of
    cfg.spk_embed_dim)."""
    B = len(rows)
    Tt, Tp, Tc = (max(r[i] for r in rows) for i in range(3))
    pho = np.zeros((B, Tp, 4), np.int64)
    for b, (_, n, _) in enumerate(rows):
        pho[b, :n] = pho_ids(rng, n, cfg.phoneme)
    t = lambda x: torch.as_tensor(np.asarray(x), device=device)
    return (t(rng.integers(0, cfg.qwen.vocab_size, (B, Tt))), t([r[0] for r in rows]), t(pho),
            t([r[1] for r in rows]), t(rng.integers(0, cfg.speech_token_size,
                                                    (B, Tc, cfg.codebooknum))),
            t([r[2] for r in rows]),
            t(rng.standard_normal((B, cfg.spk_embed_dim)).astype(np.float32)))


def mc_small_checks() -> dict:
    """The small fp32 multi-code LM on the card against the CPU: greedy
    delayed codes, steps and done flags of two ragged rows, 40 steps."""
    from cosyvoice_tpu_torch.models.llm_multicode import multicode_generate

    runs = {}
    for dev in ("cuda", "cpu"):
        lm = mc_small_lm(dev)
        args = mc_args(lm.cfg, ((12, 16, 10), (7, 9, 4)), np.random.default_rng(33), dev)
        out, n, done = multicode_generate(lm, *args, torch.tensor([40, 40], device=dev), None,
                                          40, 128)
        runs[dev] = (out.cpu().numpy(), n, done.cpu().numpy())
    (og, ng, dg), (oc, nc, dc) = runs["cuda"], runs["cpu"]
    return dict(steps=ng, codes_equal=bool(np.array_equal(og, oc)), steps_equal=ng == nc,
                done_equal=bool(np.array_equal(dg, dc)))


def mc_full_width_lm():
    """cosyvoice2_multicode.yaml's LM through config.recipe_config (the
    Qwen2-0.5B body, the 6 x 1024 phoneme conformer, 4 fusion layers, 6
    codebooks of 1002 ids) on seeded fan-in-scaled weights in bf16, greedy,
    over the packed decode cache (every one-token step on K1), its head
    biased away from EOS and BOS so that every step emits codes."""
    from cosyvoice_tpu_torch.config import recipe_config
    from cosyvoice_tpu_torch.models.llm import SamplingConfig
    from cosyvoice_tpu_torch.models.llm_multicode import Qwen2LMPhonemeMultiCode

    cfg = recipe_config(MC_RECIPE, "llm")
    cfg = dataclasses.replace(cfg, sampling=SamplingConfig(method="greedy"),
                              qwen=dataclasses.replace(cfg.qwen, fused_cache_update=True))
    with torch.device("cuda"):
        llm = Qwen2LMPhonemeMultiCode(cfg)
    rand_init_(llm, 12440)
    llm.to(torch.bfloat16)
    with torch.no_grad():
        llm.ar_decoder.model.bias[cfg.eos_id * cfg.codebooknum:] = -30.0
    return llm.eval()


def mc_generate(llm, rows, K1, seed: int) -> dict:
    """MC_STEPS greedy steps over `rows` after a one-step warm-up: the
    prefix's milliseconds (the one-step call: phoneme encoder, fusion,
    packing, the prefill and the first codes), milliseconds a later step,
    the reverted matrix's shape, peak memory, K1 launches."""
    from cosyvoice_tpu_torch.models.llm_multicode import multicode_generate
    from cosyvoice_tpu_torch.ops.delay import revert_delay_pattern

    args = mc_args(llm.cfg, rows, np.random.default_rng(seed), "cuda")
    B = len(rows)
    cache_len = -(-(3 + max(r[1] + r[2] for r in rows) + MC_STEPS) // 128) * 128
    max_len = torch.full((B,), MC_STEPS, device="cuda")

    def run(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = multicode_generate(llm, *args, max_len, None, steps, cache_len)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    run(1)
    _, prefix_s = run(1)
    torch.cuda.reset_peak_memory_stats()
    K1.launches = 0
    (out, n, done), total_s = run(MC_STEPS)
    launches = K1.launches
    rev = revert_delay_pattern(out[:, 1:n + 1])
    codes = out[:, 1:n + 1]
    return dict(rows=[list(r) for r in rows], steps=n, done=done.tolist(),
                prefix_ms=prefix_s * 1e3,
                ms_per_step=(total_s - prefix_s) * 1e3 / max(n - 1, 1), total_s=total_s,
                reverted_shape=list(rev.shape),
                codes_in_range=bool(((codes >= 0) & (codes < llm.cfg.speech_token_size)).all()),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                k1_launches=launches,
                k1_launches_expected=llm.cfg.qwen.num_layers * (MC_STEPS - 1))


@torch.no_grad()
def multicode_phase(kernels: dict, smi: str) -> dict:
    """The multi-code phoneme LM: (a) mc_small_checks; (b) at full width
    (mc_full_width_lm) one B=1 request, then MC_ROWS ragged rows at B=4,
    MC_STEPS greedy steps each (mc_generate).  Gates: the small stack's
    codes, steps and done flags equal on card and CPU; every full-width run
    takes MC_STEPS steps with no row done, reverts to [B, MC_STEPS - 5, 6]
    codes in range, and launches K1 exactly 24 x (MC_STEPS - 1) times (one
    launch a layer a step at any B) and no other kernel."""
    t_phase = time.perf_counter()
    small = mc_small_checks()
    t0 = time.perf_counter()
    llm = mc_full_width_lm()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    runs, launches = {}, {}
    for name, rows, seed in (("b1", MC_ROWS[:1], 51), ("b4_ragged", MC_ROWS, 52)):
        for mod in kernels.values():
            mod.launches = 0
        runs[name] = mc_generate(llm, rows, kernels["lm_decode_attention"], seed)
        launches[name] = {k: mod.launches for k, mod in kernels.items()}
    cfg = llm.cfg
    del llm
    torch.cuda.empty_cache()
    res = {"phase": "multicode", "card": smi, "small_fp32": small,
           "config": f"{MC_RECIPE} (config.recipe_config) bf16, greedy, packed cache",
           "codebooks": cfg.codebooknum, "ids_a_codebook": cfg.max_id,
           "fusion_layers": cfg.src_attn_layers, "setup_s": setup_s, "runs": runs,
           "launches": launches, "phase_s": time.perf_counter() - t_phase}
    emit(res)
    gates = [small["codes_equal"], small["steps_equal"], small["done_equal"],
             small["steps"] > 1]
    for name, r in runs.items():
        B = len(r["rows"])
        gates += [r["steps"] == MC_STEPS, not any(r["done"]), r["codes_in_range"],
                  r["reverted_shape"] == [B, MC_STEPS - cfg.codebooknum + 1, cfg.codebooknum],
                  r["k1_launches"] == r["k1_launches_expected"],
                  all(v == 0 for k, v in launches[name].items() if k != "lm_decode_attention")]
    if not all(gates):
        raise AssertionError(f"multicode phase failed: {gates} {res}")
    return res


# ---- train: the LM's and the flow's training path ---------------------------

TRAIN_RECIPE = "cosyvoice2/conf/cosyvoice2.yaml"
TRAIN_ROWS, TRAIN_TEXT, TRAIN_SPEECH, TRAIN_ROW_LEN = 8, 40, 250, 2048
TRAIN_FLOW_TOKENS, TRAIN_FLOW_MEL = 250, 500
TRAIN_UPDATES = 3           # applied updates a configuration (accum_grad micro-steps each)
TRAIN_LOSS_REL_TOL, TRAIN_GNORM_REL_TOL = 1e-4, 1e-3
TRAIN_SEED = 1986
# tests/test_train_cli.py's small widths (the port's tests hold them to JAX)
TRAIN_SMALL = {
    "qwen2lm": {"llm_input_size": 32, "llm_output_size": 32, "speech_token_size": 128,
                "qwen": {"vocab_size": 300, "hidden_size": 32, "num_layers": 1,
                         "num_heads": 4, "num_kv_heads": 2, "head_dim": 8,
                         "intermediate_size": 64}},
    "flow": {"input_size": 32, "output_size": 20, "spk_embed_dim": 512, "vocab_size": 128,
             "encoder": {"dim": 32, "heads": 2, "linear_units": 48, "num_blocks": 1,
                         "input_size": 32, "dropout_rate": 0.1,
                         "attention_dropout_rate": 0.1},
             "estimator": {"in_channels": 80, "out_channels": 20, "causal": True,
                           "channels": [16], "n_blocks": 1, "num_mid_blocks": 1,
                           "num_heads": 2, "attention_head_dim": 8},
             "cfm": {"noise_frames": 2000}},
}


def train_lm_batch(vocab: int, speech_vocab: int, rng, rows: int, text: int, speech: int,
                   row_len: int = 0, eos: int = 0) -> dict:
    """`rows` seeded (text, speech) examples as an unpacked LM batch, or
    packed into rows of row_len (train/packing.py)."""
    from cosyvoice_tpu_torch.train.packing import pack_llm_examples

    exs = [(rng.integers(0, vocab, text), rng.integers(0, speech_vocab, speech))
           for _ in range(rows)]
    if row_len:
        packed = pack_llm_examples(exs, row_len, eos_token=eos)
        packed.pop("n_tokens")
        return packed
    return {"text_token": np.stack([t for t, _ in exs]), "text_token_len": np.full(rows, text),
            "speech_token": np.stack([s for _, s in exs]),
            "speech_token_len": np.full(rows, speech)}


def train_flow_batch(cfg, rng, rows: int, tokens: int, mel: int) -> dict:
    return {"speech_token": rng.integers(0, cfg.vocab_size, (rows, tokens)),
            "speech_token_len": np.full(rows, tokens),
            "speech_feat": rng.standard_normal((rows, mel, cfg.output_size)).astype(np.float32),
            "speech_feat_len": np.full(rows, mel),
            "embedding": rng.standard_normal((rows, cfg.spk_embed_dim)).astype(np.float32)}


def train_small_checks() -> dict:
    """The small LM and flow (TRAIN_SMALL, the flow's encoder dropout on)
    trained 3 steps on the card and on the CPU from one seeded init, each
    step's generator a CPU one (the same dropout masks and flow draws on
    both devices): each step's loss within TRAIN_LOSS_REL_TOL relative."""
    from cosyvoice_tpu_torch.config import build_model
    from cosyvoice_tpu_torch.train import optim
    from cosyvoice_tpu_torch.train import step as tstep

    res = {}
    for kind, loss_fn in (("qwen2lm", tstep.llm_loss_fn), ("flow", tstep.flow_loss_fn)):
        runs = {}
        for dev in ("cuda", "cpu"):
            torch.manual_seed(15)
            model, cfg = build_model(kind, TRAIN_SMALL[kind])
            model.to(dev)
            tx, _ = optim.make_optimizer("adam", 1e-3, "warmuplr", {"warmup_steps": 3},
                                         grad_clip=1.0)
            st, fn = tstep.make_train_state(model, tx), tstep.make_train_step(loss_fn, tx)
            rng, out = np.random.default_rng(16), []
            for i in range(3):
                b = (train_lm_batch(300, 128, rng, 3, 6, 9) if kind == "qwen2lm"
                     else train_flow_batch(cfg, rng, 3, 10, 20))
                st, m = fn(st, tstep.to_device(b, dev), tstep.step_generator(15, i, "cpu"))
                out.append([m["loss"].item(), m["grad_norm"].item()])
            runs[dev] = out
        rel = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(runs["cuda"], runs["cpu"]))
        res[kind] = {"loss_grad_norm_cuda": runs["cuda"], "loss_grad_norm_cpu": runs["cpu"],
                     "max_loss_rel_err": rel, "tol": TRAIN_LOSS_REL_TOL,
                     "ok": rel <= TRAIN_LOSS_REL_TOL}
    return res


def set_lm_route(llm, **fields) -> None:
    """Switch the Qwen2 body's training route (block_attention, remat) in
    place: the config the body and each layer read."""
    cfg = dataclasses.replace(llm.body.cfg, **fields)
    llm.body.cfg = cfg
    for layer in llm.body.layers:
        layer.cfg = cfg


def train_run(model, init: dict, loss_fn, batches: list, train_conf: dict, items: int) -> dict:
    """TRAIN_UPDATES applied updates (accum_grad micro-steps each) of the
    recipe's optimizer from `init`, micro-step i on batches[i % 2]:
    s a micro-step (median; also apart, the median of the micro-steps that
    only accumulate and of those that apply the update), items / s, loss
    and grad_norm a micro-step, the applied updates and the peak memory
    (also the largest peak of an accumulating micro-step: its forward and
    backward without the optimizer's update)."""
    from cosyvoice_tpu_torch.train import optim
    from cosyvoice_tpu_torch.train import step as tstep

    model.load_state_dict(init)
    tx, _ = optim.make_optimizer(
        train_conf["optim"], train_conf["lr"], train_conf["scheduler"],
        train_conf["scheduler_conf"], grad_clip=train_conf["grad_clip"],
        accum_grad=train_conf["accum_grad"])
    st, fn = tstep.make_train_state(model, tx), tstep.make_train_step(loss_fn, tx)
    k = train_conf["accum_grad"]
    secs, peaks, losses, norms = [], [], [], []
    for i in range(TRAIN_UPDATES * k):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        st, m = fn(st, batches[i % 2], tstep.step_generator(TRAIN_SEED, i, "cuda"))
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        secs.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
    med = float(np.median(secs))
    apply = [i % k == k - 1 for i in range(len(secs))]
    res = {"s_per_micro_step": med, "items_per_s": items / med, "micro_step_s": secs,
           "accumulate_s": float(np.median([t for t, a in zip(secs, apply) if not a])),
           "apply_s": float(np.median([t for t, a in zip(secs, apply) if a])),
           "loss": losses, "grad_norm": norms,
           "applied_updates": optim.applied_updates(st.opt_state), "peak_gib": max(peaks),
           "accumulate_peak_gib": max(p for p, a in zip(peaks, apply) if not a)}
    del st
    torch.cuda.empty_cache()
    return res


def rel_errs(a: list, b: list) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def attention_yardstick(batch: dict, cfg) -> dict:
    """Attention forward + backward over the packed rows' block-diagonal
    bias at the body's widths (q [2, 14, 2048, 64], k / v [2, 2, 2048, 64]),
    fp32, CUDA events, the median of 5 after 2 warm-ups: block_attention,
    the naive attention it replaces, and SDPA (enable_gqa, the float bias
    as its mask; a yardstick only, the port trains on block_attention);
    the peak memory of each and their outputs' distance."""
    from cosyvoice_tpu_torch.ops.block_attention import block_attention, naive_attention
    from cosyvoice_tpu_torch.ops.masks import NEG_INF

    seg = torch.as_tensor(batch["seg"], device="cuda")
    B, N = seg.shape
    causal = torch.ones(N, N, dtype=torch.bool, device="cuda").tril()
    keep = causal[None] & (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] > 0)
    bias = torch.where(keep, 0.0, NEG_INF)[:, None]
    H, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(7)
    q = torch.randn(B, H, N, D, generator=g, device="cuda", requires_grad=True)
    k, v = (torch.randn(B, KH, N, D, generator=g, device="cuda", requires_grad=True)
            for _ in range(2))
    dout = torch.randn(B, H, N, D, generator=g, device="cuda")
    scale = D ** -0.5
    fns = {"block_attention": lambda: block_attention(q, k, v, bias, scale, cfg.attention_block),
           "naive": lambda: naive_attention(q, k, v, bias, scale),
           "sdpa": lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=scale,
                                                          enable_gqa=True)}
    res, outs = {}, {}
    for name, fn in fns.items():
        def fwd_bwd():
            out = fn()
            torch.autograd.grad(out, (q, k, v), dout)
            return out
        for _ in range(2):
            fwd_bwd()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        times = []
        for _ in range(5):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            outs[name] = fwd_bwd().detach()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        res[name] = {"fwd_bwd_ms": float(np.median(times)),
                     "peak_extra_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30}
    live = keep.any(-1)[:, None, :, None]
    for name in ("naive", "sdpa"):
        res[name]["max_abs_diff_to_block"] = float(
            ((outs[name] - outs["block_attention"]).abs() * live).max())
    return {"shape": {"q": [B, H, N, D], "kv": [B, KH, N, D]}, **res}


def train_cli_drive() -> dict:
    """`python -m cosyvoice_tpu_torch.bin.train` on the card (its default
    device) over a seeded jsonl corpus of 6 inline 0.65 s utterances at the
    small LM widths (TRAIN_SMALL): one epoch, then a second run that
    resumes from its checkpoint.  Both write under build/ (deleted after):
    seconds a run, the logged steps (must be 1..4), every value finite,
    the newest checkpoint at step 4."""
    import os
    import shutil
    import tempfile

    from cosyvoice_tpu_torch.train.checkpoint import latest_step

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="train_cli_", dir=root)
    try:
        rng = np.random.default_rng(7)
        corpus = os.path.join(tmp, "data.jsonl")
        with open(corpus, "w") as f:
            for i in range(6):
                f.write(json.dumps({
                    "utt": f"u{i}", "text": "hello world", "sample_rate": 24000,
                    "speech": (rng.standard_normal(15600) * 0.1).round(5).tolist(),
                    "speech_token": rng.integers(0, 100, 30).tolist(),
                    "embedding": rng.standard_normal(512).round(5).tolist()}) + "\n")
        lst = os.path.join(tmp, "train.list")
        with open(lst, "w") as f:
            f.write(corpus + "\n")
        conf = {"llm": dict(TRAIN_SMALL["qwen2lm"], kind="qwen2lm"),
                "data": {"filter": {"max_length": 99999, "token_max_length": 300},
                         "fbank": {"n_fft": 192, "hop": 48, "n_mels": 20},
                         "max_frames_in_batch": 1000, "shuffle_buf": 4, "sort_buf": 2},
                "train_conf": {"lr": 0.0001, "log_interval": 1,
                               "scheduler_conf": {"warmup_steps": 10}}}
        cfg = os.path.join(tmp, "conf.yaml")
        with open(cfg, "w") as f:      # one flow mapping a section (the recipes' YAML subset)
            f.writelines(f"{k}: {json.dumps(v)}\n" for k, v in conf.items())
        model_dir = os.path.join(tmp, "exp")
        runs = []
        for _ in range(2):
            t0 = time.perf_counter()
            out = subprocess.run([sys.executable, "-m", "cosyvoice_tpu_torch.bin.train",
                                  "--config", cfg, "--model", "llm", "--train_data", lst,
                                  "--model_dir", model_dir, "--epochs", "1"],
                                 cwd=here, capture_output=True, text=True, timeout=300)
            if out.returncode != 0:
                raise AssertionError(f"bin.train failed: {out.stderr[-3000:]}")
            runs.append(time.perf_counter() - t0)
        recs = [json.loads(line) for line in open(os.path.join(model_dir, "metrics.jsonl"))]
        return {"run_s": runs, "steps": [r["step"] for r in recs],
                "loss": [r["loss"] for r in recs],
                "finite": all(np.isfinite(v) for r in recs for k, v in r.items() if k != "tag"),
                "latest_step": latest_step(model_dir)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def train_phase(kernels: dict, smi: str) -> dict:
    """Training on the card: (a) train_small_checks; (b) the recipe's LM
    (examples/tts_vc/cosyvoice2/conf/cosyvoice2.yaml `llm`: the Qwen2-0.5B
    body) in fp32 with its train_conf (adam, warmuplr 2500, clip 5,
    accum_grad 2) on seeded weights and two seeded batches of TRAIN_ROWS
    examples (TRAIN_TEXT text ids, TRAIN_SPEECH speech tokens), TRAIN_UPDATES
    applied updates each: unpacked with naive attention, packed into rows of
    TRAIN_ROW_LEN with naive attention, packed with block_attention, and
    packed with block_attention and remat "all"; (c) attention_yardstick at
    the packed rows; (d) the recipe's flow in fp32 (encoder dropout 0.1 on
    the step's generator) on 8 rows of 250 tokens / 500 mel frames,
    TRAIN_UPDATES applied updates; (e) train_cli_drive.  Gates: the small
    runs' losses card = CPU; at full width every micro-step's loss equal
    packed vs unpacked and block vs naive vs remat (TRAIN_LOSS_REL_TOL) and
    grad_norm block vs naive vs remat (TRAIN_GNORM_REL_TOL); every loss and
    grad_norm finite; TRAIN_UPDATES updates applied in every run; the CLI's
    steps 1..4, finite, resumed at step 2; no kernel launched (the training
    path reaches none: the kernels have no backward)."""
    from cosyvoice_tpu_torch.config import load_config, recipe_config
    from cosyvoice_tpu_torch.config import RECIPES
    from cosyvoice_tpu_torch.models.flow import CausalMaskedDiffWithXvec
    from cosyvoice_tpu_torch.models.llm import Qwen2LM
    from cosyvoice_tpu_torch.train import step as tstep
    from cosyvoice_tpu_torch.train.packing import packed_llm_loss_fn

    t_phase = time.perf_counter()
    for mod in kernels.values():
        mod.launches = 0
    with torch.enable_grad():
        small = train_small_checks()
        train_conf = load_config(RECIPES / TRAIN_RECIPE)["train_conf"]
        cfg = recipe_config(TRAIN_RECIPE, "llm")
        t0 = time.perf_counter()
        with torch.device("cuda"):
            llm = Qwen2LM(cfg)
        rand_init_(llm, 1500)
        init = {k: v.clone() for k, v in llm.state_dict().items()}
        setup_s = time.perf_counter() - t0
        rng = np.random.default_rng(1501)
        ex = [dict(vocab=cfg.qwen.vocab_size, speech_vocab=cfg.speech_token_size,
                   rows=TRAIN_ROWS, text=TRAIN_TEXT, speech=TRAIN_SPEECH) for _ in range(2)]
        seeds = [int(s) for s in rng.integers(0, 2 ** 31, 2)]
        unpacked = [tstep.to_device(train_lm_batch(rng=np.random.default_rng(s), **e), "cuda")
                    for s, e in zip(seeds, ex)]
        packed_np = [train_lm_batch(rng=np.random.default_rng(s), row_len=TRAIN_ROW_LEN,
                                    eos=cfg.eos_token, **e) for s, e in zip(seeds, ex)]
        packed = [tstep.to_device(b, "cuda") for b in packed_np]
        tokens = TRAIN_ROWS * (2 + TRAIN_TEXT + TRAIN_SPEECH)
        lm = {}
        for name, batches, route in (
                ("unpacked_naive", unpacked, {}),
                ("packed_naive", packed, {}),
                ("packed_block", packed, {"block_attention": True}),
                ("packed_block_remat", packed, {"block_attention": True, "remat": True,
                                                "remat_policy": "all"})):
            set_lm_route(llm, **dict({"block_attention": False, "remat": False}, **route))
            fn = packed_llm_loss_fn if batches is packed else tstep.llm_loss_fn
            lm[name] = train_run(llm, init, fn, batches, train_conf, tokens)
        set_lm_route(llm, block_attention=False, remat=False)
        yard = attention_yardstick(packed_np[0], llm.body.cfg)
        del llm, init, unpacked, packed
        torch.cuda.empty_cache()

        fcfg = recipe_config(TRAIN_RECIPE, "flow")
        with torch.device("cuda"):
            flow = CausalMaskedDiffWithXvec(fcfg)
        rand_init_(flow, 1510)
        finit = {k: v.clone() for k, v in flow.state_dict().items()}
        frng = np.random.default_rng(1511)
        fb = [tstep.to_device(train_flow_batch(fcfg, frng, TRAIN_ROWS, TRAIN_FLOW_TOKENS,
                                               TRAIN_FLOW_MEL), "cuda") for _ in range(2)]
        flow_run = train_run(flow, finit, tstep.flow_loss_fn, fb, train_conf,
                             TRAIN_ROWS * TRAIN_FLOW_MEL)
        del flow, finit, fb
        torch.cuda.empty_cache()
    launches = {k: mod.launches for k, mod in kernels.items()}
    cli = train_cli_drive()
    base, pk = lm["unpacked_naive"], lm["packed_naive"]
    checks = {
        "packed_vs_unpacked_loss": rel_errs(pk["loss"], base["loss"]),
        "block_vs_naive_loss": rel_errs(lm["packed_block"]["loss"], pk["loss"]),
        "block_vs_naive_grad_norm": rel_errs(lm["packed_block"]["grad_norm"], pk["grad_norm"]),
        "remat_vs_block_loss": rel_errs(lm["packed_block_remat"]["loss"],
                                        lm["packed_block"]["loss"]),
        "remat_vs_block_grad_norm": rel_errs(lm["packed_block_remat"]["grad_norm"],
                                             lm["packed_block"]["grad_norm"])}
    res = {"phase": "train", "card": smi, "small": small,
           "lm_config": f"{TRAIN_RECIPE} llm (config.recipe_config) fp32, train_conf "
                        f"{train_conf}", "lm_setup_s": setup_s,
           "lm_batch": {"rows": TRAIN_ROWS, "text": TRAIN_TEXT, "speech": TRAIN_SPEECH,
                        "tokens": tokens, "packed_rows": list(packed_np[0]["ids"].shape)},
           "lm": lm, "attention_fwd_bwd": yard,
           "flow_config": f"{TRAIN_RECIPE} flow fp32", "flow_batch": {
               "rows": TRAIN_ROWS, "tokens": TRAIN_FLOW_TOKENS, "mel": TRAIN_FLOW_MEL},
           "flow": flow_run, "checks": checks, "cli": cli, "launches": launches,
           "phase_s": time.perf_counter() - t_phase}
    emit(res)
    runs = list(lm.values()) + [flow_run]
    gates = [all(s["ok"] for s in small.values()),
             checks["packed_vs_unpacked_loss"] <= TRAIN_LOSS_REL_TOL,
             checks["block_vs_naive_loss"] <= TRAIN_LOSS_REL_TOL,
             checks["remat_vs_block_loss"] <= TRAIN_LOSS_REL_TOL,
             checks["block_vs_naive_grad_norm"] <= TRAIN_GNORM_REL_TOL,
             checks["remat_vs_block_grad_norm"] <= TRAIN_GNORM_REL_TOL,
             all(np.isfinite(r["loss"]).all() and np.isfinite(r["grad_norm"]).all()
                 for r in runs),
             all(r["applied_updates"] == TRAIN_UPDATES for r in runs),
             cli["steps"] == [1, 2, 3, 4], cli["finite"], cli["latest_step"] == 4,
             all(v == 0 for v in launches.values())]
    if not all(gates):
        raise AssertionError(f"train phase failed: {gates} {res}")
    return res


# the GAN phase: each vocoder recipe trained at full width against MPD + MRD
GAN_RECIPES = {"hift": "cosyvoice2/conf/cosyvoice2_hift_tts.yaml",
               "bigvgan": "cosyvoice2/conf/cosyvoice2_bigvgan_tts.yaml",
               "vits": "cosyvoice2/conf/cosyvoice2_vits_tts.yaml"}
# (rows, mel frames a row) of each batch: the recipes' dynamic_batch cap of
# 2000 frames (longest x rows), 4 rows of 10 s
GAN_BATCH = {"hift": (4, 500), "bigvgan": (4, 500), "vits": (4, 500)}
# D + G pairs: one warm, then the timed ones.  VITS runs 10: at the recipe's
# lr (adamw 2e-4) its KL first grows from the constructor init, then falls
# below where it started; the JAX package takes the same path
# (tests/vits_kl_path.py at width 256, CPU).  HiFT runs 8: its largest
# log-magnitude climbs ~10 a pair toward exp's fp32 range (~88.7), which it
# passes from the 6th pair; past it the clip's gradient was NaN before
# models/hift.py MAG_LOG_CAP.  BigVGAN runs 2 (6.3 s a pair at the recipe's
# batch; cut from 5 to keep the whole script inside its time)
GAN_PAIRS = {"hift": 8, "bigvgan": 2, "vits": 10}
GAN_SEED = 1986
GAN_SMALL_TOL = 1e-4
# small widths of the three generators (the card-vs-CPU check, and the CLI
# runs here and in tests/test_torch_train_cli.py), MPD + MRD at two small FFTs
GAN_ENC = {"dim": 16, "heads": 2, "linear_units": 16, "num_blocks": 1, "input_size": 16,
           "dropout_rate": 0.1, "attention_dropout_rate": 0.1}
GAN_SMALL = {
    "hift": {"kind": "hift", "base_channels": 16, "nb_harmonics": 1, "f0_cond_channels": 8,
             "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1]],
             "source_resblock_kernel_sizes": [3, 3, 3],
             "source_resblock_dilation_sizes": [[1], [1], [1]]},
    "bigvgan": {"kind": "bigvgan", "vocab_size": 128, "input_size": 16, "output_size": 16,
                "upsample_rates": [8, 5, 3, 2], "upsample_kernel_sizes": [16, 11, 7, 2],
                "upsample_initial_channel": 16, "resblock_kernel_sizes": [3],
                "resblock_dilation_sizes": [[1]], "speaker_embedding_dim": 512,
                "encoder1": dict(GAN_ENC), "encoder2": dict(GAN_ENC)},
    "vits": {"kind": "vits", "n_vocab": 128, "inter_channels": 8, "hidden_channels": 16,
             "filter_channels": 16, "n_heads": 2, "n_layers": 1,
             "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1]],
             "upsample_rates": [8, 5, 3, 2], "upsample_initial_channel": 16,
             "upsample_kernel_sizes": [16, 11, 7, 2], "segment_size": 2400,
             "up_enc1": dict(GAN_ENC), "up_enc2": dict(GAN_ENC)},
}
GAN_SMALL_CONF = {"gan_conf": {"discriminator": "multiple",
                               "discriminator_conf": {"periods": [2, 3], "fft_sizes": [256, 128]}},
                  "data": {"sample_rate": 24000},
                  "train_conf": {"optim": "adam", "lr": 1e-4, "lr_d": 1e-4}}


def gan_batch(name: str, cfg, rows: int, frames: int, seed: int, device: str) -> dict:
    """A seeded vocoder batch on `device`, as the pipeline's stages make it
    (data/pipeline.py compute_fbank, compute_f0, padding(gan=True)): rows of
    voiced audio (two harmonics of a row's f0 in 100-220 Hz, a slow
    tremolo, noise) of frames x 480 samples, their log-mels, HiFT's pitch
    targets (autocorr_f0 on the card, interpolated to the mel length), 25
    Hz speech tokens and 512-d speaker vectors."""
    from cosyvoice_tpu_torch.ops.f0 import autocorr_f0, interp_to_len
    from cosyvoice_tpu_torch.ops.mel import log_mel_spectrogram

    g = torch.Generator(device=device).manual_seed(seed)
    S = frames * 480
    t = torch.arange(S, device=device) / 24000.0
    f0 = 100.0 + 120.0 * torch.rand(rows, 1, generator=g, device=device)
    speech = (0.3 * torch.sin(2 * math.pi * f0 * t) * (1 + 0.3 * torch.sin(2 * math.pi * 3 * t))
              + 0.1 * torch.sin(4 * math.pi * f0 * t)
              + 0.01 * torch.randn(rows, S, generator=g, device=device))
    batch = {"speech": speech, "speech_len": torch.full((rows,), S, device=device),
             "speech_feat": log_mel_spectrogram(speech).transpose(1, 2).contiguous(),
             "speech_feat_len": torch.full((rows,), frames, device=device)}
    if name == "hift":
        batch["pitch_feat"] = torch.stack([interp_to_len(autocorr_f0(w), frames)
                                           for w in speech])
    else:
        vocab = cfg.vocab_size if name == "bigvgan" else cfg.n_vocab
        batch["speech_token"] = torch.randint(0, vocab, (rows, frames // 2), generator=g,
                                              device=device)
        batch["speech_token_len"] = torch.full((rows,), frames // 2, device=device)
        batch["embedding"] = torch.randn(rows, 512, generator=g, device=device)
    return batch


def gan_pairs(g_step, d_step, gs, ds, batch: dict, pairs: int, gen_device: str) -> dict:
    """`pairs` D + G step pairs on one batch, pair i's two steps each on a
    generator of (GAN_SEED, i) on gen_device: s a pair, every loss term."""
    from cosyvoice_tpu_torch.train.step import step_generator

    secs, terms = [], []
    for i in range(pairs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ds, dm = d_step(ds, gs.model, batch, step_generator(GAN_SEED, i, gen_device))
        gs, gm = g_step(gs, (ds.model, batch), step_generator(GAN_SEED, i, gen_device))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        terms.append({**{f"d_{k}": v.item() for k, v in dm.items()},
                      **{k: v.item() for k, v in gm.items()}})
    return {"pair_s": secs, "terms": terms}


def gan_small_checks() -> dict:
    """The three generators at small widths (GAN_SMALL) against MPD + MRD:
    two D + G step pairs on the card and on the CPU from one init, every
    step's generator a CPU one (the same noise, dropout masks and VITS
    segment on both): every loss term and grad_norm of both pairs within
    GAN_SMALL_TOL relative, of at least 1e-2.  The largest reading on an H100 was 6.6e-5, VITS's
    second-pair TPR term: adam's first update moves an element whose
    gradient sign is set by rounding by +-lr on one device and not the
    other, and the TPR selection (dr < dg + median) is discontinuous."""
    from cosyvoice_tpu_torch.bin.train import gan_training
    from cosyvoice_tpu_torch.config import build_model

    res = {}
    for name, sec in GAN_SMALL.items():
        sec = dict(sec)
        kind = sec.pop("kind")
        runs = {}
        for dev in ("cuda", "cpu"):
            torch.manual_seed(16)
            model, cfg = build_model(kind, sec)
            steps = gan_training(name, model.to(dev), dict(GAN_SMALL_CONF), dev)
            batch = gan_batch(name, cfg, 2, 16, 17, "cpu")
            batch = {k: v.to(dev) for k, v in batch.items()}
            runs[dev] = gan_pairs(*steps, batch, 2, "cpu")["terms"]
        err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-2)
                  for a, b in zip(runs["cuda"], runs["cpu"]) for k in b)
        res[name] = {"terms_cuda": runs["cuda"], "terms_cpu": runs["cpu"],
                     "max_rel_err": err, "tol": GAN_SMALL_TOL, "ok": err <= GAN_SMALL_TOL}
    return res


def write_gan_cli_inputs(dirpath: str) -> tuple:
    """The GAN CLI runs' inputs under `dirpath`: a seeded jsonl corpus of
    two 0.32 s utterances at 24 kHz (8 speech tokens, a 512-d embedding;
    one a batch, so an epoch is two D + G pairs) with its shard list, and a
    recipe a vocoder (GAN_SMALL's section against GAN_SMALL_CONF's MPD +
    MRD, one flow mapping a section) -> (shard list, {name: recipe})."""
    import os

    rng = np.random.default_rng(7)
    corpus = os.path.join(dirpath, "data.jsonl")
    with open(corpus, "w") as f:
        for i in range(2):
            f.write(json.dumps({
                "utt": f"u{i}", "text": "hello", "sample_rate": 24000,
                "speech": (rng.standard_normal(7680) * 0.1).round(5).tolist(),
                "speech_token": rng.integers(0, 100, 8).tolist(),
                "embedding": rng.standard_normal(512).round(5).tolist()}) + "\n")
    lst = os.path.join(dirpath, "train.list")
    with open(lst, "w") as f:
        f.write(corpus + "\n")
    recipes = {}
    for name, sec in GAN_SMALL.items():
        conf = dict(GAN_SMALL_CONF, **{name: sec}, data={
            "filter": {"max_length": 40960, "token_max_length": 300},
            "max_frames_in_batch": 20},
            train_conf={"lr": 1e-4, "lr_d": 1e-4, "log_interval": 1})
        recipes[name] = os.path.join(dirpath, f"{name}.yaml")
        with open(recipes[name], "w") as f:
            f.writelines(f"{k}: {json.dumps(v)}\n" for k, v in conf.items())
    return lst, recipes


def gan_cli_drive() -> dict:
    """`python -m cosyvoice_tpu_torch.bin.train --model hift|bigvgan|vits`
    on the card (its default device), one process: write_gan_cli_inputs's
    corpus and recipes, one epoch each, under build/ (deleted after):
    seconds, the logged steps (must be 1, 2), every value finite, both
    nets' checkpoints at step 2."""
    import os
    import shutil
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="gan_cli_", dir=os.path.join(here, "build"))
    try:
        lst, recipes = write_gan_cli_inputs(tmp)
        calls = [["--config", cfg, "--model", name, "--train_data", lst,
                  "--model_dir", os.path.join(tmp, f"exp_{name}"), "--epochs", "1"]
                 for name, cfg in recipes.items()]
        script = ("import sys, json\nfrom cosyvoice_tpu_torch.bin.train import main\n"
                  "for argv in json.loads(sys.argv[1]):\n    main(argv)\n")
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", script, json.dumps(calls)], cwd=here,
                             capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            raise AssertionError(f"bin.train (GAN) failed: {out.stderr[-3000:]}")
        from cosyvoice_tpu_torch.train.checkpoint import latest_step

        res = {"run_s": time.perf_counter() - t0}
        for name in GAN_SMALL:
            d = os.path.join(tmp, f"exp_{name}")
            recs = [json.loads(line) for line in open(os.path.join(d, "metrics.jsonl"))]
            res[name] = {"steps": [r["step"] for r in recs], "loss": [r["loss"] for r in recs],
                         "finite": all(np.isfinite(v) for r in recs for k, v in r.items()
                                       if k != "tag"),
                         "latest_step": [latest_step(d), latest_step(d + "_disc")]}
        return res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def gan_phase(kernels: dict, smi: str) -> dict:
    """GAN training of the three vocoders on the card, TF32 off, no kernel
    (a training forward reaches none: BigVGAN's recipe keeps
    use_pallas_act off, and K7 refuses gradients): (a) gan_small_checks;
    (b) each recipe of GAN_RECIPES at its full width with its gan_conf
    discriminator (multiple: MPD + MRD at the default periods and FFTs) and
    train_conf optimizers (bin/train.gan_training), on the port's seeded
    constructor init and a seeded batch of the recipe's size (GAN_BATCH,
    gan_batch): GAN_PAIRS D + G pairs: s a pair (median after the warm
    one), peak memory, every loss term; (c) gan_cli_drive.  Gates: the
    small runs' losses card = CPU; every full-width loss term finite;
    VITS's KL at its last pair below its first; the CLI's steps 1, 2,
    finite, both nets at step 2; no kernel launched."""
    from cosyvoice_tpu_torch.bin.train import gan_training
    from cosyvoice_tpu_torch.config import RECIPES, build_model, load_config

    t_phase = time.perf_counter()
    for mod in kernels.values():
        mod.launches = 0
    with torch.enable_grad():
        small = gan_small_checks()
        full = {}
        for name, recipe in GAN_RECIPES.items():
            conf = load_config(RECIPES / recipe)
            sec = dict(conf[name])
            kind = sec.pop("kind")
            t0 = time.perf_counter()
            torch.manual_seed(GAN_SEED)
            model, cfg = build_model(kind, sec, device="cuda")
            steps = gan_training(name, model, conf, "cuda")
            rows, frames = GAN_BATCH[name]
            batch = gan_batch(name, cfg, rows, frames, GAN_SEED + 1, "cuda")
            setup_s = time.perf_counter() - t0
            logmag = []
            if name == "hift":          # the largest log-magnitude of each forward
                nb = cfg.istft_n_fft // 2 + 1
                model.conv_post.register_forward_hook(
                    lambda m, i, o: logmag.append(o[..., :nb].detach().amax()))
            torch.cuda.reset_peak_memory_stats()
            run = gan_pairs(*steps, batch, GAN_PAIRS[name], "cuda")
            full[name] = {
                "recipe": recipe, "rows": rows, "mel_frames": frames,
                "audio_s": rows * frames * 480 / 24000.0,
                "generator_params": sum(p.numel() for p in model.parameters()),
                "discriminator_params": sum(p.numel() for p in steps[3].model.parameters()),
                "setup_s": setup_s, "warm_pair_s": run["pair_s"][0],
                "pair_s_median": float(np.median(run["pair_s"][1:])), "pair_s": run["pair_s"],
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "terms": run["terms"],
                "finite": all(np.isfinite(v) for t in run["terms"] for v in t.values())}
            if logmag:                  # two forwards a pair: the D step's, the G step's
                full[name]["max_log_magnitude_g_step"] = [float(v) for v in logmag[1::2]]
            del model, steps, batch
            torch.cuda.empty_cache()
    launches = {k: mod.launches for k, mod in kernels.items()}
    cli = gan_cli_drive()
    res = {"phase": "gan", "card": smi, "small": small, "full_width": full, "cli": cli,
           "launches": launches, "phase_s": time.perf_counter() - t_phase}
    emit(res)
    kl = [t["loss_kl"] for t in full["vits"]["terms"]]
    gates = [all(s["ok"] for s in small.values()), all(r["finite"] for r in full.values()),
             kl[-1] < kl[0],
             all(cli[n]["steps"] == [1, 2] and cli[n]["finite"]
                 and cli[n]["latest_step"] == [2, 2] for n in GAN_SMALL),
             all(v == 0 for v in launches.values())]
    if not all(gates):
        raise AssertionError(f"gan phase failed: {gates} {res}")
    return res


DEPLOY_SEED = 1600
DEPLOY_TEXT = "The port serves the voice it was trained on."


def deploy_phase(kernels: dict, smi: str) -> dict:
    """Finetune -> average -> assemble -> serve on the card, with the
    port's CLIs at full width (LMConfig, FlowConfig, HiFTConfig on seeded
    random weights; CAMPPlus and the S3 tokenizer as the checkpoint phase
    builds them): (1) train/checkpoint.save_checkpoint of each net, the same
    state at steps 1 and 2 (its adam state too, as the trainer writes it);
    (2) `bin/average_model.py` over each; (3) `bin/ckpt_resave.py --out_dir`
    over the three, the ONNX and tokenizer files of a directory written
    straight from the modules (write_model_dir), and a --ref_audio speaker;
    (4) from_pretrained (fp16, int8, greedy, K1's fused cache update, K3's
    fused LayerNorm) of the assembled directory and of the direct one: one
    zero-shot request each from a 3 s 16 kHz prompt (CKPT_CAP-token cap): load
    and request seconds, RTF, peak memory, every kernel's launches (all
    counts set to 0 just before the request, read just after); (5)
    `bin/export_serving_lm.py` of the averaged LM.  Gates: the tokens of
    the two requests equal (an average of equal states is exact), finite
    wavs, K1, K2 and K3 launched in the assembled directory's request, the
    registered speaker listed, the export's model.safetensors read back by
    utils/safetensors_io equal to rehead_state_dict of the averaged LM.
    Everything lives under build/ and is deleted at the end."""
    import os
    import shutil
    import tempfile
    import wave

    from cosyvoice_tpu_torch.bin import average_model, ckpt_resave, export_serving_lm
    from cosyvoice_tpu_torch.models.campplus import CAMPPlusConfig
    from cosyvoice_tpu_torch.models.flow import CausalMaskedDiffWithXvec, FlowConfig
    from cosyvoice_tpu_torch.models.hift import HiFTConfig, HiFTGenerator
    from cosyvoice_tpu_torch.models.llm import LMConfig, Qwen2LM, SamplingConfig
    from cosyvoice_tpu_torch.models.s3tokenizer import S3Config
    from cosyvoice_tpu_torch.runtime.api import from_pretrained
    from cosyvoice_tpu_torch.train import optim
    from cosyvoice_tpu_torch.train import step as tstep
    from cosyvoice_tpu_torch.train.checkpoint import save_checkpoint
    from cosyvoice_tpu_torch.utils.safetensors_io import load_safetensors

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="deploy_", dir=os.path.join(here, "build"))
    k3 = ("lm_decode_attention", "dit_attention", "fused_layer_norm")
    steps = {}

    def timed_step(key, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[key] = time.perf_counter() - t0
        return out

    try:
        def build():
            with torch.device("cuda"):
                nets = {"llm": Qwen2LM(LMConfig()), "flow": CausalMaskedDiffWithXvec(FlowConfig()),
                        "hift": HiFTGenerator(HiFTConfig())}
            for i, m in enumerate(nets.values()):
                rand_init_(m, DEPLOY_SEED + i)
            camp, s3 = seeded_frontend_models(CAMPPlusConfig(), S3Config(), DEPLOY_SEED + 10)
            write_model_dir(os.path.join(tmp, "direct"), *nets.values(), camp, s3, 192,
                            DEPLOY_SEED + 20)
            return nets
        nets = timed_step("build_and_direct_dir_s", build)

        def checkpoints():
            tx, _ = optim.make_optimizer("adam", 1e-4, "constantlr", {})
            for stem, m in nets.items():
                st = tstep.make_train_state(m, tx)
                # one checkpoint a net (cut from two for the script's time:
                # both held the same weights)
                st.step = 1
                save_checkpoint(os.path.join(tmp, f"exp_{stem}"), st, 1)
        timed_step("save_checkpoints_s", checkpoints)
        del nets
        torch.cuda.empty_cache()
        avg = {stem: os.path.join(tmp, f"{stem}.pt") for stem in ("llm", "flow", "hift")}
        timed_step("average_model_s", lambda: [average_model.main(
            ["--src_dir", os.path.join(tmp, f"exp_{stem}"), "--dst_path", path, "--num", "1"])
            for stem, path in avg.items()])
        ref = os.path.join(tmp, "spk1.wav")
        with wave.open(ref, "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(16000)
            f.writeframes((prompt_16k(4.0, DEPLOY_SEED + 30) * 32767).astype("<i2").tobytes())
        direct, deployed = os.path.join(tmp, "direct"), os.path.join(tmp, "deploy")
        timed_step("ckpt_resave_s", lambda: ckpt_resave.main([
            "--out_dir", deployed, "--llm_pt", avg["llm"], "--flow_pt", avg["flow"],
            "--hift_pt", avg["hift"], "--campplus_onnx", os.path.join(direct, "campplus.onnx"),
            "--s3_onnx", os.path.join(direct, "speech_tokenizer_v2.onnx"),
            "--tokenizer_dir", os.path.join(direct, "CosyVoice-BlankEN"),
            "--ref_audio", f"spk1={ref}"]))

        lm_cfg = LMConfig()
        lm_cfg = dataclasses.replace(lm_cfg, sampling=SamplingConfig(method="greedy"),
                                     qwen=dataclasses.replace(lm_cfg.qwen,
                                                              fused_cache_update=True))
        fcfg = FlowConfig()
        fcfg = dataclasses.replace(fcfg, estimator=dataclasses.replace(fcfg.estimator,
                                                                       fused_norm=True))
        prompt = prompt_16k(3.0, DEPLOY_SEED + 31)

        def serve(d: str) -> dict:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            cv = from_pretrained(d, fp16=True, quant="int8", max_decode_tokens=CKPT_CAP,
                                 lm_cfg=lm_cfg, flow_cfg=fcfg, device="cuda")
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            tokens = recording_generate(cv)
            for mod in kernels.values():
                mod.launches = 0
            t0 = time.perf_counter()
            wav = np.concatenate([o["tts_speech"] for o in cv.inference_zero_shot(
                DEPLOY_TEXT, "A short prompt.", prompt, gen=torch.Generator().manual_seed(0))])
            torch.cuda.synchronize()
            latency = time.perf_counter() - t0
            launches = {k: mod.launches for k, mod in kernels.items()}
            out = {"load_s": load_s, "latency_s": latency, "tokens": tokens[-1],
                   "speech_tokens": len(tokens[-1]), "wav_samples": len(wav),
                   "finite": bool(np.isfinite(wav).all()),
                   "rtf": latency / max(len(wav) / cv.sample_rate, 1e-9),
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                   "launches": launches,
                   "speakers": cv.list_available_spks()}
            del cv
            torch.cuda.empty_cache()
            return out

        served = timed_step("serve_assembled_s", lambda: serve(deployed))
        ref_run = timed_step("serve_direct_s", lambda: serve(direct))
        hf = os.path.join(tmp, "llm_hf")
        timed_step("export_serving_lm_s", lambda: export_serving_lm.main(
            ["--ckpt", avg["llm"], "--out", hf]))
        got = load_safetensors(os.path.join(hf, "model.safetensors"))
        want, hf_cfg = export_serving_lm.rehead_state_dict(
            torch.load(avg["llm"], map_location="cpu", weights_only=True), LMConfig())
        export_equal = set(got) == set(want) and all(torch.equal(got[k], want[k])
                                                     for k in want)
        with open(os.path.join(hf, "config.json")) as f:
            hf_conf = json.load(f)
        files_gb = {f: os.path.getsize(os.path.join(deployed, f)) / 2**30
                    for f in sorted(os.listdir(deployed))
                    if os.path.isfile(os.path.join(deployed, f))}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tokens_equal = bool(np.array_equal(served["tokens"], ref_run["tokens"]))
    for r in (served, ref_run):
        r.pop("tokens")
    res = {"phase": "deploy", "card": smi, "steps_s": steps, "assembled": served,
           "direct": ref_run, "tokens_equal": tokens_equal, "files_gib": files_gb,
           "export": {"tensors": len(got), "equal": export_equal,
                      "vocab_size": hf_conf["vocab_size"],
                      "architectures": hf_conf["architectures"]},
           "launches": served["launches"], "phase_s": time.perf_counter() - t_phase}
    emit(res)
    gates = [tokens_equal, served["finite"], ref_run["finite"], served["speech_tokens"] > 0,
             all(served["launches"][k] > 0 for k in k3), "spk1" in served["speakers"],
             export_equal, hf_conf["vocab_size"] % 64 == 0]
    if not all(gates):
        raise AssertionError(f"deploy phase failed: {gates} {res}")
    return res


# the pho_train phase: the production phoneme LM (cosyvoice2_pho.yaml) trained
# through bin/train.py on a speaker-JSON corpus labelled online, and a LoRA
# finetune of cosyvoice2.yaml's LM merged by ckpt_resave into a served model
PHO_TRAIN_RECIPE = "cosyvoice2/conf/cosyvoice2_pho.yaml"
PHO_TRAIN_SEED = 1700
PHO_TRAIN_SPEAKERS, PHO_TRAIN_UTTS, PHO_TRAIN_SECONDS = 4, 4, (3.0, 8.0)
PHO_TRAIN_BATCH = 8                    # the recipe's static batch of 8 (its train_conf comment)
LORA_UTTS, LORA_BATCH, LORA_SECONDS = 8, 2, 2.0
PHO_TRAIN_SMALL_TOL = 1e-4             # card vs CPU, relative, fp32 with TF32 off
PHO_TRAIN_SMALL = {
    "llm_input_size": 32, "llm_output_size": 32, "speech_token_size": 24, "spk_embed_dim": 16,
    "phoneme": {"text_token_size": 8, "text_token_dim": 16, "text_tone_size": 16,
                "text_tone_dim": 8, "text_lang_size": 2, "text_lang_dim": 4,
                "text_prsd_size": 6, "text_prsd_dim": 4},
    "encoder": {"input_size": 32, "dim": 32, "heads": 2, "linear_units": 48, "num_blocks": 1,
                "dropout_rate": 0.0, "attention_dropout_rate": 0.0},
    "fusion_heads": 2, "fusion_ffn": 48,
    "qwen": {"vocab_size": 300, "hidden_size": 32, "num_layers": 1, "num_heads": 4,
             "num_kv_heads": 2, "head_dim": 8, "intermediate_size": 64}}


def write_wav_file(path: str, wav: np.ndarray, sr: int) -> None:
    import wave

    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes((np.clip(wav, -1, 1) * 32767).astype("<i2").tobytes())


def write_pho_corpus(dirpath: str, cfg, seed: int) -> tuple:
    """A seeded speaker-JSON corpus under `dirpath`: PHO_TRAIN_SPEAKERS
    speakers x PHO_TRAIN_UTTS utterances of PHO_TRAIN_SECONDS (uniform) at
    24 kHz, each with ASCII text, a phoneme string (a phoneme every ~0.1 s
    from a table the size of the recipe's phoneme table, tones 1-5 and 14,
    #1 / #2 / #3 marks) and MFA durations that sum to the clip -> (shard
    list, phoneme table path)."""
    import os

    rng = np.random.default_rng(seed)
    size = cfg.phoneme.text_token_size
    names = ["sil"] + [f"p{chr(97 + i // 26)}{chr(97 + i % 26)}" for i in range(size - 1)]
    table = os.path.join(dirpath, "phoneme2id.json")
    with open(table, "w") as f:
        json.dump({n: i for i, n in enumerate(names)}, f)
    corpus, sr = {}, 24000
    for s in range(PHO_TRAIN_SPEAKERS):
        utts = []
        for u in range(PHO_TRAIN_UTTS):
            seconds = float(rng.uniform(*PHO_TRAIN_SECONDS))
            n = int(seconds * 10)
            pho, dur = ["sil"], []
            for i in range(n):
                tone = 14 if rng.random() < 0.1 else int(rng.integers(1, 6))
                pho.append(f"{names[int(rng.integers(1, size))]}{tone}")
                if i % 4 == 3 and i < n - 1:
                    pho.append(("#1", "#2", "#3")[int(rng.integers(0, 3))])
            pho.append("sil")
            w = rng.uniform(0.5, 1.5, len(pho)) * np.array([p[0] != "#" for p in pho])
            dur = (seconds * w / w.sum()).tolist()
            t = np.arange(int(seconds * sr)) / sr
            f0 = 120 + 40 * s
            wav = (0.3 * np.sin(2 * np.pi * f0 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
                   + 0.05 * rng.standard_normal(len(t))).astype(np.float32)
            path = os.path.join(dirpath, f"s{s}_u{u}.wav")
            write_wav_file(path, wav, sr)
            words = ["".join(chr(97 + int(c)) for c in rng.integers(0, 26, int(k)))
                     for k in rng.integers(2, 7, max(n // 3, 1))]
            utts.append({"utt": f"s{s}_u{u}", "wav": path, "duration": seconds,
                         "text": " ".join(words)[:180], "phoneme": " ".join(pho),
                         "durations": dur})
        corpus[f"spk{s}"] = utts
    path = os.path.join(dirpath, "corpus.json")
    with open(path, "w") as f:
        json.dump(corpus, f)
    lst = os.path.join(dirpath, "train.list")
    with open(lst, "w") as f:
        f.write(path + "\n")
    return lst, table


def write_recipe(path: str, conf: dict) -> None:
    """One flow mapping a section (the recipes' YAML subset)."""
    with open(path, "w") as f:
        f.writelines(f"{k}: {json.dumps(v)}\n" for k, v in conf.items())


def pho_train_small_checks() -> dict:
    """(c) At small widths (PHO_TRAIN_SMALL; dropout 0), one seeded init on the
    card and on the CPU, every draw on a CPU generator: the Src2 phoneme
    LM's training loss and acc; the multi-code LM's focal loss (3
    codebooks, 2 fusion layers); TransformerLMPhonemeWithSpk's loss with
    VICReg in a training step (the lam phase's small speaker stack, the
    SpecAugment masks and both posterior samples pinned): each within
    PHO_TRAIN_SMALL_TOL relative, card against CPU."""
    import copy

    from cosyvoice_tpu_torch.config import build_model
    from cosyvoice_tpu_torch.nn.dropout import dropout_generator
    from cosyvoice_tpu_torch.models.llm_v1_phoneme import spec_augment_masks

    rng = np.random.default_rng(1701)
    cfg_pho = PHO_TRAIN_SMALL["phoneme"]
    pho = np.stack([rng.integers(0, cfg_pho[f"text_{t}_size"], (3, 9))
                    for t in ("token", "tone", "lang", "prsd")], axis=-1)
    base = {"text_token": rng.integers(0, 300, (3, 6)), "text_token_len": np.array([6, 3, 5]),
            "pho_token": pho, "pho_token_len": np.array([9, 4, 7]),
            "speech_token_len": np.array([8, 5, 6]),
            "embedding": rng.standard_normal((3, 16)).astype(np.float32)}
    args = ("text_token", "text_token_len", "pho_token", "pho_token_len", "speech_token",
            "speech_token_len", "embedding")
    cases = {"qwen2lm_phoneme_src2": dict(base, speech_token=rng.integers(0, 24, (3, 8))),
             "qwen2lm_phoneme_multicode": dict(base, speech_token=rng.integers(0, 24, (3, 8, 3)))}
    res = {}
    for kind, b in cases.items():
        sec = dict(PHO_TRAIN_SMALL, **({"codebooknum": 3, "src_attn_layers": 2}
                                 if kind.endswith("multicode") else {}))
        torch.manual_seed(1702)
        model, _ = build_model(kind, sec)
        out = {}
        for dev, m in (("cuda", copy.deepcopy(model).to("cuda")), ("cpu", model)):
            t = {k: torch.as_tensor(np.asarray(b[k])).to(dev) for k in args}
            r = m.eval()(*(t[k] for k in args))
            out[dev] = {k: float(v.detach()) for k, v in r.items()}
        res[kind] = out
    # TransformerLMPhonemeWithSpk: the lam phase's small stack, a training step
    _, _, ws = lam_small_models("cpu")
    cfg = ws.lm.cfg
    fb = torch.randn(2, 150, 80, generator=torch.Generator().manual_seed(1703))
    spec = torch.randn(2, 120, ws.speaker_embed.cfg.spec_channels,
                       generator=torch.Generator().manual_seed(1704)).abs()
    spec_len = torch.tensor([120, 90])
    g = torch.Generator().manual_seed(1705)
    inter = ws.speaker_embed.cfg.inter_channels
    aug = {"fbank_masks": spec_augment_masks(2, 150, 80, g),
           "spec_masks": spec_augment_masks(2, 120, spec.shape[2], g),
           "noise": torch.randn(2, 120, inter, generator=g)}
    noise = torch.randn(2, 120, inter, generator=g)
    pho_v1 = np.stack([rng.integers(0, getattr(cfg.phoneme, f"text_{t}_size"), (2, 9))
                       for t in ("token", "tone", "lang", "prsd")], axis=-1)
    ins = [torch.as_tensor(pho_v1), torch.tensor([9, 6]),
           torch.as_tensor(rng.integers(0, cfg.speech_token_size, (2, 7))), torch.tensor([7, 5]),
           fb, spec, spec_len]
    out = {}
    for dev, m in (("cuda", copy.deepcopy(ws).to("cuda")), ("cpu", ws)):
        m.train()
        mv = lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x  # noqa: E731
        with dropout_generator(torch.Generator().manual_seed(0)):
            r = m(*(mv(x) for x in ins), noise=mv(noise),
                  aug={k: (mv(v) if k == "noise" else [tuple(mv(a) for a in t) for t in v])
                       for k, v in aug.items()})
        out[dev] = {k: float(v.detach()) for k, v in r.items()}
    res["transformer_lm_phoneme_with_spk"] = out
    for r in res.values():
        r["max_rel_err"] = max(abs(r["cuda"][k] - r["cpu"][k]) / max(abs(r["cpu"][k]), 1e-3)
                               for k in r["cpu"])
        r["tol"] = PHO_TRAIN_SMALL_TOL
        r["ok"] = r["max_rel_err"] <= PHO_TRAIN_SMALL_TOL and all(
            math.isfinite(v) for v in r["cpu"].values())
    return res


def pho_train_full(tmp: str, kernels: dict) -> dict:
    """(a) cosyvoice2_pho.yaml through the port's recipe registry at full
    width (Qwen2LMPhonemeSrc2 on the Qwen2-0.5B body, the 6 x 1024
    phoneme conformer, the 512-d speaker section), random init, fp32:
    `bin/train.py --model llm --data_format spk_json` in this process, its
    labellers the full-width S3TokenizerV2 and SpeakerEmbedding at random
    init (no --s3_ckpt / --spk_ckpt), over write_pho_corpus's 16
    utterances in static batches of PHO_TRAIN_BATCH (the recipe's
    accum_grad 2): one epoch (2 micro-steps), then a second run that
    resumes from its checkpoint (2 more).  Timed: each micro-step and each
    batch's labels (torch.cuda.synchronize on both sides), peak memory."""
    import os

    from cosyvoice_tpu_torch.bin import train as train_cli
    from cosyvoice_tpu_torch.config import RECIPES, load_config, recipe_config
    from cosyvoice_tpu_torch.train import online_codec
    from cosyvoice_tpu_torch.train.checkpoint import latest_step

    cfg = recipe_config(PHO_TRAIN_RECIPE, "llm")
    lst, table = write_pho_corpus(tmp, cfg, PHO_TRAIN_SEED)
    conf = load_config(RECIPES / PHO_TRAIN_RECIPE)
    recipe = {"llm": conf["llm"], "speaker": conf["speaker"],
              "data": dict(conf["data"], phoneme_dict=table, batch_type="static",
                           batch_size=PHO_TRAIN_BATCH),
              "train_conf": dict(conf["train_conf"], log_interval=1)}
    path = os.path.join(tmp, "pho.yaml")
    write_recipe(path, recipe)
    model_dir = os.path.join(tmp, "exp_pho")
    label_s, step_s, sums = [], [], {}
    orig_label, orig_make = online_codec.OnlineCodecLabeler.label_batch, train_cli.make_train_step

    def timed_label(self, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_label(self, *a, **k)
        torch.cuda.synchronize()
        label_s.append(time.perf_counter() - t0)
        return out

    def timed_make(loss_fn, tx, mesh=None):
        step = orig_make(loss_fn, tx, mesh)

        def run(state, batch, gen):
            if not sums:
                sums["before"] = {k: float(p.double().sum()) for k, p in state.params.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(state, batch, gen)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            sums["after"] = {k: float(p.double().sum()) for k, p in state.params.items()}
            return out
        return run

    argv = ["--config", path, "--model", "llm", "--train_data", lst, "--model_dir", model_dir,
            "--data_format", "spk_json", "--epochs", "1"]
    online_codec.OnlineCodecLabeler.label_batch = timed_label
    train_cli.make_train_step = timed_make
    runs, latest = [], []
    torch.cuda.reset_peak_memory_stats()
    try:
        for _ in range(2):
            t0 = time.perf_counter()
            train_cli.main(argv)
            runs.append(time.perf_counter() - t0)
            latest.append(latest_step(model_dir))
            torch.cuda.empty_cache()
    finally:
        online_codec.OnlineCodecLabeler.label_batch = orig_label
        train_cli.make_train_step = orig_make
    recs = [json.loads(line) for line in open(os.path.join(model_dir, "metrics.jsonl"))]
    changed = sum(sums["before"][k] != sums["after"][k] for k in sums["before"])
    return {"recipe": PHO_TRAIN_RECIPE, "kind": conf["llm"]["kind"], "corpus": (lst, table),
            "batch": PHO_TRAIN_BATCH, "utterances": PHO_TRAIN_SPEAKERS * PHO_TRAIN_UTTS,
            "params": len(sums["before"]), "params_changed": changed,
            "run_s": runs, "micro_step_s": step_s, "label_s": label_s,
            "micro_step_s_median": float(np.median(step_s)),
            "label_s_median": float(np.median(label_s)),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "steps": [r["step"] for r in recs], "loss": [r["loss"] for r in recs],
            "acc": [r["acc"] for r in recs], "grad_norm": [r["grad_norm"] for r in recs],
            "finite": all(math.isfinite(r[k]) for r in recs for k in ("loss", "grad_norm")),
            "latest_step_by_run": latest}


def pho_lora_serve(tmp: str, kernels: dict) -> dict:
    """(b) cosyvoice2.yaml's qwen2lm at full width, `bin/train.py --lora`
    (r 8, alpha 16, q/k/v/o: the CLI's defaults; the recipe's train_conf
    with its lr held constant) in this process over a seeded jsonl corpus
    (LORA_UTTS utterances of LORA_SECONDS, static batches of LORA_BATCH: 4
    micro-steps); the base LM the CLI built is
    kept, with a copy of its weights from before the first step; then
    `bin/ckpt_resave.py --lora_npz` merges lora.npz into the base's llm.pt
    beside a full-width flow, HiFT, CAMPPlus and S3 tokenizer (seeded) in
    a model directory (every adapted weight moved, every other one kept);
    from_pretrained (fp16, int8, greedy, K1's fused
    cache update, K3's fused LayerNorm) serves one zero-shot request from
    it, every kernel's count set to 0 just before and read just after; the
    same request again with the served LM swapped for an in-memory
    merge_lora of the base and lora.npz, quantized as from_pretrained
    does."""
    import os

    from cosyvoice_tpu_torch.bin import ckpt_resave
    from cosyvoice_tpu_torch.bin import train as train_cli
    from cosyvoice_tpu_torch.config import RECIPES, load_config
    from cosyvoice_tpu_torch.models.campplus import CAMPPlusConfig
    from cosyvoice_tpu_torch.models.flow import CausalMaskedDiffWithXvec, FlowConfig
    from cosyvoice_tpu_torch.models.hift import HiFTConfig, HiFTGenerator
    from cosyvoice_tpu_torch.models.llm import LMConfig, Qwen2LM, SamplingConfig
    from cosyvoice_tpu_torch.models.s3tokenizer import S3Config
    from cosyvoice_tpu_torch.runtime.api import from_pretrained
    from cosyvoice_tpu_torch.train import lora as lora_mod
    from cosyvoice_tpu_torch.utils.quant import quantize_qwen_int8

    conf = load_config(RECIPES / TRAIN_RECIPE)
    rng = np.random.default_rng(PHO_TRAIN_SEED + 1)
    corpus = os.path.join(tmp, "lora.jsonl")
    with open(corpus, "w") as f:
        for i in range(LORA_UTTS):
            wav = os.path.join(tmp, f"lora_{i}.wav")
            write_wav_file(wav, lam_wav(LORA_SECONDS, PHO_TRAIN_SEED + 10 + i), 24000)
            f.write(json.dumps({"utt": f"l{i}", "text": f"the voice number {i} speaks",
                                "speech": wav, "speech_token": rng.integers(
                                    0, 6561, int(25 * LORA_SECONDS)).tolist()}) + "\n")
    lst = os.path.join(tmp, "lora.list")
    with open(lst, "w") as f:
        f.write(corpus + "\n")
    path = os.path.join(tmp, "lora.yaml")
    # the recipe's lr held constant (its warmup of 2500 steps would leave b
    # near 0 over 4 micro-steps, and the merge below the weights' rounding)
    write_recipe(path, {"llm": conf["llm"],
                        "data": dict(conf["data"], batch_type="static", batch_size=LORA_BATCH),
                        "train_conf": dict(conf["train_conf"], log_interval=1,
                                           scheduler="constantlr",
                                           scheduler_conf={"warmup_steps": 0})})
    model_dir = os.path.join(tmp, "exp_lora")
    held, orig_init = {}, lora_mod.init_lora

    def init_lora(model, cfg, gen):
        held["model"] = model
        held["before"] = {k: v.detach().clone() for k, v in model.state_dict().items()}
        return orig_init(model, cfg, gen)

    lora_mod.init_lora = init_lora
    try:
        t0 = time.perf_counter()
        train_cli.main(["--config", path, "--model", "llm", "--lora", "--train_data", lst,
                        "--model_dir", model_dir, "--epochs", "1"])
        train_s = time.perf_counter() - t0
    finally:
        lora_mod.init_lora = orig_init
    train_launches = {k: mod.launches for k, mod in kernels.items()}
    base = held.pop("model")
    base_equal = all(torch.equal(v, held["before"][k]) for k, v in base.state_dict().items())
    del held
    npz = os.path.join(model_dir, "lora.npz")
    data = np.load(npz)
    b_keys = [k for k in data.files if k.endswith(".lora_B")]
    b_max = float(max(np.abs(data[k]).max() for k in b_keys))
    recs = [json.loads(line) for line in open(os.path.join(model_dir, "metrics.jsonl"))]

    t0 = time.perf_counter()
    with torch.device("cuda"):
        flow, hift = CausalMaskedDiffWithXvec(FlowConfig()), HiFTGenerator(HiFTConfig())
    rand_init_(flow, PHO_TRAIN_SEED + 2)
    rand_init_(hift, PHO_TRAIN_SEED + 3)
    camp, s3 = seeded_frontend_models(CAMPPlusConfig(), S3Config(), PHO_TRAIN_SEED + 4)
    direct, deployed = os.path.join(tmp, "base_dir"), os.path.join(tmp, "lora_dir")
    write_model_dir(direct, base, flow, hift, camp, s3, 192, PHO_TRAIN_SEED + 5)
    del flow, hift, camp, s3
    dir_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt_resave.main([
        "--out_dir", deployed, "--llm_pt", os.path.join(direct, "llm.pt"),
        "--flow_pt", os.path.join(direct, "flow.pt"), "--hift_pt", os.path.join(direct, "hift.pt"),
        "--campplus_onnx", os.path.join(direct, "campplus.onnx"),
        "--s3_onnx", os.path.join(direct, "speech_tokenizer_v2.onnx"),
        "--tokenizer_dir", os.path.join(direct, "CosyVoice-BlankEN"),
        "--lora_npz", npz, "--lora_r", "8", "--lora_alpha", "16"])
    resave_s = time.perf_counter() - t0
    before = torch.load(os.path.join(direct, "llm.pt"), map_location="cpu", weights_only=True,
                        mmap=True)
    after = torch.load(os.path.join(deployed, "llm.pt"), map_location="cpu", weights_only=True,
                       mmap=True)
    adapted = {k.rsplit(".lora_", 1)[0] for k in data.files}
    merge_moved = sum(not torch.equal(after[k], before[k]) for k in adapted)
    others_kept = all(torch.equal(after[k], before[k]) for k in after if k not in adapted)
    del before, after

    lm_cfg = LMConfig()
    lm_cfg = dataclasses.replace(lm_cfg, sampling=SamplingConfig(method="greedy"),
                                 qwen=dataclasses.replace(lm_cfg.qwen, fused_cache_update=True))
    fcfg = FlowConfig()
    fcfg = dataclasses.replace(fcfg, estimator=dataclasses.replace(fcfg.estimator,
                                                                   fused_norm=True))
    t0 = time.perf_counter()
    cv = from_pretrained(deployed, fp16=True, quant="int8", max_decode_tokens=CKPT_CAP,
                         lm_cfg=lm_cfg, flow_cfg=fcfg, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    tokens = recording_generate(cv)
    prompt = prompt_16k(3.0, PHO_TRAIN_SEED + 6)

    def request():
        t0 = time.perf_counter()
        wav = np.concatenate([o["tts_speech"] for o in cv.inference_zero_shot(
            DEPLOY_TEXT, "A short prompt.", prompt, gen=torch.Generator().manual_seed(0))])
        torch.cuda.synchronize()
        return wav, time.perf_counter() - t0

    for mod in kernels.values():
        mod.launches = 0
    wav, latency = request()
    launches = {k: mod.launches for k, mod in kernels.items()}
    overlay = lora_mod.read_lora_npz(npz)
    merged = lora_mod.merge_lora({k: v.detach() for k, v in base.state_dict().items()},
                                 overlay, lora_mod.LoRAConfig(r=8, alpha=16))
    del base
    with torch.device("cuda"):
        llm = Qwen2LM(lm_cfg)
    llm.load_state_dict(merged, strict=True)
    del merged
    state = quantize_qwen_int8(llm.to(torch.bfloat16).state_dict())
    with torch.device("cuda"):
        llm = Qwen2LM(dataclasses.replace(lm_cfg, qwen=dataclasses.replace(lm_cfg.qwen,
                                                                           quant="int8")))
    llm.load_state_dict(state, strict=True, assign=True)
    weights_equal = all(torch.equal(v, cv.model.llm.state_dict()[k]) for k, v in state.items())
    cv.model.llm = llm.eval()
    wav2, _ = request()
    out = {"recipe": TRAIN_RECIPE, "lora": {"r": 8, "alpha": 16, "adapters": len(b_keys)},
           "train_s": train_s, "steps": [r["step"] for r in recs],
           "loss": [r["loss"] for r in recs],
           "finite": all(math.isfinite(r[k]) for r in recs for k in ("loss", "grad_norm")),
           "base_bit_identical": base_equal, "lora_b_max_abs": b_max,
           "merged_weights_moved": merge_moved, "other_weights_kept": others_kept,
           "model_dir_s": dir_s, "ckpt_resave_s": resave_s, "load_s": load_s,
           "latency_s": latency, "speech_tokens": len(tokens[0]),
           "rtf": latency / max(len(wav) / cv.sample_rate, 1e-9),
           "finite_wav": bool(np.isfinite(wav).all()),
           "tokens_equal_in_memory_merge": bool(np.array_equal(tokens[0], tokens[1])),
           "served_weights_equal_in_memory_merge": weights_equal,
           "wav_max_abs_diff": float(np.abs(wav - wav2).max()) if len(wav) == len(wav2)
           else None, "train_launches": train_launches, "launches": launches}
    del cv, llm, state
    torch.cuda.empty_cache()
    return out


def pho_cli_drive(tmp: str, table: str, pho_list: str) -> dict:
    """(d) The rest of what the train CLI trains, on the card at small
    widths, in this process, one epoch each: qwen2lm_phoneme and
    qwen2lm_phoneme_src over (a)'s speaker-JSON corpus (the recipe's
    phoneme tables at PHO_TRAIN_SMALL's widths, a 1-layer S3 labeller and
    the lam phase's small speaker section); transformer_lm over parquet
    shards (WAV bytes, 25 Hz tokens, utt / spk embeddings); the flow with
    lora_conf.enabled (linear_q / linear_v) over a jsonl corpus.  Each:
    its steps, every value finite, a checkpoint; the flow's lora.npz."""
    import io
    import os
    import wave

    from cosyvoice_tpu_torch.bin import train as train_cli
    from cosyvoice_tpu_torch.data.parquet_io import write_parquet
    from cosyvoice_tpu_torch.train.checkpoint import latest_step

    rng = np.random.default_rng(PHO_TRAIN_SEED + 7)
    small_data = {"fbank": {"n_fft": 192, "hop": 48, "n_mels": 20},
                  "filter": {"max_length": 99999, "token_max_length": 300},
                  "shuffle_buf": 8, "sort_buf": 4}
    train_conf = {"lr": 1e-3, "log_interval": 1, "scheduler": "constantlr",
                  "scheduler_conf": {"warmup_steps": 0}}
    pho = dict(PHO_TRAIN_SMALL, spk_embed_dim=LAM_SMALL_SPK["speaker_emb_dim"],
               phoneme=dict(PHO_TRAIN_SMALL["phoneme"], text_token_size=140))
    speaker = dict(LAM_SMALL_SPK, kind="speaker_embedding", campplus=LAM_SMALL_CAMP)
    s3 = {"kind": "s3tokenizer", "dim": 32, "heads": 2, "layers": 1, "fsq_dim": 2}
    runs = {}
    for kind in ("qwen2lm_phoneme", "qwen2lm_phoneme_src"):
        runs[kind] = ({"llm": dict(pho, kind=kind), "speaker": speaker, "s3": s3,
                       "data": dict(small_data, phoneme_dict=table, batch_size=8),
                       "train_conf": train_conf}, pho_list, ["--data_format", "spk_json"])

    def wav_bytes(wav):
        buf = io.BytesIO()
        with wave.open(buf, "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(24000)
            f.writeframes((np.clip(wav, -1, 1) * 32767).astype("<i2").tobytes())
        return buf.getvalue()

    rows = [{"utt": f"p{i}", "text": "hello world", "audio_data": wav_bytes(lam_wav(1.0, 80 + i)),
             "speech_token": rng.integers(0, 100, 25).tolist(),
             "utt_embedding": rng.standard_normal(512).tolist(),
             "spk_embedding": rng.standard_normal(512).tolist()} for i in range(4)]
    shard = os.path.join(tmp, "shard0.parquet")
    write_parquet(shard, rows, "snappy")
    parquet_list = os.path.join(tmp, "parquet.list")
    with open(parquet_list, "w") as f:
        f.write(shard + "\n")
    v1 = {"kind": "transformer_lm", "text_encoder_input_size": 16, "llm_input_size": 32,
          "llm_output_size": 32, "text_token_size": 300, "speech_token_size": 128,
          "spk_embed_dim": 512,
          "text_encoder": {"dim": 32, "heads": 2, "linear_units": 48, "num_blocks": 1,
                           "input_size": 16, "static_chunk_size": 1},
          "llm": {"dim": 32, "heads": 2, "linear_units": 48, "num_blocks": 1, "input_size": 32,
                  "static_chunk_size": 1, "input_layer": "linear_legacy",
                  "activation": "relu"}}
    runs["transformer_lm"] = ({"llm": v1, "data": dict(small_data, max_frames_in_batch=1000),
                               "train_conf": train_conf}, parquet_list,
                              ["--data_format", "parquet"])
    corpus = os.path.join(tmp, "flow.jsonl")
    with open(corpus, "w") as f:
        for i in range(4):
            f.write(json.dumps({"utt": f"f{i}", "text": "hello", "sample_rate": 24000,
                                "speech": lam_wav(0.65, 90 + i).round(5).tolist(),
                                "speech_token": rng.integers(0, 100, 30).tolist(),
                                "embedding": rng.standard_normal(512).round(5).tolist()})
                    + "\n")
    flow_list = os.path.join(tmp, "flow.list")
    with open(flow_list, "w") as f:
        f.write(corpus + "\n")
    runs["flow_lora"] = ({"flow": dict(TRAIN_SMALL["flow"], kind="flow"),
                          "lora_conf": {"enabled": True, "rank": 4, "alpha": 8,
                                        "patterns": ["linear_q", "linear_v"]},
                          "data": dict(small_data, max_frames_in_batch=1000),
                          "train_conf": train_conf}, flow_list, [])
    res = {}
    for name, (conf, lst, extra) in runs.items():
        path = os.path.join(tmp, f"{name}.yaml")
        write_recipe(path, conf)
        model_dir = os.path.join(tmp, f"exp_{name}")
        model = "flow" if name == "flow_lora" else "llm"
        t0 = time.perf_counter()
        train_cli.main(["--config", path, "--model", model, "--train_data", lst,
                        "--model_dir", model_dir, "--epochs", "1", *extra])
        recs = [json.loads(line) for line in open(os.path.join(model_dir, "metrics.jsonl"))]
        res[name] = {"run_s": time.perf_counter() - t0, "steps": [r["step"] for r in recs],
                     "loss": [r["loss"] for r in recs],
                     "finite": bool(recs) and all(math.isfinite(v) for r in recs
                                                  for k, v in r.items() if k != "tag"),
                     "latest_step": latest_step(model_dir)}
        npz = os.path.join(model_dir, "lora.npz")
        if os.path.exists(npz):
            data = np.load(npz)
            res[name]["lora_b_max_abs"] = float(max(np.abs(data[k]).max() for k in data.files
                                                    if k.endswith(".lora_B")))
    return res


def pho_train_phase(kernels: dict, smi: str) -> dict:
    """Phoneme-LM training on online labels, and LoRA through to a served
    model: (a) pho_train_full; (b) pho_lora_serve; (c) pho_train_small_checks;
    (d) pho_cli_drive.  Everything lives under build/ and is deleted at the
    end.  Gates: every
    loss and grad_norm finite; the phoneme LM's parameters changed; its
    steps 1..4, the first run's checkpoint at step 2, resumed to step 4; no
    kernel launched in (a) or in (b)'s training; the LoRA base weights
    bit-identical after training and lora.npz's b nonzero; the served
    request's greedy tokens equal those of the in-memory merge; K1, K2 and
    K3 each launched in the served request; (c) within PHO_TRAIN_SMALL_TOL;
    (d) every run finite with a checkpoint at its last step, the flow's
    lora.npz b nonzero, no kernel launched."""
    import os
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="pho_train_", dir=os.path.join(here, "build"))
    try:
        with torch.enable_grad():
            for mod in kernels.values():
                mod.launches = 0
            t0 = time.perf_counter()
            full = pho_train_full(tmp, kernels)
            full["phase_s"] = time.perf_counter() - t0
            full["launches"] = {k: mod.launches for k, mod in kernels.items()}
            for mod in kernels.values():
                mod.launches = 0
            t0 = time.perf_counter()
            served = pho_lora_serve(tmp, kernels)
            served["phase_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            small = pho_train_small_checks()
            small_s = time.perf_counter() - t0
            for mod in kernels.values():
                mod.launches = 0
            lst, table = full.pop("corpus")
            cli = pho_cli_drive(tmp, table, lst)
            cli_launches = {k: mod.launches for k, mod in kernels.items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # the training forwards reach no kernel; the served request reaches K1-K3
    launches = {k: full["launches"][k] + served["train_launches"][k] + served["launches"][k]
                + cli_launches[k] for k in kernels}
    res = {"phase": "pho_train", "card": smi, "phoneme_lm": full, "lora_serve": served,
           "small": small, "small_s": small_s, "cli": cli, "cli_launches": cli_launches,
           "launches": launches, "phase_s": time.perf_counter() - t_phase}
    emit(res)
    k3 = ("lm_decode_attention", "dit_attention", "fused_layer_norm")
    gates = [full["finite"], full["params_changed"] > 0, full["steps"] == [1, 2, 3, 4],
             full["latest_step_by_run"] == [2, 4],
             all(v == 0 for v in full["launches"].values()),
             all(v == 0 for v in served["train_launches"].values()),
             served["finite"], served["steps"] == [1, 2, 3, 4], served["base_bit_identical"],
             served["lora_b_max_abs"] > 0, served["tokens_equal_in_memory_merge"],
             served["merged_weights_moved"] == served["lora"]["adapters"],
             served["other_weights_kept"],
             served["served_weights_equal_in_memory_merge"],
             served["speech_tokens"] > 0, served["finite_wav"],
             all(served["launches"][k] > 0 for k in k3),
             all(r["ok"] for r in small.values()),
             all(r["finite"] and r["latest_step"] == len(r["steps"]) > 0 for r in cli.values()),
             cli["flow_lora"].get("lora_b_max_abs", 0.0) > 0,
             all(v == 0 for v in cli_launches.values())]
    if not all(gates):
        raise AssertionError(f"pho_train phase failed: {gates} {res}")
    return res


# ---- export: the estimator as ExportedPrograms; one request under trace ----

EXPORT_LENGTHS = (100, 200, 500)     # bin/export_aot.py's (the JAX CLI's)
EXPORT_BLOCK_LENGTH = 200            # with fused_block (padded to 256: K4's route)


@torch.no_grad()
def export_phase(flow, kernels: dict, smi: str) -> dict:
    """bin/export_aot.export_flow_estimator on the main path's bf16 serving
    estimator (K2 + K3) at EXPORT_LENGTHS, then with fused_block (K4) at
    EXPORT_BLOCK_LENGTH: each .pt2 reloaded and held to the eager estimator
    at the export bar (rtol 1e-2, atol 1e-5; inside export_flow_estimator).
    Here each reloaded program runs once more on other seeded inputs with
    the launch counts at 0 (K2 and K3, or K4, must launch inside it) and is
    timed beside the eager estimator (time_ms)."""
    import os
    import shutil
    import tempfile

    from cosyvoice_tpu_torch.bin import export_aot

    names = ("dit_attention", "fused_layer_norm", "dit_block")
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="export_", dir=os.path.join(here, "build"))
    est = flow.decoder.estimator
    runs = []
    try:
        for T, block in [(T, False) for T in EXPORT_LENGTHS] + [(EXPORT_BLOCK_LENGTH, True)]:
            set_fused_block(flow, block)
            rep = export_aot.export_flow_estimator(
                flow, os.path.join(tmp, "block" if block else "plain"), lengths=(T,),
                seed=T)[T]
            program = rep.pop("program")
            args = export_aot.estimator_inputs(est, T, seed=T + 1)
            for k in names:
                kernels[k].launches = 0
            out = program(*args)
            torch.cuda.synchronize()
            launches = {k: kernels[k].launches for k in names}
            runs.append({"T": T, "fused_block": block, "export_s": rep["export_s"],
                         "save_load_s": rep["save_load_s"], "max_abs_err": rep["max_abs_err"],
                         "file_mb": os.path.getsize(rep["path"]) / 2 ** 20, "ops": rep["ops"],
                         "launches": launches, "finite": bool(torch.isfinite(out).all()),
                         "exported_ms": time_ms(lambda: program(*args), iters=5),
                         "eager_ms": time_ms(lambda: est(*args), iters=5)})
            del program
    finally:
        set_fused_block(flow, False)
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {k: sum(r["launches"][k] for r in runs) for k in names}
    res = {"phase": "export", "card": smi, "runs": runs, "launches": launches,
           "bar": {"rtol": export_aot.RTOL, "atol": export_aot.ATOL}}
    emit(res)
    gates = [all(r["finite"] for r in runs),
             all(r["launches"]["dit_attention"] > 0 and r["launches"]["fused_layer_norm"] > 0
                 for r in runs if not r["fused_block"]),
             all(r["launches"]["dit_block"] > 0 for r in runs if r["fused_block"])]
    if not all(gates):
        raise AssertionError(f"export phase failed: {gates} {res}")
    return res


def busy_share(trace_path: str, window_s: float, top: int = 15) -> dict:
    """Device kernel time of a Chrome trace (the union of its kernel events'
    intervals, so overlapping streams count once) over a window, and the
    `top` kernels by device time (kernel_key names)."""
    events = [e for e in json.load(open(trace_path))["traceEvents"]
              if e.get("cat") == "kernel" and "dur" in e]
    by_name: dict = {}
    for e in events:
        ms, n = by_name.get(kernel_key(e["name"]), (0.0, 0))
        by_name[kernel_key(e["name"])] = (ms + e["dur"] / 1e3, n + 1)
    busy, end = 0.0, -math.inf
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"kernel_events": len(events), "kernel_ms": busy / 1e3,
            "window_ms": window_s * 1e3, "busy_share": busy / 1e3 / (window_s * 1e3),
            "top": [{"name": k, "ms": ms, "calls": n} for k, (ms, n) in
                    sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]]}


@torch.no_grad()
def trace_phase(res_main: dict, smi: str) -> dict:
    """The main path's last request again (its seed and text, the main
    path's decode cap) under utils/profiling.trace: the trace file's device
    busy share of the request's wall and its kernels by device time
    (busy_share), beside the main path's own untraced run of the same
    request (the profiler's host overhead lengthens the traced window)."""
    import os
    import shutil
    import tempfile

    from cosyvoice_tpu_torch.utils.profiling import trace

    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="trace_", dir=os.path.join(here, "build"))
    i = len(res_main["texts"]) - 1
    untraced = res_main["requests"][i]
    try:
        with trace(tmp):
            traced = res_main["request"](i, res_main["texts"][i])
        t0 = time.perf_counter()
        (path,) = [os.path.join(tmp, f) for f in os.listdir(tmp)]
        share = busy_share(path, traced["latency_s"])
        share["trace_mb"] = os.path.getsize(path) / 2 ** 20
        share["read_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res = {"phase": "trace", "card": smi, "cap": res_main["model"].max_decode_tokens,
           "traced": traced, "untraced": untraced, **share,
           "busy_share_of_untraced_wall": share["kernel_ms"] / (untraced["latency_s"] * 1e3)}
    emit(res)
    if not share["kernel_events"] or traced["speech_tokens"] != untraced["speech_tokens"]:
        raise AssertionError(f"trace phase failed: {res}")
    return res


# the flow stage's A/B: a 75-token prompt (150 mel frames) and 200 new tokens,
# the main path's shape
FLOW_STAGE_TOKENS = (75, 200)


@torch.no_grad()
def flow_stage(label: str, runs: int = 20) -> dict:
    """The main path's flow stage alone: serving_flow's `flow.inference`
    (the encoder, then 10 Euler steps of the CFG-batched estimator) at
    FLOW_STAGE_TOKENS on seeded inputs, one warm call, then `runs`
    CUDA-synchronised walls -> their median and minimum (ms), and K2's and
    K3's launches a call, printed as one JSON line."""
    from cosyvoice_tpu_torch.ops.kernels import dit_attention as K2
    from cosyvoice_tpu_torch.ops.kernels import fused_norm as K3

    torch.backends.cuda.matmul.allow_tf32 = False
    flow = serving_flow(0).eval()
    rng = np.random.default_rng(0)
    n = sum(FLOW_STAGE_TOKENS)
    dev = torch.device("cuda")
    token = torch.as_tensor(rng.integers(0, flow.cfg.vocab_size, (1, n)), device=dev)
    prompt_feat = torch.as_tensor(rng.standard_normal((1, 2 * FLOW_STAGE_TOKENS[0], 80)) * 0.5,
                                  dtype=torch.float32, device=dev)
    emb = torch.as_tensor(rng.standard_normal((1, flow.cfg.spk_embed_dim)),
                          dtype=torch.float32, device=dev)
    lengths = torch.tensor([n], device=dev)
    call = lambda: flow.inference(token, lengths, prompt_feat, emb)  # noqa: E731
    call()
    K2.launches = K3.launches = 0
    walls = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    res = {"phase": "flow_stage", "label": label, "card": nvidia_smi(),
           "flow_ms_median": float(np.median(walls)), "flow_ms_min": float(np.min(walls)),
           "runs": runs, "k2_per_call": K2.launches / runs, "k3_per_call": K3.launches / runs}
    emit(res)
    return res


def flow_stage_main(argv: list) -> int:
    """`python3 chip_smoke.py --flow-stage TREE [--label L] [--runs N]`:
    flow_stage on the package of the checkout at TREE (its kernels built
    there), so one command times two trees side by side (parent, change,
    change, parent)."""
    import argparse
    import os

    p = argparse.ArgumentParser(prog="chip_smoke.py --flow-stage")
    p.add_argument("tree")
    p.add_argument("--label", default="")
    p.add_argument("--runs", type=int, default=20)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.tree))
    flow_stage(args.label, args.runs)
    return 0


# ---- multi_card: data and tensor parallelism, two ranks on the one card ----

MC_WORLD = 2
MC_SEED = 1800
# the full-width requests' new-text lengths (decode caps 100-200, as the
# batched phase's texts give) and the prompt: 75 speech tokens, 150 mel frames
MC_NEW_TEXT = (5, 7, 9, 10)
MC_PROMPT_TOKENS = 75
MC_CAP = 40                  # the full-width decode cap (all four rows reach it)
# teacher-forced logits of the sharded LM against the one-process LM on the
# same weights (bf16 activations, int8 weights): max |diff| <= MC_LOGITS_REL_TOL
# x max |one-process logits| over every row's valid positions.  Both round
# every intermediate to bf16; under TP each rank's o_proj and down_proj
# partial is rounded to bf16 before the ranks' partials are summed in fp32
# (parallel/collectives.py), one more rounding a projection than the
# one-card product, and 24 layers carry and grow those ulps as they do K6's
# (K6_REL_TOL: 2.6e-2 of max |y| measured across 24 layers), so the bar is K6's.
MC_LOGITS_REL_TOL = 6e-2
# the small fp32 stack: tokens exact, wavs within (atol, rtol) of one process
# (tests/test_parallel.py's bar for a mesh against one device)
MC_SMALL_WAV_TOL = (2e-3, 1e-3)
# the DP training step (fp32, TF32 off) against the one-process step: loss and
# grad_norm relative
MC_TRAIN_REL_TOL = 1e-4
MC_TRAIN_MICRO_STEPS = 2
# the train phase's global batch (TRAIN_ROWS x (TRAIN_TEXT + TRAIN_SPEECH))
# split unevenly: data rank 1's rows keep MC_TRAIN_SHORT of their speech tokens
MC_TRAIN_SHORT = 100
MC_CLUSTER_S = 600           # the ranks' time limit; killed after it


def mc_requests(rng, full: bool) -> list:
    """Seeded zero-shot requests: the full-width stack's (text ids of the
    Qwen2 vocabulary, 4 new-text lengths, a 3 s prompt) or the small stack's."""
    from cosyvoice_tpu_torch.runtime.serving import TTSRequest

    vocab, speech, spk = (151936, 6561, 192) if full else (300, 64, 24)
    reqs = []
    for n in MC_NEW_TEXT:
        p = MC_PROMPT_TOKENS if full else 20
        reqs.append(TTSRequest(
            text_tokens=rng.integers(0, vocab, 4 + n), prompt_text_len=4,
            prompt_speech_tokens=rng.integers(0, speech, p),
            prompt_feat=(rng.standard_normal((2 * p, 80)) * 0.5).astype(np.float32),
            embedding=rng.standard_normal(spk).astype(np.float32)))
    return reqs


def mc_teacher_forced(llm, reqs, tokens, rows: slice) -> torch.Tensor:
    """Logits [rows, N, V] of `llm` over [sos, text, task, prompt speech ++
    tokens] of each row (positions past a row's length zeroed)."""
    B = len(reqs)
    seqs = [np.concatenate([r.prompt_speech_tokens, t]) for r, t in zip(reqs, tokens)]
    Tt = max(len(r.text_tokens) for r in reqs)
    Ts = max(len(s) for s in seqs)
    text, sp = np.zeros((B, Tt), np.int64), np.zeros((B, Ts), np.int64)
    for i, (r, s) in enumerate(zip(reqs, seqs)):
        text[i, :len(r.text_tokens)], sp[i, :len(s)] = r.text_tokens, s
    t = lambda a: torch.as_tensor(a[rows], device="cuda")  # noqa: E731
    tl = np.array([len(r.text_tokens) for r in reqs])
    sl = np.array([len(s) for s in seqs])
    emb, seq_len = llm.prefill_embeds(t(text), t(tl), t(sp), t(sl))
    logits = llm.decode_logits(llm._causal_hidden(emb, seq_len)).float()
    valid = torch.arange(logits.shape[1], device="cuda")[None, :] < seq_len[:, None]
    return torch.where(valid[..., None], logits, 0.0), valid


def mc_counts(kernels: dict) -> dict:
    return {k: mod.launches for k, mod in kernels.items()}


def mc_serve(model, reqs, mesh, kernels: dict, gen_seed: int) -> dict:
    """One BatchedSynthesizer batch (on `mesh`, or one process with None),
    timed, with the kernels' launches: -> wavs, tokens, wall, audio, RTF."""
    from cosyvoice_tpu_torch.runtime.serving import BatchedSynthesizer

    synth = BatchedSynthesizer(model, mesh=mesh)
    seen = {}
    gen_fn = synth.generate

    def generate(requests, gen):
        seen["tokens"] = gen_fn(requests, gen)
        return seen["tokens"]

    synth.generate = generate
    for mod in kernels.values():
        mod.launches = 0
    torch.cuda.synchronize()
    if mesh is not None:
        torch.distributed.barrier()
    t0 = time.perf_counter()
    wavs = synth.synthesize_batch(reqs, gen=torch.Generator().manual_seed(gen_seed))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    audio = sum(len(w) for w in wavs) / 24000.0
    return {"wavs": wavs, "tokens": seen["tokens"][:len(reqs)], "wall_s": wall,
            "audio_s": audio, "rtf": wall / max(audio, 1e-9),
            "launches": mc_counts(kernels)}


def mc_full(rank: int, kernels: dict) -> dict:
    """(a) the full-width stack (int8 LM over the packed cache in bf16, bf16
    flow with K4 blocks, bf16 HiFT) on 4 requests: one process, then DP(2)
    and TP(2) over the two ranks: RTF, greedy token agreement, launches and
    the teacher-forced logits against one process."""
    from cosyvoice_tpu_torch.parallel.mesh import batch_sharding, make_mesh
    from cosyvoice_tpu_torch.runtime.model import CosyVoice2Model

    llm, flow, hift = full_width_stack()
    model = CosyVoice2Model(llm=llm, flow=flow, hift=hift, max_decode_tokens=MC_CAP,
                            device="cuda")
    set_fused_block(flow, True)
    reqs = mc_requests(np.random.default_rng(MC_SEED), full=True)
    mc_serve(model, reqs, None, kernels, 0)                  # warm-up
    one = mc_serve(model, reqs, None, kernels, 0)
    ref, ref_valid = mc_teacher_forced(llm, reqs, one["tokens"], slice(0, len(reqs)))
    out = {"one_process": {k: v for k, v in one.items() if k not in ("wavs", "tokens")},
           "speech_tokens": [len(t) for t in one["tokens"]]}
    for name, shape in (("dp", (2, 1)), ("tp", (1, 2))):
        mesh = make_mesh(*shape)
        run = mc_serve(model, reqs, mesh, kernels, 0)
        rows = batch_sharding(mesh, len(reqs))
        got, _ = mc_teacher_forced(llm, reqs, one["tokens"], rows)
        want, valid = ref[rows], ref_valid[rows]
        agree = float((got.argmax(-1) == want.argmax(-1))[valid].float().mean())
        equal = [bool(np.array_equal(a, b)) for a, b in zip(run["tokens"], one["tokens"])]
        out[name] = {
            "wall_s": run["wall_s"], "audio_s": run["audio_s"], "rtf": run["rtf"],
            "launches": run["launches"], "local_heads": [llm.cfg.qwen.num_heads,
                                                         llm.cfg.qwen.num_kv_heads],
            "logits_max_abs_diff": float((got - want).abs().max()),
            "logits_max_abs": float(want.abs().max()),
            "logits_rel": float((got - want).abs().max() / want.abs().max()),
            "tf_argmax_agreement": agree, "tokens_equal_rows": equal,
            "speech_tokens": [len(t) for t in run["tokens"]],
            "wav_ok": all(np.isfinite(w).all() and w.shape == (len(t) * 2 * 480,)
                          for w, t in zip(run["wavs"], run["tokens"]))}
    del model, llm, flow, hift
    torch.cuda.empty_cache()
    return out


def mc_small(kernels: dict) -> dict:
    """(b) the small fp32 stack on 4 requests: one process, DP(2) and TP(2):
    greedy tokens equal, wavs within MC_SMALL_WAV_TOL."""
    from cosyvoice_tpu_torch.parallel.mesh import make_mesh

    model = small_stack("cuda", max_decode_tokens=60)
    reqs = mc_requests(np.random.default_rng(MC_SEED + 1), full=False)
    one = mc_serve(model, reqs, None, kernels, 1)
    out = {}
    atol, rtol = MC_SMALL_WAV_TOL
    for name, shape in (("dp", (2, 1)), ("tp", (1, 2))):
        run = mc_serve(model, reqs, make_mesh(*shape), kernels, 1)
        errs = [float(np.abs(a - b).max()) if a.shape == b.shape else float("inf")
                for a, b in zip(run["wavs"], one["wavs"])]
        out[name] = {"tokens_equal": all(np.array_equal(a, b) for a, b in
                                         zip(run["tokens"], one["tokens"])),
                     "wav_max_abs_err": errs,
                     "wav_ok": all(np.allclose(a, b, atol=atol, rtol=rtol)
                                   for a, b in zip(run["wavs"], one["wavs"])
                                   if a.shape == b.shape) and max(errs) < float("inf"),
                     "launches": run["launches"]}
    out["speech_tokens"] = [len(t) for t in one["tokens"]]
    return out


def mc_train(rank: int) -> dict:
    """(c) cosyvoice2.yaml's LM at full width in fp32 (TF32 off), its
    train_conf, MC_TRAIN_MICRO_STEPS micro-steps on the train phase's global
    batch split unevenly over DP(2), against the one-process step on the
    whole batch (rank 0 runs it while rank 1 waits): loss and grad_norm a
    micro-step, seconds a micro-step and peak memory a rank."""
    from cosyvoice_tpu_torch.config import RECIPES, load_config, recipe_config
    from cosyvoice_tpu_torch.models.llm import Qwen2LM
    from cosyvoice_tpu_torch.parallel.mesh import make_mesh
    from cosyvoice_tpu_torch.train import optim
    from cosyvoice_tpu_torch.train import step as tstep

    train_conf = load_config(RECIPES / TRAIN_RECIPE)["train_conf"]
    cfg = recipe_config(TRAIN_RECIPE, "llm")
    with torch.device("cuda"):
        llm = Qwen2LM(cfg)
    rand_init_(llm, 1500)
    init = {k: v.clone() for k, v in llm.state_dict().items()}
    batch = train_lm_batch(cfg.qwen.vocab_size, cfg.speech_token_size,
                           np.random.default_rng(MC_SEED + 2), TRAIN_ROWS, TRAIN_TEXT,
                           TRAIN_SPEECH)
    batch["speech_token_len"][TRAIN_ROWS // 2:] = MC_TRAIN_SHORT

    def run(mesh, b):
        llm.load_state_dict(init)
        tx, _ = optim.make_optimizer(
            train_conf["optim"], train_conf["lr"], train_conf["scheduler"],
            train_conf["scheduler_conf"], grad_clip=train_conf["grad_clip"],
            accum_grad=train_conf["accum_grad"])
        st = tstep.make_train_state(llm, tx)
        fn = tstep.make_train_step(tstep.llm_loss_fn, tx, mesh)
        secs, losses, norms = [], [], []
        torch.cuda.reset_peak_memory_stats()
        for i in range(MC_TRAIN_MICRO_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, m = fn(st, tstep.to_device(b, "cuda"), tstep.step_generator(TRAIN_SEED, i,
                                                                            "cuda"))
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
            secs.append(time.perf_counter() - t0)
        del st
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.empty_cache()
        return {"loss": losses, "grad_norm": norms, "micro_step_s": secs, "peak_gib": peak}

    out = {}
    with torch.enable_grad():
        if rank == 0:
            out["one_process"] = run(None, batch)
        torch.distributed.barrier()
        mesh = make_mesh(2, 1)
        out["dp"] = run(mesh, tstep.shard_batch(batch, mesh))
    out["targets_by_rank"] = [int(TRAIN_ROWS // 2 * (TRAIN_SPEECH + 1)),
                              int(TRAIN_ROWS // 2 * (MC_TRAIN_SHORT + 1))]
    del llm, init
    torch.cuda.empty_cache()
    return out


MC_INT4_CAP = 24             # the int4 TP decode's steps (greedy, B=1)
MC_INT4_ROWS = 1             # the requests it decodes, one at a time
MC_K5_LOCAL = ((896, 2432), (2432, 896))   # K5 at Qwen2-0.5B's TP(2) MLP shards
MC_PHO_ROWS, MC_PHO_TEXT, MC_PHO_PHO, MC_PHO_SPEECH = 4, 30, 60, 200


def mc_int4(rank: int) -> dict:
    """(f) the full-width LM in packed int4 (group 128, bf16 activations;
    the int4 phase's weights) under greedy lm_generate at B=1 (K5's decode
    route) of the first MC_INT4_ROWS requests, MC_INT4_CAP steps each: one
    process (rank 0, while rank 1 waits), then TP(2): the MLP sharded (K5
    at [1, 896] -> 2432 and [1, 2432] -> 896 a rank), attention whole
    (448 of its 896 input rows are 3.5 groups).  Tokens against one process, the teacher-forced logits, ms a step and
    K5's launches by shape (the call site counted in this rank only)."""
    from cosyvoice_tpu_torch.models import qwen2 as q2
    from cosyvoice_tpu_torch.models.llm import LMConfig, Qwen2LM, SamplingConfig, lm_generate
    from cosyvoice_tpu_torch.ops.kernels import int4_matmul as K5
    from cosyvoice_tpu_torch.parallel.mesh import LM_RULES, make_mesh, shard_params
    from cosyvoice_tpu_torch.utils.quant import quantize_qwen_int4

    lm_cfg = LMConfig(sampling=SamplingConfig(method="greedy"))
    with torch.device("cuda"):
        fp = Qwen2LM(lm_cfg)
        rand_init_(fp, 12345)
        state = quantize_qwen_int4(fp.to(torch.bfloat16).state_dict(), group_size=128)
        del fp
        llm = Qwen2LM(dataclasses.replace(lm_cfg, qwen=dataclasses.replace(
            lm_cfg.qwen, quant="int4", quant_group=128, fused_cache_update=True)))
    llm.load_state_dict(state, strict=True, assign=True)    # bf16, fp32 scales
    llm.eval()
    del state
    reqs = mc_requests(np.random.default_rng(MC_SEED), full=True)[:MC_INT4_ROWS]
    B = len(reqs)
    t = lambda a: torch.as_tensor(np.asarray(a), device="cuda")[None]  # noqa: E731
    args = [(t(r.text_tokens), t(len(r.text_tokens)), t(r.prompt_speech_tokens),
             t(len(r.prompt_speech_tokens)), t(MC_INT4_CAP), t(MC_INT4_CAP)) for r in reqs]
    shapes: dict = {}
    call = q2.int4_matmul

    def counted(x, w, scale):
        key = f"{x.shape[0] if x.shape[0] == 1 else 'prefill'}x{x.shape[1]}x{w.shape[1]}"
        shapes[key] = shapes.get(key, 0) + 1
        return call(x, w, scale)

    def run(mesh) -> dict:
        K5.launches = 0
        shapes.clear()
        torch.cuda.synchronize()
        if mesh is not None:
            torch.distributed.barrier()
        t0 = time.perf_counter()
        rows = [lm_generate(llm, *a, None, max_steps=MC_INT4_CAP, cache_len=512) for a in args]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return {"tokens": [o[0, :c[0]].cpu().numpy() for o, c in rows], "wall_s": wall,
                "ms_per_step": wall * 1e3 / (MC_INT4_CAP * B), "k5_launches": K5.launches,
                "k5_by_shape": dict(shapes)}

    q2.int4_matmul = counted
    try:
        out, sent = {}, [None, None]
        if rank == 0:
            one = run(None)
            ref, valid = mc_teacher_forced(llm, reqs, one["tokens"], slice(0, B))
            out["one_process"] = {k: v for k, v in one.items() if k != "tokens"}
            sent = [one["tokens"], None]
        torch.distributed.broadcast_object_list(sent, src=0)   # the teacher's tokens
        tokens = sent[0]
        mesh = make_mesh(1, 2)
        shard_params(llm, mesh, LM_RULES)
        layer = llm.body.layers[0]
        tp = run(mesh)
        out["tp"] = {k: v for k, v in tp.items() if k != "tokens"}
        out["tp"]["sharded"] = {"attention": layer.tp_attn is not None,
                                "mlp": layer.tp_mlp is not None}
        got, _ = mc_teacher_forced(llm, reqs, tokens, slice(0, B))   # collective
        out["tp"]["tokens_equal_rows"] = [bool(np.array_equal(a, b))
                                          for a, b in zip(tp["tokens"], tokens)]
        if rank == 0:
            agree = float((got.argmax(-1) == ref.argmax(-1))[valid].float().mean())
            out["tp"].update(logits_rel=float((got - ref).abs().max() / ref.abs().max()),
                             tf_argmax_agreement=agree,
                             wall_vs_one_process=tp["wall_s"] / one["wall_s"])
    finally:
        q2.int4_matmul = call
    del llm
    torch.cuda.empty_cache()
    return out


def mc_train_pair(rank: int) -> dict:
    """(g) cosyvoice2_pho.yaml's LM (Qwen2LMPhonemeSrc2 at full width,
    fp32, TF32 off, dropout off: no_dropout) one step on a seeded
    labelled batch of MC_PHO_ROWS rows under DP(2), each rank its rows of
    it, against one process on the whole batch (rank 0, rank 1 waiting);
    (h) cosyvoice2.yaml's LM with LoRA (r 8, alpha 16 on q/k/v/o, the train
    CLI's defaults) one step under TP(2) (b's rows of q/k/v, a's columns
    of o a rank) against one process.  Loss and grad_norm relative, seconds
    and peak memory a rank."""
    from cosyvoice_tpu_torch.config import RECIPES, build_model, load_config, recipe_config
    from cosyvoice_tpu_torch.models.llm import Qwen2LM
    from cosyvoice_tpu_torch.parallel.mesh import LM_RULES, make_mesh, shard_params
    from cosyvoice_tpu_torch.train import optim
    from cosyvoice_tpu_torch.train import step as tstep
    from cosyvoice_tpu_torch.train.lora import (LoRAConfig, LoRAOverlay, init_lora,
                                                lora_loss_fn, shard_overlay)

    def one_step(model, loss_fn, batch, mesh, specs=None) -> dict:
        tx, _ = optim.make_optimizer("adam", 1e-5, "constantlr", {}, grad_clip=5.0)
        st = tstep.make_train_state(model, tx, mesh, specs)
        fn = tstep.make_train_step(loss_fn, tx, mesh)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, m = fn(st, tstep.to_device(batch, "cuda"), tstep.step_generator(MC_SEED, 0, "cuda"))
        loss, norm = m["loss"].item(), m["grad_norm"].item()
        return {"loss": loss, "grad_norm": norm, "step_s": time.perf_counter() - t0,
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}

    out = {}
    rng = np.random.default_rng(MC_SEED + 5)
    # (g) the phoneme LM under DP(2)
    conf = no_dropout(load_config(RECIPES / PHO_TRAIN_RECIPE)["llm"])
    kind = conf.pop("kind")
    cfg = recipe_config(PHO_TRAIN_RECIPE, "llm")
    n = MC_PHO_ROWS
    batch = {"text_token": rng.integers(0, cfg.qwen.vocab_size, (n, MC_PHO_TEXT)),
             "text_token_len": np.array([MC_PHO_TEXT, 24, 18, 12]),
             "pho_token": np.stack([pho_ids(rng, MC_PHO_PHO, cfg.phoneme) for _ in range(n)]),
             "pho_token_len": np.array([MC_PHO_PHO, 50, 40, 30]),
             "speech_token": rng.integers(0, cfg.speech_token_size, (n, MC_PHO_SPEECH)),
             "speech_token_len": np.array([MC_PHO_SPEECH, 180, 60, 40]),
             "embedding": rng.standard_normal((n, cfg.spk_embed_dim)).astype(np.float32)}
    model = build_model(kind, conf, "cuda")[0]
    rand_init_(model, 1900)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.enable_grad():
        if rank == 0:
            out["pho_one_process"] = one_step(model, tstep.phoneme_llm_loss_fn, batch, None)
            model.load_state_dict(init)
        torch.distributed.barrier()
        mesh = make_mesh(2, 1)
        out["pho_dp"] = one_step(model, tstep.phoneme_llm_loss_fn,
                                 tstep.shard_batch(batch, mesh), mesh)
    del model, init
    torch.cuda.empty_cache()
    # (h) LoRA over the LM under TP(2)
    lcfg = LoRAConfig()
    with torch.device("cuda"):
        base = Qwen2LM(recipe_config(TRAIN_RECIPE, "llm"))
    rand_init_(base, 1500)
    lm_batch = train_lm_batch(base.cfg.qwen.vocab_size, base.cfg.speech_token_size, rng, 4,
                              TRAIN_TEXT, TRAIN_SPEECH)
    overlay = init_lora(base, lcfg, torch.Generator(device="cuda").manual_seed(MC_SEED))
    with torch.enable_grad():
        if rank == 0:
            ov = LoRAOverlay({n: {k: v.clone() for k, v in ab.items()}
                              for n, ab in overlay.items()})
            out["lora_one_process"] = one_step(ov, lora_loss_fn(base, tstep.llm_loss_fn, lcfg),
                                               lm_batch, None)
        torch.distributed.barrier()
        mesh = make_mesh(1, 2)
        _, specs = shard_params(base, mesh, LM_RULES)
        ov = shard_overlay(overlay, specs, mesh.tp)
        out["lora_tp"] = one_step(ov, lora_loss_fn(base, tstep.llm_loss_fn, lcfg), lm_batch,
                                  mesh, ov.specs())
        out["lora_tp"]["factors_split"] = sorted(set(ov.split.values()))
    del base, overlay, ov
    torch.cuda.empty_cache()
    return out


def no_dropout(conf):
    """A recipe section with every dropout rate 0: a data-parallel step of a
    model that draws dropout masks at its rows' shapes equals one process's
    only without them."""
    if isinstance(conf, dict):
        return {k: 0.0 if "dropout" in k else no_dropout(v) for k, v in conf.items()}
    return conf


def mc_k5_local(K5) -> list:
    """K5 at the TP-local shapes of Qwen2-0.5B's MLP at model 2 (MC_K5_LOCAL,
    one row, bf16, group 128): the launch plan, the kernel held to its plain
    version, then timed beside it and torch._weight_int4pack_mm; one
    kernels-line row each."""
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(19)
    rows = []
    for IN, OUT in MC_K5_LOCAL:
        x = torch.randn(1, IN, generator=g, device=dev).to(bf)
        w = K5.pack_int4(torch.randint(-7, 8, (IN, OUT), generator=g, device=dev))
        sc = torch.rand(IN // 128, OUT, generator=g, device=dev) * 0.02 + 1e-3
        err = check(f"int4_matmul_tp_1x{IN}x{OUT}", bf, K5.int4_matmul(x, w, sc),
                    K5.int4_matmul_plain(x, w, sc), phase="multi_card")
        k5 = lambda: K5.int4_matmul(x, w, sc)  # noqa: E731
        try:
            lib = int4pack_call(x, w, sc)
            lib_t = dict(library_ms=time_ms(lib), **dev_time(lib, "library_dev"),
                         library_call="torch._weight_int4pack_mm (zero points 0)")
        except (RuntimeError, AttributeError, NotImplementedError) as e:
            lib_t = dict(library_ms=None, library_dev_ms=None, library_error=str(e)[:300])
        rows.append(dict(
            name="int4_matmul", source="cosyvoice_tpu_torch/csrc/int4_matmul.cu",
            replaces="cosyvoice_tpu/ops/pallas/int4_matmul.py:84", shape=[1, IN, OUT],
            local_shard="Qwen2-0.5B MLP at model 2 (int4, group 128)",
            launches_from="multi_card (full-width int4 TP decode)",
            plan=K5.plan(1, IN, OUT, 128), ms=time_ms(k5), **dev_time(k5),
            plain_ms=time_ms(lambda: K5.int4_matmul_plain(x, w, sc)), **lib_t,
            # packed weights, scales, x and y, each once
            bytes=IN // 2 * OUT + IN // 128 * OUT * 4 + (IN + OUT) * 2, flops=2 * IN * OUT,
            max_abs_err=err))
    return rows


def multi_card_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """One rank of the multi_card phase: joins the group (the backend
    init picks: gloo over CUDA tensors on a shared card), then (b), (a) and
    (c); writes its results as JSON."""
    import os

    from cosyvoice_tpu_torch.ops.kernels import build
    from cosyvoice_tpu_torch.ops.kernels import dit_attention as K2
    from cosyvoice_tpu_torch.ops.kernels import dit_block as K4
    from cosyvoice_tpu_torch.ops.kernels import fused_norm as K3
    from cosyvoice_tpu_torch.ops.kernels import lm_decode_attention as K1
    from cosyvoice_tpu_torch.parallel import distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    build.library()
    kernels = {"lm_decode_attention": K1, "dit_attention": K2, "fused_layer_norm": K3,
               "dit_block": K4}
    backend = dist.init(f"file://{store}", world, rank, device_type="cuda")
    torch.cuda.set_device(dist.local_device())
    try:
        t0 = time.perf_counter()
        small = mc_small(kernels)
        t1 = time.perf_counter()
        full = mc_full(rank, kernels)
        t2 = time.perf_counter()
        train = mc_train(rank)
        t3 = time.perf_counter()
        int4 = mc_int4(rank)
        t4 = time.perf_counter()
        pair = mc_train_pair(rank)
        t5 = time.perf_counter()
        res = {"rank": rank, "backend": backend, "device": str(torch.cuda.current_device()),
               "small": small, "full": full, "train": train, "int4": int4, "pair": pair,
               "seconds": {"small": t1 - t0, "full": t2 - t1, "train": t3 - t2,
                           "int4": t4 - t3, "train_pair": t5 - t4}}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        torch.distributed.destroy_process_group()


def nccl_shared_card_probe(timeout_s: float = 60.0) -> dict:
    """Two NCCL ranks on the one card: init and one all-reduce, killed after
    timeout_s.  NCCL is expected to refuse two ranks on one device."""
    code = ("import os, sys, torch, torch.distributed as d\n"
            "r = int(sys.argv[1])\n"
            "torch.cuda.set_device(0)\n"
            "d.init_process_group('nccl', init_method='tcp://localhost:' + sys.argv[2],"
            " world_size=2, rank=r)\n"
            "t = torch.ones(4, device='cuda')\n"
            "d.all_reduce(t)\n"
            "torch.cuda.synchronize()\n"
            "print('SUM', float(t[0]))\n")
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), port],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    for p in procs:
        try:
            o, e = p.communicate(timeout=timeout_s)
            outs.append((p.returncode, o[-300:], e[-600:]))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            outs.append(("timeout", "", ""))
    worked = all(rc == 0 and "SUM 2.0" in o for rc, o, _ in outs)
    return {"nccl_two_ranks_one_card": "worked" if worked else "refused",
            "returncodes": [o[0] for o in outs],
            "stderr_tail": [o[2][-300:] for o in outs]}


def mc_cli_drive() -> dict:
    """(d) `python -m torch.distributed.run --nproc_per_node 2 -m
    cosyvoice_tpu_torch.bin.train --mesh_model 2` on the card over a seeded
    jsonl corpus at the small LM widths (TRAIN_SMALL, heads 4 / 2: one query
    pair and one KV head a rank): one epoch of 2 steps, then one process
    resumes from its checkpoint in this process (steps 3, 4)."""
    import os
    import shutil
    import tempfile

    from cosyvoice_tpu_torch.bin import train as train_cli
    from cosyvoice_tpu_torch.train.checkpoint import latest_step

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="mc_cli_", dir=root)
    try:
        rng = np.random.default_rng(8)
        corpus = os.path.join(tmp, "data.jsonl")
        with open(corpus, "w") as f:
            for i in range(4):
                f.write(json.dumps({
                    "utt": f"u{i}", "text": "hello world", "sample_rate": 24000,
                    "speech": (rng.standard_normal(15600) * 0.1).round(5).tolist(),
                    "speech_token": rng.integers(0, 100, 30).tolist(),
                    "embedding": rng.standard_normal(512).round(5).tolist()}) + "\n")
        lst = os.path.join(tmp, "train.list")
        with open(lst, "w") as f:
            f.write(corpus + "\n")
        conf = {"llm": dict(TRAIN_SMALL["qwen2lm"], kind="qwen2lm"),
                "data": {"filter": {"max_length": 99999, "token_max_length": 300},
                         "fbank": {"n_fft": 192, "hop": 48, "n_mels": 20},
                         "batch_type": "static", "batch_size": 2, "shuffle_buf": 4,
                         "sort_buf": 2},
                "train_conf": {"lr": 0.0001, "log_interval": 1,
                               "scheduler_conf": {"warmup_steps": 10}}}
        cfg = os.path.join(tmp, "conf.yaml")
        with open(cfg, "w") as f:      # one flow mapping a section (the recipes' YAML subset)
            f.writelines(f"{k}: {json.dumps(v)}\n" for k, v in conf.items())
        model_dir = os.path.join(tmp, "exp")
        args = ["-m", "cosyvoice_tpu_torch.bin.train", "--config", cfg, "--model", "llm",
                "--train_data", lst, "--model_dir", model_dir, "--epochs", "1"]
        t0 = time.perf_counter()
        cmd = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", str(MC_WORLD)] + args + ["--mesh_model", "2"])
        out = subprocess.run(cmd, cwd=here, capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            raise AssertionError(f"bin.train failed: {cmd}\n{out.stderr[-3000:]}")
        runs = [{"s": time.perf_counter() - t0, "latest_step": latest_step(model_dir),
                 "backend": [ln for ln in out.stderr.splitlines()
                             if "torch.distributed: rank" in ln][:2]}]
        # the one-process resume, in this process (its main() on the card)
        t0 = time.perf_counter()
        with torch.enable_grad():
            train_cli.main(args[2:])
        runs.append({"s": time.perf_counter() - t0, "latest_step": latest_step(model_dir)})
        recs = [json.loads(line) for line in open(os.path.join(model_dir, "metrics.jsonl"))]
        return {"runs": runs, "steps": [r["step"] for r in recs],
                "loss": [r["loss"] for r in recs],
                "finite": all(np.isfinite(v) for r in recs for k, v in r.items() if k != "tag")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def mc_flow_device() -> dict:
    """(e) the small fp32 stack's ContinuousSynthesizer with the LM on the
    card and flow_device="cpu" (copies of the flow and HiFT on the CPU,
    chunks on the worker thread), 4 greedy requests through 2 slots, against
    the all-card run: the audio within CONT_WAV_TOL (the card-vs-CPU bar).
    The same model then serves all on the card again: its own flow and HiFT
    stayed there."""
    from cosyvoice_tpu_torch.runtime.serving import ContinuousSynthesizer

    reqs = mc_requests(np.random.default_rng(MC_SEED + 3), full=False)
    kw = dict(num_slots=2, cache_len=256, text_bucket=16, speech_bucket=16)
    model = small_stack("cuda", max_decode_tokens=60)
    out = {}
    for name, fd in (("card", None), ("split", "cpu"), ("card_after", None)):
        synth = ContinuousSynthesizer(model, flow_device=fd, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = synth.synthesize_batch(reqs, gen=torch.Generator().manual_seed(4))
        torch.cuda.synchronize()
        out[name + "_s"] = time.perf_counter() - t0

    def errs(run):
        return [float(np.abs(a - b).max()) if a.shape == b.shape else float("inf")
                for a, b in zip(out[run], out["card"])]

    split, after = errs("split"), errs("card_after")
    on_card = all(p.is_cuda for m in (model.flow, model.hift) for p in m.parameters())
    return {"wav_max_abs_err": split, "card_after_max_abs_err": after, "tol": CONT_WAV_TOL,
            "card_s": out["card_s"], "split_s": out["split_s"],
            "samples": [len(w) for w in out["card"]], "model_flow_on_card": on_card,
            "ok": (max(split) <= CONT_WAV_TOL and max(after) <= CONT_WAV_TOL and on_card
                   and all(np.isfinite(w).all() for w in out["split"]))}


def mc_k1_local(K1) -> list:
    """K1 at the TP-local shape of Qwen2-0.5B at model 2 (one KV head, 7
    query heads: G = 7, KH * D = 64), bf16: B = 1 at the main path's cache
    (384 rows, frontier 364) and B = 8 with per-row frontiers; each held
    to its plain version (cache equal), then timed beside its plain version
    and SDPA over the live rows; one kernels-line row each."""
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(18)
    r = lambda *s: torch.randn(*s, generator=g, device=dev).to(bf)  # noqa: E731
    rows = []
    for B, pos in ((1, (364,)), (len(K1_BATCH_POS), K1_BATCH_POS)):
        T = 384
        q, kn, vn, ck, cv = r(B, 7, 64), r(B, 1, 64), r(B, 1, 64), r(B, T, 64), r(B, T, 64)
        bias = torch.zeros(B, T, device=dev)
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        err = check_k1(K1, bf, q, kn, vn, ck, cv, bias, p, name=f"lm_decode_attention_tp_B{B}",
                       phase="multi_card")
        q_sd = q.reshape(B, 7, 1, 64)
        k_sd, v_sd = (torch.cat([c, new], dim=1).reshape(B, T + 1, 1, 64).transpose(1, 2)
                      .contiguous() for c, new in ((ck, kn), (cv, vn)))
        j = torch.arange(T + 1, device=dev)[None, :]
        keymask = ((j < p[:, None]) | (j == T))[:, None, None, :]
        live = sum(pos)
        k1 = lambda: K1.lm_decode_attention(q, kn, vn, ck, cv, bias, p, 64, 0.125)  # noqa: E731
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q_sd, k_sd, v_sd, attn_mask=keymask, scale=0.125, enable_gqa=True)
        rows.append(dict(
            name="lm_decode_attention",
            source="cosyvoice_tpu_torch/csrc/lm_decode_attention.cu",
            replaces="cosyvoice_tpu/ops/pallas/lm_decode_attention.py:123",
            shape=[B, T, list(pos)], local_heads="KH 1, G 7 (Qwen2-0.5B, model 2)",
            launches_from="multi_card (full-width TP, local heads)",
            ms=time_ms(k1), **dev_time(k1),
            plain_ms=time_ms(lambda: K1.lm_decode_attention_plain(q, kn, vn, ck, cv, bias, p,
                                                                  64, 0.125)),
            library_ms=time_ms(sdpa), **dev_time(sdpa, "library_dev"),
            # the live k/v rows read once, q and the new k/v read, o written, bf16
            bytes=2 * live * 64 * 2 + live * 4 + B * (2 * 7 + 4) * 64 * 2,
            flops=sum(4 * 7 * 64 * (pb + 1) for pb in pos), max_abs_err=err))
    return rows


def multi_card_phase(kernels: dict, smi: str) -> dict:
    """More than one card's code paths on the one card: (k) K1 at the
    TP-local shape (mc_k1_local); two ranks spawned on the card
    (multi_card_rank), the backend as init picks it; (b) mc_small; (a)
    mc_full; (c) mc_train; (d) mc_cli_drive; (e) mc_flow_device; and
    whether NCCL takes two ranks on one card (nccl_shared_card_probe,
    printed only).  Gates: K1 equal to its plain version; every rank's
    backend gloo; (b) tokens exact and wavs within MC_SMALL_WAV_TOL; (a)
    every wav finite and of its tokens' length, the teacher-forced logits
    within MC_LOGITS_REL_TOL; K1-K4 launched under TP and under DP (K2
    in (b): (a)'s DiT blocks take K4, which runs K2's kernel inside); (c)
    loss and grad_norm within MC_TRAIN_REL_TOL; (d) steps 1..4 finite, the
    CLI's checkpoint at 2 then 4; (e) within CONT_WAV_TOL.  NCCL between
    cards and the flow's overlap on a second card need a second card and
    are not measured here."""
    import os
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    K1 = kernels["lm_decode_attention"]
    k1_rows = mc_k1_local(K1)
    k5_rows = mc_k5_local(kernels["int4_matmul"])
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="multi_card_", dir=os.path.join(here, "build"))
    try:
        t0 = time.perf_counter()
        ctx = mp.start_processes(multi_card_rank,
                                 args=(MC_WORLD, os.path.join(tmp, "store"), tmp),
                                 nprocs=MC_WORLD, join=False, start_method="spawn")
        deadline = time.monotonic() + MC_CLUSTER_S
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise AssertionError(f"multi_card ranks did not finish in {MC_CLUSTER_S} s")
        ranks_s = time.perf_counter() - t0
        ranks = [json.load(open(os.path.join(tmp, f"rank{r}.json"))) for r in range(MC_WORLD)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t0 = time.perf_counter()
    cli = mc_cli_drive()
    cli_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    split = mc_flow_device()
    split_s = time.perf_counter() - t0
    nccl = nccl_shared_card_probe()
    # launches of the ranks' sharded runs, summed over the ranks
    launches = {run: {k: sum(r[part][run]["launches"][k] for r in ranks for part in
                             ("small", "full")) for k in kernels if k in ranks[0]["full"][run]
                      ["launches"]} for run in ("dp", "tp")}
    one = ranks[0]["train"]["one_process"]
    train_rel = max(max(rel_errs(r["train"]["dp"]["loss"], one["loss"]),
                        rel_errs(r["train"]["dp"]["grad_norm"], one["grad_norm"]))
                    for r in ranks)
    res = {"phase": "multi_card", "card": smi, "world": MC_WORLD,
           "backend": [r["backend"] for r in ranks], "k1_tp_local": [
               {k: row[k] for k in ("shape", "max_abs_err", "ms", "dev_ms", "plain_ms",
                                    "library_ms", "library_dev_ms")} for row in k1_rows],
           "ranks": [{k: r[k] for k in ("rank", "small", "full", "seconds")} for r in ranks],
           "train": {"one_process": one, "dp_by_rank": [r["train"]["dp"] for r in ranks],
                     "targets_by_rank": ranks[0]["train"]["targets_by_rank"],
                     "max_rel_err": train_rel, "tol": MC_TRAIN_REL_TOL},
           "logits_tol": MC_LOGITS_REL_TOL, "cli": cli, "cli_s": cli_s,
           "flow_device": split, "flow_device_s": split_s, "nccl_probe": nccl,
           "launches": launches, "ranks_s": ranks_s,
           # K1 at the TP-local heads: the full-width TP run's launches alone
           # (the small stack's TP run has other heads, in fp32)
           "k1_tp_full_launches": sum(r["full"]["tp"]["launches"]["lm_decode_attention"]
                                      for r in ranks),
           "k5_tp_local": [{k: row[k] for k in ("shape", "plan", "max_abs_err", "ms", "dev_ms",
                                                "plain_ms", "library_ms", "library_dev_ms")}
                           for row in k5_rows],
           "int4": {"one_process": ranks[0]["int4"]["one_process"],
                    "tp_by_rank": [r["int4"]["tp"] for r in ranks]},
           "pair": [r["pair"] for r in ranks],
           "not_measured": "NCCL between cards and the flow's overlap on a second card "
                           "(one card on this machine)",
           "phase_s": time.perf_counter() - t_phase}
    # the int4 TP decode's K5 launches, both ranks: all, and by call shape
    res["k5_tp_launches"] = sum(r["int4"]["tp"]["k5_launches"] for r in ranks)
    res["k5_tp_by_shape"] = {k: sum(r["int4"]["tp"]["k5_by_shape"].get(k, 0) for r in ranks)
                             for k in ranks[0]["int4"]["tp"]["k5_by_shape"]}
    pair_one = ranks[0]["pair"]
    pair_rel = {run: max(max(rel_errs([r["pair"][f"{run}_{mode}"][k]],
                                      [pair_one[f"{run}_one_process"][k]])
                             for k in ("loss", "grad_norm")) for r in ranks)
                for run, mode in (("pho", "dp"), ("lora", "tp"))}
    res["pair_max_rel_err"] = pair_rel
    emit(res)
    full = [r["full"] for r in ranks]
    small = [r["small"] for r in ranks]
    gates = [all(b == "gloo" for b in res["backend"]),
             all(s[m]["tokens_equal"] and s[m]["wav_ok"] for s in small for m in ("dp", "tp")),
             all(f[m]["wav_ok"] and f[m]["logits_rel"] <= MC_LOGITS_REL_TOL
                 for f in full for m in ("dp", "tp")),
             all(n > 0 for run in ("dp", "tp") for n in launches[run].values()),
             full[0]["tp"]["local_heads"] == [7, 1],
             train_rel <= MC_TRAIN_REL_TOL,
             cli["finite"] and cli["steps"] == [1, 2, 3, 4]
             and [r["latest_step"] for r in cli["runs"]] == [2, 4],
             split["ok"],
             all(r["int4"]["tp"]["sharded"] == {"attention": False, "mlp": True}
                 and r["int4"]["tp"]["k5_launches"] > 0 for r in ranks),
             ranks[0]["int4"]["tp"]["logits_rel"] <= MC_LOGITS_REL_TOL,
             max(pair_rel.values()) <= MC_TRAIN_REL_TOL,
             ranks[0]["pair"]["lora_tp"]["factors_split"] == ["a", "b"]]
    if not all(gates):
        raise AssertionError(f"multi_card phase failed: {gates} {res}")
    res["k1_rows"], res["k5_rows"] = k1_rows, k5_rows
    return res


def kernel_times(fn, n: int = 10) -> dict:
    """{CUDA event name: (device ms, launches)} per call of fn, over n calls
    under torch.profiler (after one call outside it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            ms, count = out.get(e.key, (0.0, 0.0))
            out[e.key] = (ms + e.self_device_time_total / 1e3 / n, count + e.count / n)
    return out


def kernel_key(name: str) -> str:
    """A kernel's first `*_kernel` word (else its first word): template
    instances and both of a kernel's routes share it."""
    import re

    return (re.search(r"\w+_kernel", name) or re.search(r"\w+", name)).group(0)


def device_ms_by_kernel(fn, n: int = 10) -> dict:
    """Device time per call of each CUDA kernel that fn launches, over n calls
    under torch.profiler, keyed by kernel_key; the instances that share a key
    add up, so the values sum to the device time of every CUDA event."""
    ms = {}
    for name, (t, _) in kernel_times(fn, n).items():
        ms[kernel_key(name)] = ms.get(kernel_key(name), 0.0) + t
    return ms


def device_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Device time of one call of fn: `calls` calls captured in one CUDA graph,
    CUDA events around `replays` replays of it.  No host work is in it: where
    a call's host work outlasts its kernels, time_ms measures the host and
    this the device."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):                   # allocations and scratch before the capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def dev_time(fn, prefix: str = "dev") -> dict:
    """`{prefix}_ms`: the median of three device_ms runs of fn, all three
    listed under `{prefix}_ms_runs`.  Where fn refuses stream capture (a
    cooperative launch may), the three runs are CUDA events around 50
    back-to-back calls instead, and `{prefix}_method` says "events"."""
    method = "graph"
    try:
        runs = [device_ms(fn) for _ in range(3)]
    except RuntimeError as e:
        torch.cuda.synchronize()
        method, runs = "events", [time_ms(fn, iters=50) for _ in range(3)]
        emit({"phase": "timing", "capture_refused": prefix, "error": str(e)[:200]})
    return {f"{prefix}_ms": sorted(runs)[1], f"{prefix}_ms_runs": runs,
            f"{prefix}_method": method}


def int4pack_call(x, w_packed, scale, group: int = 128):
    """PyTorch's own group-wise int4 matmul (torch._weight_int4pack_mm, the
    tinygemm kernel) set up to compute K5's function on the same inputs: the
    weights converted once to its layout (unsigned nibbles n + 8, even input
    row in the high nibble of its byte), its scales x's dtype and its zero
    points 0, so it dequantises to T(n * T(scale)) and sums in fp32, as K5
    does.  A timing yardstick only; the port never calls it.  Returns the
    call; raises where this PyTorch build lacks the op."""
    p = w_packed.to(torch.int32) & 0xFF
    lo, hi = (p & 0xF) ^ 8, ((p >> 4) & 0xF) ^ 8          # [in/2, out], n + 8
    packed = ((lo.t() << 4) | hi.t()).to(torch.uint8).contiguous()   # [out, in/2]
    wq = torch._convert_weight_to_int4pack(packed, 8)
    sz = torch.stack([scale.to(x.dtype), torch.zeros_like(scale, dtype=x.dtype)], -1)
    sz = sz.contiguous()
    return lambda: torch._weight_int4pack_mm(x, wq, group, sz)


def timing(K1, K2, K3, K4, K5, K6, K7, last_decode, flow, block_shape) -> list:
    """At the last request's shapes (bf16; K4 at the batched phase's flow
    shape; K7 fp32 at the bigvgan phase's four stage shapes, both layouts):
    each kernel against its plain version on the same inputs, then kernel,
    plain and library times."""
    from cosyvoice_tpu_torch.ops.resample import anti_alias_activation

    dev, bf = torch.device("cuda"), torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(2)
    r = lambda *s: torch.randn(*s, generator=g, device=dev).to(bf)
    n_text, n_prompt, n_tok = last_decode
    rows = []

    # K1: B=1 decode step at the final frontier of the last request
    cap = 200
    T = -(-(2 + n_text + n_prompt + cap) // 128) * 128
    pos = 2 + n_text + n_prompt + n_tok - 1
    q, kn, vn, ck, cv = r(1, 7, 128), r(1, 1, 128), r(1, 1, 128), r(1, T, 128), r(1, T, 128)
    bias = torch.zeros(1, T, device=dev)
    p = torch.tensor([pos], dtype=torch.int32, device=dev)
    k1_err = check_k1(K1, bf, q, kn, vn, ck, cv, bias, p, phase="timing")
    isz = 2
    k1_bytes = 2 * pos * 128 * isz + pos * 4 + 2 * 7 * 128 * isz + 4 * 128 * isz
    k1_flops = 4 * 7 * 128 * (pos + 1)
    # library yardstick: SDPA with GQA over the live rows plus the new one,
    # [1, 14, 1, 64] x [1, 2, pos+1, 64]; it leaves out the in-place append
    q_sd = q.reshape(1, 7, 2, 64).transpose(1, 2).reshape(1, 14, 1, 64)
    k_sd, v_sd = (torch.cat([c[:, :pos], new], dim=1).reshape(1, pos + 1, 2, 64)
                  .transpose(1, 2).contiguous() for c, new in ((ck, kn), (cv, vn)))
    k1 = lambda: K1.lm_decode_attention(q, kn, vn, ck, cv, bias, p, 64, 0.125)
    sdpa = lambda: F.scaled_dot_product_attention(q_sd, k_sd, v_sd, scale=0.125,
                                                  enable_gqa=True)
    rows.append(dict(
        name="lm_decode_attention", source="cosyvoice_tpu_torch/csrc/lm_decode_attention.cu",
        replaces="cosyvoice_tpu/ops/pallas/lm_decode_attention.py:123", shape=[1, T, pos],
        ms=time_ms(k1),
        plain_ms=time_ms(lambda: K1.lm_decode_attention_plain(q, kn, vn, ck, cv, bias, p,
                                                              64, 0.125)),
        library_ms=time_ms(sdpa), **dev_time(k1), **dev_time(sdpa, "library_dev"),
        bytes=k1_bytes, flops=k1_flops, max_abs_err=k1_err))

    # K1 at the engine's and the batched phase's shape: B = 8, cache 384,
    # per-row frontiers; the yardstick is SDPA over the whole cache plus the
    # new token with a boolean key mask that keeps the live rows of each row
    B8, T8 = len(K1_BATCH_POS), 384
    q, kn, vn, ck, cv = (r(B8, 7, 128), r(B8, 1, 128), r(B8, 1, 128), r(B8, T8, 128),
                         r(B8, T8, 128))
    bias = torch.zeros(B8, T8, device=dev)
    p8 = torch.tensor(K1_BATCH_POS, dtype=torch.int32, device=dev)
    k1b_err = check_k1(K1, bf, q, kn, vn, ck, cv, bias, p8, phase="timing")
    q_sd = q.reshape(B8, 7, 2, 64).transpose(1, 2).reshape(B8, 14, 1, 64)
    k_sd, v_sd = (torch.cat([c, new], dim=1).reshape(B8, T8 + 1, 2, 64).transpose(1, 2)
                  .contiguous() for c, new in ((ck, kn), (cv, vn)))
    j = torch.arange(T8 + 1, device=dev)[None, :]
    keymask = ((j < p8[:, None]) | (j == T8))[:, None, None, :]
    live = sum(K1_BATCH_POS)
    k1b = lambda: K1.lm_decode_attention(q, kn, vn, ck, cv, bias, p8, 64, 0.125)
    sdpa_b = lambda: F.scaled_dot_product_attention(q_sd, k_sd, v_sd, attn_mask=keymask,
                                                    scale=0.125, enable_gqa=True)
    rows.append(dict(
        name="lm_decode_attention", source="cosyvoice_tpu_torch/csrc/lm_decode_attention.cu",
        replaces="cosyvoice_tpu/ops/pallas/lm_decode_attention.py:123",
        shape=[B8, T8, list(K1_BATCH_POS)], launches_from="engine (full width, B = 8)",
        ms=time_ms(k1b), **dev_time(k1b),
        plain_ms=time_ms(lambda: K1.lm_decode_attention_plain(q, kn, vn, ck, cv, bias, p8,
                                                              64, 0.125)),
        library_ms=time_ms(sdpa_b), **dev_time(sdpa_b, "library_dev"),
        bytes=2 * live * 128 * isz + live * 4 + B8 * (2 * 7 + 4) * 128 * isz,
        flops=sum(4 * 7 * 128 * (pb + 1) for pb in K1_BATCH_POS), max_abs_err=k1b_err))

    # K2: the CFG batch of the last request's flow call, T padded to 128
    n = n_prompt + n_tok
    Tm = 2 * (-(-n // 50) * 50)
    Tp = -(-Tm // 128) * 128
    L = 2 * n
    qkv = r(2, Tp, 1536)
    lens = torch.full((2,), L, dtype=torch.int32, device=dev)
    q3, k3, v3 = (qkv[..., i * 512:(i + 1) * 512].reshape(2, Tp, 8, 64) for i in range(3))
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q3, k3, v3))
    keymask = (torch.arange(Tp, device=dev) < L)[None, None, None, :].expand(2, 1, 1, Tp)
    k2_err = check_attention(
        "dit_attention", bf, K2.dit_attention_packed(qkv, lens, 0.125, 64).reshape(2, Tp, 8, 64),
        K2.dit_attention_plain(q3, k3, v3, lens, 0.125), lens, phase="timing")
    # q and out over all Tp rows; k and v over the L live rows only
    k2_bytes = 2 * (2 * Tp * 512 + 2 * L * 512) * isz + 2 * 4
    k2 = lambda: K2.dit_attention_packed(qkv, lens, 0.125, 64)
    sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=keymask)
    rows.append(dict(
        name="dit_attention", source="cosyvoice_tpu_torch/csrc/dit_attention.cu",
        replaces="cosyvoice_tpu/ops/pallas/dit_attention.py:124", shape=[2, Tp, 1536, L],
        ms=time_ms(k2), **dev_time(k2),
        plain_ms=time_ms(lambda: K2.dit_attention_plain(q3, k3, v3, lens, 0.125)),
        library_ms=time_ms(sdpa), **dev_time(sdpa, "library_dev"),
        bytes=k2_bytes, flops=2 * 4 * 8 * Tp * L * 64, max_abs_err=k2_err))

    # K3: the estimator's LayerNorm over the CFG batch's rows
    x, w, b = r(2 * Tp, 256), r(256), r(256)
    k3_err = max(check(f"fused_layer_norm_{act}", bf, K3.fused_layer_norm(x, w, b, 1e-5, act),
                       K3.layer_norm_plain(x, w, b, 1e-5, act), phase="timing")
                 for act in ("none", "mish"))
    k3 = lambda: K3.fused_layer_norm(x, w, b, 1e-5, "none")
    ln = lambda: F.layer_norm(x, (256,), w, b, 1e-5)
    rows.append(dict(
        name="fused_layer_norm", source="cosyvoice_tpu_torch/csrc/fused_norm.cu",
        replaces="cosyvoice_tpu/ops/pallas/fused_norm.py:54", shape=[2 * Tp, 256],
        ms=time_ms(k3), **dev_time(k3),
        plain_ms=time_ms(lambda: K3.layer_norm_plain(x, w, b, 1e-5, "none")),
        library_ms=time_ms(ln), **dev_time(ln, "library_dev"),
        bytes=2 * 2 * Tp * 256 * isz + 2 * 256 * isz, flops=10 * 2 * Tp * 256,
        max_abs_err=k3_err))

    # K5: one decode row through each projection shape; the row is 896 -> 4864
    def k5_inputs(IN, OUT, rows=1):
        w = K5.pack_int4(torch.randint(-7, 8, (IN, OUT), generator=g, device=dev))
        return r(rows, IN), w, torch.rand(IN // 128, OUT, generator=g, device=dev) * 0.02 + 1e-3

    def k5_bytes(IN, OUT, rows=1):
        return IN // 2 * OUT + IN // 128 * OUT * 4 + rows * (IN + OUT) * isz

    def k5_library(x5, name):
        """torch._weight_int4pack_mm on x5, held against the plain version
        (recorded, not gated: it is a yardstick): timing keys, or the error
        where this PyTorch build has no such op."""
        try:
            lib = int4pack_call(*x5)
            got = lib()
        except (RuntimeError, AttributeError, NotImplementedError) as e:
            emit({"phase": "timing", "library_refused": name, "error": str(e)[:300]})
            return dict(library_ms=None, library_dev_ms=None, library_error=str(e)[:300])
        want = K5.int4_matmul_plain(*x5).float()
        atol, rtol = CHECK_TOL[bf]
        return dict(library_ms=time_ms(lib), **dev_time(lib, "library_dev"),
                    library_call="torch._weight_int4pack_mm (zero points 0)",
                    library_max_abs_err=float((got.float() - want).abs().max()),
                    library_within_tol=bool(torch.allclose(got.float(), want, atol=atol,
                                                           rtol=rtol)))

    # one row a projection shape; launches are the int4 request's, all four
    # shapes together
    for IN, OUT in K5_SHAPES:
        x5 = k5_inputs(IN, OUT)
        k5_err = check(f"int4_matmul_1x{IN}x{OUT}", bf, K5.int4_matmul(*x5),
                       K5.int4_matmul_plain(*x5), phase="timing")
        k5 = lambda: K5.int4_matmul(*x5)
        rows.append(dict(
            name="int4_matmul", source="cosyvoice_tpu_torch/csrc/int4_matmul.cu",
            replaces="cosyvoice_tpu/ops/pallas/int4_matmul.py:84", shape=[1, IN, OUT],
            launches_scope="the int4 request, all four shapes together",
            plan=K5.plan(1, IN, OUT, 128), ms=time_ms(k5), **dev_time(k5),
            plain_ms=time_ms(lambda: K5.int4_matmul_plain(*x5)),
            **k5_library(x5, f"int4_matmul_1x{IN}x{OUT}"),
            bytes=k5_bytes(IN, OUT), flops=2 * IN * OUT, max_abs_err=k5_err))
    # a decode step's 168 K5 launches (24 layers x K5_STEP), each on weights
    # of its own as in the int4 request: 179 MB of packed int4, more than the
    # 50 MB L2 holds, where each row above reuses one weight from the L2; the
    # library yardstick runs the same step on the same weights
    step_args = [k5_inputs(IN, OUT) for _ in range(24) for IN, OUT in K5_STEP]
    k5_step = lambda: [K5.int4_matmul(*a) for a in step_args]
    before = K5.launches
    k5_step()
    step = dict(launches=K5.launches - before, **dev_time(k5_step, "step_dev"),
                bound_ms=sum(k5_bytes(2 * a[1].shape[0], a[1].shape[1]) for a in step_args)
                / HBM_BYTES_PER_S * 1e3)
    try:
        lib_step = [int4pack_call(*a) for a in step_args]
        step.update(dev_time(lambda: [f() for f in lib_step], "library_step_dev"))
        del lib_step
    except (RuntimeError, AttributeError, NotImplementedError) as e:
        step.update(library_step_dev_ms=None, library_error=str(e)[:300])
    del step_args
    rows[-len(K5_SHAPES)]["decode_step"] = step

    # K6: one full-width step at the K1 row's frontier (pos 364 of 384 rows)
    inp = step_inputs(K6, bf, 7, C=T, pos=pos)
    k6_err = check_step(K6, inp, bf, phase="timing")
    w = inp["w"]
    n_int8 = sum(t.numel() for t in (w.wqkv, w.wo, w.wg, w.wu, w.wd))
    n_f32 = sum(t.numel() for t in (w.sqkv, w.bqkv, w.so, w.sg, w.su, w.sd, w.n1, w.n2))
    L = w.wqkv.shape[0]
    k6 = lambda: run_step(K6, inp)
    k6_ms, k6_dev = time_ms(k6), dev_time(k6)
    n_sync = 5 * L                  # five grid barriers a layer
    probe = lambda: K6.sync_probe(n_sync, dev)
    grid = probe()
    sync_ms, sync_dev = time_ms(probe), dev_time(probe, "sync_dev")
    # int8 weights + fp32 scales/biases/norms + live cache rows read + the
    # new rows written + x, y and the RoPE tables
    k6_bytes = n_int8 + 4 * n_f32 + 2 * L * (pos + 1) * 128 * isz + 2 * 896 * isz + 2 * 64 * 4
    rows.append(dict(
        name="lm_step", source="cosyvoice_tpu_torch/csrc/lm_step.cu",
        replaces="cosyvoice_tpu/ops/pallas/lm_step.py:222", shape=[L, 1, 896, T, pos],
        ms=k6_ms, **k6_dev, plain_ms=time_ms(lambda: run_step(K6, inp, plain=True), iters=10),
        library_ms=None, bytes=k6_bytes,
        flops=2 * n_int8 + L * 4 * 14 * 64 * (pos + 1), max_abs_err=k6_err,
        grid_blocks=grid, plan=step_plan(K6, T, dev), grid_syncs=n_sync, sync_ms=sync_ms,
        **sync_dev, sync_share=sync_dev["sync_dev_ms"] / k6_dev["dev_ms"],
        hbm_share=k6_bytes / (k6_dev["dev_ms"] * 1e-3) / HBM_BYTES_PER_S))
    # K4: one DiT block of the main path's estimator (its bf16 weights) over
    # the batched phase's CFG batch; the yardstick is the same block unfused
    # (K3 norms, K2 attention, cuBLAS projections): no one PyTorch call
    # computes the block
    B4, T4, lens4 = block_shape
    blk = dit_blocks(flow)[0]
    w4 = blk.fused_weights(bf)
    x4 = r(B4, T4, 256)
    L4 = torch.tensor(lens4, dtype=torch.int32, device=dev)
    kw4 = dict(sm_scale=0.125, heads=8, head_dim=64)
    k4_err = check_block("dit_block", bf,
                         K4.dit_block_fused(x4, L4, *w4, **kw4, return_attention=True),
                         K4.dit_block_plain(x4, L4, *w4, **kw4, return_attention=True),
                         phase="timing")
    dim, inner, ff = 256, 512, 1024
    blk.fused_block = False
    k4 = lambda: K4.dit_block_fused(x4, L4, *w4, **kw4)
    unfused = lambda: blk(x4, None, L4)
    # K2 alone at the block's qkv shape: the floor of K4's attention launch
    qkv4 = r(B4, T4, 3 * inner)
    k2_block = dev_time(lambda: K2.dit_attention_packed(qkv4, L4, 0.125, 64), "k2_dev")
    rows.append(dict(
        name="dit_block", source="cosyvoice_tpu_torch/csrc/dit_block.cu",
        replaces="cosyvoice_tpu/ops/pallas/dit_block.py:115", shape=[B4, T4, dim],
        ms=time_ms(k4, iters=20), **dev_time(k4),
        plain_ms=time_ms(lambda: K4.dit_block_plain(x4, L4, *w4, **kw4), iters=10),
        library_ms=None, unfused_block_ms=time_ms(unfused, iters=20),
        **dev_time(unfused, "unfused_block_dev"),
        # its three launches (LN1 + qkv, K2's attention, out-proj + LN3 + FFN)
        phase_ms=device_ms_by_kernel(lambda: K4.dit_block_fused(x4, L4, *w4, **kw4)),
        plan=K4.plan(B4, T4, dim, 8, 64, ff), k2_shape=[B4, T4, 3 * inner], **k2_block,
        # x in and y out, the weights once, the fp32 vectors, the lengths
        bytes=(2 * B4 * T4 * dim + 3 * dim * inner + inner * dim + 2 * dim * ff) * isz
        + (6 * dim + ff) * 4 + 4 * B4,
        flops=sum(2 * T4 * dim * 3 * inner + 4 * 8 * T4 * Lb * 64 + 2 * T4 * inner * dim
                  + 4 * T4 * dim * ff for Lb in lens4),
        max_abs_err=k4_err))
    # K7: one AAAct at each stage shape of the bigvgan phase, fp32, with x
    # channels-first (the convolutions' memory: the path's layout) and, nested,
    # channels-last (the TPU kernel's layout); no single PyTorch call computes
    # it, so the library column times the composite (upsample2 -> snake_beta
    # -> downsample2) on the same channels-first x
    for shape in K7_STAGES:
        x7, a7, b7, _ = snake_inputs(shape, True, True, g)
        x7cf = channels_first(x7)
        want = K7.snake_aa_plain(x7, a7, b7)
        tag = "x".join(map(str, shape))
        err_cf, err_cl = (check(f"snake_aa_{tag}_{lay}", torch.float32,
                                K7.snake_aa(xx, a7, b7), want, phase="timing")
                          for lay, xx in (("channels_first", x7cf), ("channels_last", x7)))
        del want
        k7 = lambda: K7.snake_aa(x7cf, a7, b7)
        k7_cl = lambda: K7.snake_aa(x7, a7, b7)
        composite = lambda: anti_alias_activation(x7cf, a7, b7)
        B7, T7, C7 = shape
        row = dict(
            name="snake_aa", source="cosyvoice_tpu_torch/csrc/snake_aa.cu",
            replaces="cosyvoice_tpu/ops/pallas/snake_aa.py:99", shape=list(shape),
            dtype="float32", layout="channels_first",
            plan=K7.plan(B7, T7, C7, K7.CHANNELS_FIRST, sms),
            ms=time_ms(k7, iters=20), **dev_time(k7),
            plain_ms=time_ms(lambda: K7.snake_aa_plain(x7cf, a7, b7), iters=10),
            library_ms=time_ms(composite, iters=10), **dev_time(composite, "library_dev"),
            library_call="composite anti_alias_activation (upsample2 -> snake_beta -> "
                         "downsample2)",
            channels_last=dict(plan=K7.plan(B7, T7, C7, K7.CHANNELS_LAST, sms),
                               ms=time_ms(k7_cl, iters=20), **dev_time(k7_cl),
                               max_abs_err=err_cl),
            # x read and y written once, alpha and beta once, in fp32
            bytes=2 * x7.numel() * 4 + 2 * C7 * 4, flops=K7_FLOPS_PER_OUTPUT * x7.numel(),
            peak_flops=FP32_FLOPS, max_abs_err=err_cf)
        if shape == K7_STAGES[2]:
            # the copy that AAAct made ahead of each launch until K7 took
            # channels-first x: what the path no longer pays
            copy = lambda: x7cf.contiguous()
            row.update(layout_copy_ms=time_ms(copy, iters=20),
                       **dev_time(copy, "layout_copy_dev"))
        rows.append(row)
        del x7, x7cf
        torch.cuda.empty_cache()
    for row in rows:
        row.setdefault("peak_flops", BF16_FLOPS)
        t_bytes = row["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = row["flops"] / row["peak_flops"] * 1e3
        row.update(route="cuda", bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
    return rows


def main() -> int:
    t_run = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on a GPU",
              file=sys.stderr)
        return 1
    from cosyvoice_tpu_torch.ops.kernels import build
    from cosyvoice_tpu_torch.ops.kernels import dit_attention as K2
    from cosyvoice_tpu_torch.ops.kernels import dit_block as K4
    from cosyvoice_tpu_torch.ops.kernels import fused_norm as K3
    from cosyvoice_tpu_torch.ops.kernels import int4_matmul as K5
    from cosyvoice_tpu_torch.ops.kernels import lm_decode_attention as K1
    from cosyvoice_tpu_torch.ops.kernels import lm_step as K6
    from cosyvoice_tpu_torch.ops.kernels import snake_aa as K7

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # inference throughout; the train phase turns gradients on for itself
    # (a kernel launch refuses tensors that want a gradient)
    torch.set_grad_enabled(False)
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    build.library()
    ptxas = [ln.strip() for ln in build.report["ptxas"].splitlines()
             if "Used" in ln or "Compiling entry" in ln or ln.startswith("==")]
    emit({"phase": "build", "seconds": build.report["seconds"],
          "cached": build.report["cached"], "ptxas": ptxas})

    seconds = {}                        # each phase's wall seconds, in order

    def clocked(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = time.perf_counter() - t0
        return out

    errs = clocked("kernels", kernel_checks, K1, K2, K3)
    errs.update(clocked("quant_kernels", quant_kernel_checks, K5, K6))
    errs["dit_block"] = clocked("block_kernel", block_checks, K4)
    errs["snake_aa"] = clocked("snake_kernel", snake_checks, K7)
    clocked("reference", reference_check)
    res = clocked("main_path", main_path, K1, K2, K3, smi)
    clocked("trace", trace_phase, res, smi)
    # later slices' paths: K6 from the fused_step phase, K5 from the int4
    # phase, K4 from the batched phase (the engine phase drives K1 per row),
    # K7 from the bigvgan phase (the stream phase drives K1-K3)
    launches = dict(res["launches"])
    launches["lm_step"] = clocked("fused_step", fused_step_phase, res["stack"][0],
                                  res["first_prompt"], K1, K6, smi)["k6_launches"]
    launches["int4_matmul"] = clocked("int4", int4_phase, res, K1, K5, smi)["k5_launches"]
    batched = clocked("batched", batched_phase, res, K1, K4, smi)
    launches["dit_block"] = batched["k4_launches"]
    k1_engine = clocked("engine", engine_phase, res, K1, smi)["full_width_int8"]["k1_launches"]
    vocoder = clocked("bigvgan", bigvgan_phase, K7, smi)
    launches["snake_aa"] = vocoder["k7_launches"]
    b1 = clocked("stream", stream_phase, res, K1, K2, K3, smi)["first_chunk_latency_s"]
    cont = clocked("continuous", continuous_phase, res, b1, K1, K2, K3, smi)
    clocked("serve", serve_phase, res, smi)
    ckpt = clocked("checkpoint", checkpoint_phase, res, K1, K2, K3, K5, smi)["full_width"]
    kernels = {"lm_decode_attention": K1, "dit_attention": K2, "fused_layer_norm": K3,
               "dit_block": K4, "int4_matmul": K5, "lm_step": K6, "snake_aa": K7}
    v1 = clocked("v1", v1_phase, kernels, smi)
    pho = clocked("phoneme", phoneme_phase, res, kernels, smi)
    lam = clocked("lam", lam_phase, kernels, smi)
    mc = clocked("multicode", multicode_phase, kernels, smi)
    clocked("train", train_phase, kernels, smi)
    gan = clocked("gan", gan_phase, kernels, smi)
    deploy = clocked("deploy", deploy_phase, kernels, smi)
    pho_train = clocked("pho_train", pho_train_phase, kernels, smi)
    flow = res["stack"][1]
    exported = clocked("export", export_phase, flow, kernels, smi)
    del res["stack"], res["model"], res["request"]
    multi = clocked("multi_card", multi_card_phase, kernels, smi)
    rows = clocked("timing", timing, K1, K2, K3, K4, K5, K6, K7, res["last_decode"], flow,
                   batched["block_shape"])
    # K1 at the tensor-parallel local heads, K5 at the local MLP shards
    for row in multi["k1_rows"] + multi["k5_rows"]:
        t_bytes = row["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = row["flops"] / BF16_FLOPS * 1e3
        rows.append(dict(row, route="cuda", peak_flops=BF16_FLOPS, bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops else "operations"))
    tolerance = {"lm_step": K6_REL_TOL[torch.bfloat16],
                 "dit_block": {"bf16_ulps_at_max_plain": K4_BF16_ULPS},
                 "dit_attention": {"bf16_ulps_at_max_plain_per_row_head": K2_BF16_ULPS},
                 "snake_aa": CHECK_TOL[torch.float32]}
    for row in rows:
        if row["name"] == "snake_aa":
            # the bigvgan forward's launches at this row's stage shape
            row["launches"] = vocoder["k7_launches_by_stage"].get(
                "x".join(map(str, row["shape"][1:])), 0)
        elif row.get("launches_from", "").startswith("multi_card"):
            # K5: the TP decode's one-row calls at this row's shape
            row["launches"] = (multi["k1_tp_full_launches"] if row["name"] == "lm_decode_attention"
                               else multi["k5_tp_by_shape"]["x".join(map(str, row["shape"]))])
        else:
            row["launches"] = k1_engine if "launches_from" in row else launches[row["name"]]
        row["launches_continuous"] = {
            mode: cont[mode]["launches"].get(row["name"], 0)
            for mode in ("windowed", "incremental")}
        row["launches_checkpoint"] = {
            quant: ckpt[quant]["launches"].get(row["name"], 0) for quant in ("int8", "int4")}
        # the v1 phase's four requests; K2 and K3 also at its estimator's shapes
        row["launches_v1"] = v1["launches"][row["name"]]
        if row["name"] in v1["kernel_times"]:
            row["v1_shapes"] = v1["kernel_times"][row["name"]]
        # the phoneme phase's full-width runs
        row["launches_phoneme"] = {
            "b1_generate": pho["b1_generate"]["launches"][row["name"]],
            "streams": pho["streams"]["launches"][row["name"]],
            "v1_generate": pho["v1_generate"]["launches"][row["name"]]}
        # the lam phase's chain (speaker vector -> phoneme LM -> VITS)
        row["launches_lam"] = lam["chain"]["launches"][row["name"]]
        # the multicode phase's full-width B=1 and B=4 decodes
        row["launches_multicode"] = {run: mc["launches"][run][row["name"]]
                                     for run in ("b1", "b4_ragged")}
        row["launches_gan"] = gan["launches"][row["name"]]
        row["launches_deploy"] = deploy["launches"][row["name"]]
        row["launches_pho_train"] = pho_train["launches"][row["name"]]
        # the multi_card phase's ranks (summed) under DP(2) and under TP(2)
        row["launches_multi_card"] = {run: multi["launches"][run].get(row["name"], 0)
                                      for run in ("dp", "tp")}
        row["launches_multi_card"]["int4_tp"] = (multi["k5_tp_launches"]
                                                 if row["name"] == "int4_matmul" else 0)
        # inside the reloaded exported estimators (the export phase)
        row["launches_export"] = exported["launches"].get(row["name"], 0)
        row.update(edge_max_abs_err=errs[row["name"]],
                   tolerance=tolerance.get(row["name"], CHECK_TOL[torch.bfloat16]),
                   kernel_ms=row["ms"])
    emit({"phase": "run", "seconds": time.perf_counter() - t_run, "phase_seconds": seconds})
    print(smi, flush=True)
    emit({"kernels": rows, "card": smi})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--flow-stage"]:
        sys.exit(flow_stage_main(sys.argv[2:]))
    sys.exit(main())
