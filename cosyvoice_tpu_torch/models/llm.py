"""Speech-token LMs: CosyVoice2's Qwen2 body + speech head, CosyVoice v1's
TransformerLM, and their AR decode loops.

Port of cosyvoice_tpu/models/llm.py (Qwen2LM, lm_generate, the chunked
decode of streaming synthesis (lm_prefill_stream, lm_decode_chunk), the
decode loop from packed prefix embeddings that the phoneme LMs share
(lm_prefill_from_embeds, lm_generate_from_embeds), the B=1 whole-step
decode lm_generate_fused_step and the AWQ calibration pass
collect_act_stats; TransformerLM with
lm_generate_v1 and its streaming pair lm_prefill_stream_v1 /
lm_decode_chunk_v1, over a conformer KV cache, B=1 as in the JAX package).
Inputs are [sos, text_emb(prompt_text ++ text), task,
speech_emb(prompt_speech)]; decode is causal and KV-cached, one token per
step; EOS is masked while step < min_len; decoding stops at EOS or max_len;
sampled ids above EOS are not emitted and the previous input embedding is
fed again.  v1 inputs are [sos, speaker, text_encoder(text), task,
speech_emb(prompt_speech)] (no speaker slot without a vector), and v1 masks
EOS at the first step only.  The JAX package's `lax.while_loop` is a Python
loop here over a preallocated cache, and its PRNG keys are one explicit
torch.Generator.

Parameter names follow the reference checkpoints (`llm.model.model.*` for
the Qwen2 body, `llm_embedding`, `speech_embedding`, `llm_decoder`; v1's
`text_embedding`, `text_encoder.*`, `text_encoder_affine_layer`, `llm.*`,
`spk_embed_affine_layer`).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.nn as nn

from cosyvoice_tpu_torch.models.conformer import (ConformerConfig, ConformerEncoder,
                                                  ConformerKVCache)
from cosyvoice_tpu_torch.models.qwen2 import (KVCache, Qwen2Config, Qwen2Model,
                                              causal_prefill_bias, rms_norm, rope_cos_sin)
from cosyvoice_tpu_torch.nn.dense import Dense
from cosyvoice_tpu_torch.ops import sampling as samp
from cosyvoice_tpu_torch.ops.kernels.lm_step import (StepWeights, cache_to_step_layout,
                                                     lm_step)
from cosyvoice_tpu_torch.ops.masks import NEG_INF, make_non_pad_mask
from cosyvoice_tpu_torch.parallel.collectives import (ModelGroup, ParallelDense,
                                                      ParallelEmbedding)

IGNORE_ID = -1


@dataclass(frozen=True)
class SamplingConfig:
    method: str = "ras"  # ras | non_random_ras | nucleus | greedy
    top_p: float = 0.8
    top_k: int = 25
    win_size: int = 10
    tau_r: float = 0.1
    expand_scale: int = 2  # non_random_ras: the fallback nucleus's top_k factor


@dataclass(frozen=True)
class LMConfig:
    llm_input_size: int = 896
    llm_output_size: int = 896
    speech_token_size: int = 6561
    # the training loss (masked_ce_loss): divide by the target count (else by
    # the batch's example count), and the label-smoothing weight
    length_normalized_loss: bool = True
    lsm_weight: float = 0.0
    sampling: SamplingConfig = field(default_factory=SamplingConfig)
    qwen: Qwen2Config = field(default_factory=Qwen2Config)
    min_token_text_ratio: float = 2.0
    max_token_text_ratio: float = 20.0

    @property
    def sos_eos(self) -> int:
        return 0

    @property
    def task_id(self) -> int:
        return 1

    @property
    def eos_token(self) -> int:
        return self.speech_token_size


class _Holder(nn.Module):
    """One level of the reference's `llm.model.model` nesting."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model


class Qwen2LM(nn.Module):
    # the model group once sharded by tensor parallelism (shard_), else None
    tp: Optional[ModelGroup] = None

    def __init__(self, cfg: LMConfig = LMConfig()):
        super().__init__()
        self.cfg = cfg
        self.llm = _Holder(_Holder(Qwen2Model(cfg.qwen)))
        self.llm_embedding = nn.Embedding(2, cfg.llm_input_size)
        # vocabulary-parallel under tensor parallelism (parallel/mesh.py): the
        # head's logits are gathered, so every rank samples the same token
        self.speech_embedding = ParallelEmbedding(cfg.speech_token_size + 3,
                                                  cfg.llm_input_size)
        self.llm_decoder = ParallelDense(cfg.llm_output_size, cfg.speech_token_size + 3)

    @property
    def body(self) -> Qwen2Model:
        return self.llm.model.model

    def tp_blocks(self, size: int) -> list[str]:
        """The speech embedding and head, vocabulary-parallel over `size`
        ranks when the speech vocabulary divides (the body names its own
        blocks: Qwen2Model.tp_blocks)."""
        vocab = self.cfg.speech_token_size + 3
        return ["speech_embedding", "llm_decoder"] if vocab % size == 0 else []

    def shard_(self, tp: ModelGroup) -> None:
        """Run as this rank's part of the model group `tp`, after the body's
        shard_: the config takes the body's local one, the vocabulary-parallel
        modules the group."""
        self.tp = tp
        self.cfg = dataclasses.replace(self.cfg, qwen=self.body.cfg)
        if self.tp_blocks(tp.size):
            self.speech_embedding.tp = self.llm_decoder.tp = tp

    def prefill_embeds(self, text, text_len, prompt_speech, prompt_speech_len):
        """Pack [sos, text_emb, task, speech_emb] per row (right-padded).
        text [B, Tt], prompt_speech [B, Ts] -> (embeds [B, 2+Tt+Ts, D], seq_len [B])."""
        B, Tt = text.shape
        Ts = prompt_speech.shape[1]
        dev = text.device
        text_emb = self.body.embed_tokens(text)
        sos = self.llm_embedding.weight[self.cfg.sos_eos]
        task = self.llm_embedding.weight[self.cfg.task_id]
        N = 2 + Tt + Ts
        pos = torch.arange(N, device=dev)[None, :]
        tl = text_len[:, None]
        in_text = (pos >= 1) & (pos < 1 + tl)
        is_task = pos == 1 + tl
        in_speech = (pos > 1 + tl) & (pos < 2 + tl + prompt_speech_len[:, None])
        D = text_emb.shape[-1]
        gt = torch.gather(text_emb, 1, (pos - 1).clamp(0, Tt - 1).expand(B, N)[..., None]
                          .expand(B, N, D))
        if Ts > 0:
            speech_emb = self.speech_embedding(prompt_speech)
            gs = torch.gather(speech_emb, 1, (pos - 2 - tl).clamp(0, Ts - 1)[..., None]
                              .expand(B, N, D))
        else:
            gs = torch.zeros_like(gt)
        zero = torch.zeros((), dtype=text_emb.dtype, device=dev)
        emb = torch.where(pos[..., None] == 0, sos,
              torch.where(in_text[..., None], gt,
              torch.where(is_task[..., None], task,
              torch.where(in_speech[..., None], gs, zero))))
        return emb, 2 + text_len + prompt_speech_len

    def forward_hidden(self, embeds, positions, attn_bias, cache=None):
        return self.body(embeds, positions, attn_bias, cache)

    def decode_logits(self, hidden):
        return self.llm_decoder(hidden)

    def speech_emb(self, tokens):
        return self.speech_embedding(tokens)

    # ---- training -----------------------------------------------------------

    def _trainable(self) -> None:
        if self.cfg.qwen.quant != "none":
            raise ValueError(f"training takes float weights; this LM is quantized "
                             f"({self.cfg.qwen.quant!r})")

    def forward(self, text, text_len, speech, speech_len) -> dict:
        """Training loss over [IGNORE x (1 + text_len), speech, EOS]: text
        [B, Tt], speech [B, Ts] (right-padded) -> {"loss", "acc"}.  Attention
        is causal + padding, as HF Qwen2 applies it to the reference's pad
        mask."""
        self._trainable()
        emb, seq_len = self.prefill_embeds(text, text_len, speech, speech_len)
        return self._ce_over_prefix(emb, seq_len, speech, text_len, speech_len, 1)

    def _causal_hidden(self, emb, seq_len) -> torch.Tensor:
        """The body over packed embeds emb [B, N, D] (seq_len [B] valid rows)
        with causal + padding attention -> hidden [B, N, D]."""
        B, N, _ = emb.shape
        ar = torch.arange(N, device=emb.device)
        pad = make_non_pad_mask(seq_len, N)
        causal = ar[None, :] <= ar[:, None]
        bias = torch.where(causal[None, None] & pad[:, None, None, :], 0.0,
                           NEG_INF).to(emb.dtype)
        return self.body(emb, ar[None].expand(B, N), bias)[0]

    def _ce_over_prefix(self, emb, seq_len, speech, n_before, speech_len, first: int) -> dict:
        """_causal_hidden, then the masked CE and accuracy of the speech
        targets that start at position first + n_before."""
        cfg = self.cfg
        logits = self.llm_decoder(self._causal_hidden(emb, seq_len))
        target = _speech_targets(speech, n_before, speech_len, emb.shape[1], first,
                                 cfg.eos_token)
        return {"loss": masked_ce_loss(logits, target, cfg.lsm_weight,
                                       cfg.length_normalized_loss),
                "acc": masked_accuracy(logits, target),
                "denom": ce_denominator(target, cfg.length_normalized_loss)}

    def packed_call(self, ids, types, positions, seg, target) -> dict:
        """Sequence-packed training loss (train/packing.py builds the
        arrays): each row holds several [sos, text, task, speech] examples
        back to back.  ids [B, N] per-type embedding indices; types [B, N]
        0 pad, 1 text, 2 sos/task, 3 speech; positions [B, N] restart at
        each example; seg [B, N] example id (1-based, 0 pad); target [B, N]
        next-token labels, IGNORE_ID elsewhere.  Attention is block-diagonal
        causal, so the loss equals forward() on the same examples; with
        length_normalized_loss False the divisor is the example count."""
        self._trainable()
        cfg = self.cfg
        B, N = ids.shape
        zero = torch.zeros_like(ids)
        te = self.body.embed_tokens(torch.where(types == 1, ids, zero))
        le = self.llm_embedding(torch.where(types == 2, ids.clamp_max(1), zero))
        se = self.speech_embedding(torch.where(types == 3, ids, zero))
        emb = torch.where((types == 1)[..., None], te,
              torch.where((types == 2)[..., None], le,
              torch.where((types == 3)[..., None], se, torch.zeros_like(te))))
        ar = torch.arange(N, device=ids.device)
        causal = ar[None, :] <= ar[:, None]
        same = (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] > 0)
        bias = torch.where(causal[None] & same, 0.0, NEG_INF).to(emb.dtype)[:, None]
        hidden, _ = self.body(emb, positions, bias)
        logits = self.llm_decoder(hidden)
        denom = None if cfg.length_normalized_loss else seg.amax(dim=1).sum()
        return {"loss": masked_ce_loss(logits, target, cfg.lsm_weight,
                                       cfg.length_normalized_loss, denom=denom),
                "acc": masked_accuracy(logits, target),
                "denom": ce_denominator(target, cfg.length_normalized_loss, denom)}


def _speech_targets(speech, text_len, speech_len, N: int, first: int, eos: int):
    """Next-token labels [B, N] of a packed prefix whose speech tokens start
    at position first + 1 + text_len: position p predicts token p + 1, so
    the speech targets start at first + text_len and EOS follows the last;
    IGNORE_ID elsewhere."""
    B, Ts = speech.shape
    pos = torch.arange(N, device=speech.device)[None, :]
    tl, sl = text_len[:, None], speech_len[:, None]
    tgt = torch.gather(speech, 1, (pos - first - tl).clamp(0, Ts - 1).expand(B, N))
    is_speech = (pos >= first + tl) & (pos < first + tl + sl)
    ignore = torch.full_like(tgt, IGNORE_ID)
    return torch.where(is_speech, tgt,
                       torch.where(pos == first + tl + sl, torch.full_like(tgt, eos), ignore))


def masked_ce_loss(logits, target, smoothing: float = 0.0, length_normalized: bool = True,
                   denom=None) -> torch.Tensor:
    """wenet's LabelSmoothingLoss with IGNORE_ID masking, in fp32: KL to the
    smoothed target (confidence 1 - smoothing at the target, smoothing /
    (V - 1) elsewhere) in closed form, without a [.., V] target tensor.
    Divided by the target count, or with length_normalized False by the
    batch size (`denom` overrides either: a packed batch's example count)."""
    V = logits.shape[-1]
    valid = target != IGNORE_ID
    logp = torch.log_softmax(logits.float(), dim=-1)
    logp_tgt = torch.gather(logp, -1, target.clamp_min(0)[..., None])[..., 0]
    if smoothing > 0.0:
        conf, sm = 1.0 - smoothing, smoothing / (V - 1)
        ent = conf * math.log(conf) + (V - 1) * sm * math.log(sm)
        nll = ent - conf * logp_tgt - sm * (logp.sum(dim=-1) - logp_tgt)
    else:
        nll = -logp_tgt
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    if denom is None:
        denom = valid.sum() if length_normalized else logits.shape[0]
    return nll.sum() / torch.clamp(torch.as_tensor(denom, device=nll.device), min=1)


def ce_denominator(target, length_normalized: bool = True, denom=None) -> torch.Tensor:
    """The count masked_ce_loss divides by, before its clamp at 1: a
    data-parallel step (train/step.py) sums it over the data ranks so that
    the ranks' losses add up to the loss of the whole batch."""
    if denom is None:
        denom = (target != IGNORE_ID).sum() if length_normalized else target.shape[0]
    return torch.as_tensor(denom, device=target.device).float()


def masked_accuracy(logits, target) -> torch.Tensor:
    valid = target != IGNORE_ID
    hit = (logits.argmax(dim=-1) == target) & valid
    return hit.sum() / valid.sum().clamp_min(1)


@dataclass
class GenState:
    cache: KVCache
    prev_emb: torch.Tensor   # [B, 1, D] next input embedding
    step: int                # decode steps taken (incl. non-emitted)
    count: torch.Tensor      # [B] emitted tokens
    done: torch.Tensor       # [B] bool
    out: torch.Tensor        # [B, max_steps] emitted ids
    recent: torch.Tensor     # [B, win] last emitted ids (RAS window)
    recent_n: torch.Tensor   # [B] valid entries in recent


def _sample(cfg: SamplingConfig, gen, logp, recent, recent_valid):
    if cfg.method == "greedy":
        return samp.greedy_sample(logp)
    if cfg.method == "nucleus":
        return samp.nucleus_sample(gen, logp, cfg.top_p, cfg.top_k)
    if cfg.method == "ras":
        return samp.ras_sample(gen, logp, recent, recent_valid, cfg.top_p, cfg.top_k,
                               cfg.win_size, cfg.tau_r)
    if cfg.method == "non_random_ras":
        return samp.non_random_ras_sample(gen, logp, recent, recent_valid, cfg.top_p,
                                          cfg.top_k, cfg.win_size, cfg.tau_r,
                                          cfg.expand_scale)
    raise ValueError(f"unknown sampling method {cfg.method!r}")


def _sample_from(model: Qwen2LM, hidden_last, state: GenState, min_len, gen):
    cfg = model.cfg
    logp = torch.log_softmax(model.decode_logits(hidden_last)[:, 0, :].float(), dim=-1)
    # EOS is not a candidate before min_len
    logp[:, cfg.eos_token] = torch.where(state.step < min_len, NEG_INF,
                                         logp[:, cfg.eos_token])
    win = cfg.sampling.win_size
    rv = torch.arange(win, device=logp.device)[None] < state.recent_n[:, None]
    return _sample(cfg.sampling, gen, logp, state.recent, rv)


def _sample_advance(model: Qwen2LM, state, hidden_last, min_len, max_len, gen) -> None:
    """One sampling step of every decode loop (lm_generate, the fused-step
    decode and the continuous-batching engine): sample from the last hidden
    state, then advance `state` in place.  `state.step` is an int (the batch
    in lockstep) or a [B] tensor (one frontier per engine slot); the math
    broadcasts either way, which keeps the engine's greedy tokens equal to
    lm_generate's."""
    _advance(model, state, _sample_from(model, hidden_last, state, min_len, gen), max_len)


def _advance(model, state: GenState, tok, max_len) -> None:
    """Emit tok where it is a speech token and the row is live; stop a row at
    EOS or max_len; feed the emitted token's embedding next (v1's table has
    no EOS row, so the id looked up is clamped to it: that embedding is
    never used)."""
    eos = model.cfg.eos_token
    B = tok.shape[0]
    rows = torch.arange(B, device=tok.device)
    emitted = (tok < eos) & ~state.done
    state.done = state.done | (tok == eos) | (state.step + 1 >= max_len)
    idx = state.count.clamp_max(state.out.shape[1] - 1)
    state.out[rows, idx] = torch.where(emitted, tok, state.out[rows, idx]).to(state.out.dtype)
    rolled = torch.cat([state.recent[:, 1:], tok[:, None].to(state.recent.dtype)], dim=1)
    state.recent = torch.where(emitted[:, None], rolled, state.recent)
    state.recent_n = torch.clamp(state.recent_n + emitted.int(), max=state.recent.shape[1])
    new_emb = model.speech_emb(tok.clamp_max(model.speech_embedding.num_embeddings - 1)[:, None])
    state.prev_emb = torch.where(emitted[:, None, None], new_emb, state.prev_emb)
    state.count = state.count + emitted.int()
    state.step += 1


@dataclass
class StreamState:
    """Carry of a chunked decode: the GenState, the per-row prefix lengths,
    the padded prefix length (decode slots start there), the cache length,
    the stopping bounds and the sampling generator."""

    gen: GenState
    seq_len: torch.Tensor    # [B]
    prefix_len: int
    cache_len: int
    min_len: torch.Tensor
    max_len: torch.Tensor
    rng: Optional[torch.Generator]


@torch.no_grad()
def lm_prefill_from_embeds(model: Qwen2LM, embeds, seq_len, min_len, max_len,
                           gen: Optional[torch.Generator], max_steps: int,
                           cache_len: int) -> StreamState:
    """Prefill over packed prefix embeddings [B, Tp, D] (right-padded rows
    of seq_len [B]) and the first sample; lm_decode_chunk takes it from
    there.  `model` is any LM with the decode contract: forward_hidden,
    decode_logits, speech_emb and cfg.{qwen, eos_token, sampling} (Qwen2LM
    and the phoneme LMs of models/llm_phoneme.py)."""
    cfg = model.cfg
    B, Tp, D = embeds.shape
    dev = embeds.device
    cache = KVCache.create(cfg.qwen, B, cache_len, embeds.dtype, dev)
    bias = causal_prefill_bias(Tp, cache_len, seq_len, B, embeds.dtype, dev)
    positions = torch.arange(Tp, device=dev)[None].expand(B, Tp)
    hidden, cache = model.forward_hidden(embeds, positions, bias, cache)
    # rows shorter than Tp leave garbage K/V in their pad slots, masked below
    last = hidden[torch.arange(B, device=dev), seq_len - 1][:, None]
    win = cfg.sampling.win_size
    state = GenState(cache=cache, prev_emb=torch.zeros((B, 1, D), dtype=embeds.dtype,
                                                       device=dev),
                     step=0, count=torch.zeros(B, dtype=torch.int32, device=dev),
                     done=torch.zeros(B, dtype=torch.bool, device=dev),
                     out=torch.zeros((B, max_steps), dtype=torch.int32, device=dev),
                     recent=torch.zeros((B, win), dtype=torch.int32, device=dev),
                     recent_n=torch.zeros(B, dtype=torch.int32, device=dev))
    _sample_advance(model, state, last, min_len, max_len, gen)
    return StreamState(state, seq_len, Tp, cache_len, min_len, max_len, gen)


@torch.no_grad()
def lm_prefill_stream(model: Qwen2LM, text, text_len, prompt_speech, prompt_speech_len,
                      min_len, max_len, gen: Optional[torch.Generator], max_steps: int,
                      cache_len: int) -> StreamState:
    """lm_prefill_from_embeds over the packed [sos,text,task,speech] prefix."""
    embeds, seq_len = model.prefill_embeds(text, text_len, prompt_speech,
                                           prompt_speech_len)
    return lm_prefill_from_embeds(model, embeds, seq_len, min_len, max_len, gen, max_steps,
                                  cache_len)


@torch.no_grad()
def lm_decode_chunk(model: Qwen2LM, stream: StreamState, n_steps: int) -> StreamState:
    """Advance the decode by up to n_steps steps, in place; stops early once
    every row is done (EOS or max_len) or the out buffer is full."""
    state = stream.gen
    max_steps = state.out.shape[1]
    slot = torch.arange(stream.cache_len, device=state.out.device)[None, :]
    prompt_ok = slot < stream.seq_len[:, None]
    start = state.step
    while (state.step < max_steps and state.step - start < n_steps
           and not bool(state.done.all())):
        pos = (stream.seq_len + state.step - 1)[:, None]
        valid = prompt_ok | ((slot >= stream.prefix_len) & (slot <= state.cache.pos))
        step_bias = torch.where(valid, 0.0, NEG_INF).to(state.prev_emb.dtype)[:, None, None, :]
        hidden, state.cache = model.forward_hidden(state.prev_emb, pos, step_bias,
                                                   state.cache)
        _sample_advance(model, state, hidden, stream.min_len, stream.max_len, stream.rng)
    return stream


@torch.no_grad()
def lm_generate_from_embeds(model: Qwen2LM, embeds, seq_len, min_len, max_len,
                            gen: Optional[torch.Generator], max_steps: int, cache_len: int):
    """The decode loop every Qwen2-body LM shares, from packed prefix
    embeddings: the prefill and one chunk that runs to the end.
    Returns (tokens [B, max_steps], count [B])."""
    stream = lm_prefill_from_embeds(model, embeds, seq_len, min_len, max_len, gen,
                                    max_steps, cache_len)
    state = lm_decode_chunk(model, stream, max_steps).gen
    return state.out, state.count


@torch.no_grad()
def lm_generate(model: Qwen2LM, text, text_len, prompt_speech, prompt_speech_len,
                min_len, max_len, gen: Optional[torch.Generator], max_steps: int,
                cache_len: int):
    """CosyVoice2 Qwen2LM generation over the packed [sos,text,task,speech]
    prefix (right-padded rows).  Returns (tokens [B, max_steps], count [B])."""
    embeds, seq_len = model.prefill_embeds(text, text_len, prompt_speech,
                                           prompt_speech_len)
    return lm_generate_from_embeds(model, embeds, seq_len, min_len, max_len, gen,
                                   max_steps, cache_len)


@torch.no_grad()
def collect_act_stats(model: Qwen2LM, text, text_len, speech, speech_len) -> dict:
    """AWQ calibration (utils/quant.awq_equalize): one teacher-forced pass
    over the packed [sos, text, task, speech] prefix recording the
    per-channel max |activation| at the input of every layer's q_proj
    (attn_in), gate_proj (mlp_in) and down_proj (down_in), over every row,
    pad rows included, as the JAX package's taps do.  The taps are forward
    pre-hooks, removed after the pass.  -> {layer: {attn_in, mlp_in,
    down_in}} fp32 CPU tensors; merge several batches with torch.maximum."""
    emb, seq_len = model.prefill_embeds(text, text_len, speech, speech_len)
    B, T = emb.shape[:2]
    dev = emb.device
    stats: dict = {}

    def tap(i, key):
        def hook(_module, args):
            x = args[0]
            stats.setdefault(i, {})[key] = x.abs().amax(dim=tuple(range(x.ndim - 1))).float().cpu()
        return hook

    hooks = []
    for i, layer in enumerate(model.body.layers):
        for proj, key in ((layer.self_attn["q_proj"], "attn_in"),
                          (layer.mlp["gate_proj"], "mlp_in"),
                          (layer.mlp["down_proj"], "down_in")):
            hooks.append(proj.register_forward_pre_hook(tap(i, key)))
    try:
        model.forward_hidden(emb, torch.arange(T, device=dev)[None].expand(B, T),
                             causal_prefill_bias(T, T, seq_len, B, emb.dtype, dev))
    finally:
        for h in hooks:
            h.remove()
    return stats


@dataclass
class FusedGenState:
    """GenState twin for the whole-step decode kernel: the cache lives in the
    kernel's stacked [L, C, KH*D] layout instead of a KVCache."""

    kc: torch.Tensor
    vc: torch.Tensor
    prev_emb: torch.Tensor
    step: int
    count: torch.Tensor
    done: torch.Tensor
    out: torch.Tensor
    recent: torch.Tensor
    recent_n: torch.Tensor


def lm_step_supported(cfg: Qwen2Config) -> bool:
    """Shapes and quantization the whole-step kernel handles (Qwen2-0.5B
    serving): int8 projections and head_dim 64, the one width it instantiates."""
    return (cfg.quant == "int8" and cfg.head_dim == 64
            and (cfg.num_kv_heads * cfg.head_dim) % 128 == 0
            and cfg.hidden_size % 128 == 0 and cfg.intermediate_size % 64 == 0
            and cfg.num_heads % cfg.num_kv_heads == 0)


@torch.no_grad()
def lm_generate_fused_step(model: Qwen2LM, step_w: StepWeights, text, text_len,
                           prompt_speech, prompt_speech_len, min_len, max_len,
                           gen: Optional[torch.Generator], max_steps: int, cache_len: int):
    """B=1 generation with the whole-step decode kernel (ops/kernels/lm_step.py).

    Prefill runs the normal forward into a KVCache, which is repacked once
    into the kernel's stacked [L, C, KH*D] layout; every decode step is then
    one `lm_step` launch (all layers; it writes the step's k/v into the cache
    at `pos` itself) plus the small tail: final RMSNorm, head, sampling and
    the next embedding.  step_w = pack_step_weights(model.body.state_dict(),
    L), built once at load.  Sampling and stopping are lm_generate's, so
    greedy tokens equal lm_generate's wherever the two bodies agree.
    Returns (tokens [1, max_steps], count [1])."""
    cfg = model.cfg
    q = cfg.qwen
    if text.shape[0] != 1:
        raise ValueError("lm_generate_fused_step decodes one row (B=1)")
    if model.tp is not None:
        raise NotImplementedError(
            "the whole-step decode kernel (lm_step) under tensor parallelism: the JAX "
            "package has no such route (no code of it calls lm_generate_fused_step, "
            "cosyvoice_tpu/models/llm.py:411, and its mesh tests have no such case); "
            "decode a sharded LM with lm_generate")
    embeds, seq_len = model.prefill_embeds(text, text_len, prompt_speech,
                                           prompt_speech_len)
    Tp, D = embeds.shape[1:]
    dev = embeds.device
    cache = KVCache.create(q, 1, cache_len, embeds.dtype, dev)
    bias = causal_prefill_bias(Tp, cache_len, seq_len, 1, embeds.dtype, dev)
    hidden, cache = model.forward_hidden(embeds, torch.arange(Tp, device=dev)[None], bias,
                                         cache)
    last = hidden[:, int(seq_len[0]) - 1][:, None]
    kc, vc = cache_to_step_layout(cache.k, cache.v, cache_len)
    del cache
    win = cfg.sampling.win_size
    state = FusedGenState(
        kc=kc, vc=vc, prev_emb=torch.zeros((1, 1, D), dtype=embeds.dtype, device=dev),
        step=0, count=torch.zeros(1, dtype=torch.int32, device=dev),
        done=torch.zeros(1, dtype=torch.bool, device=dev),
        out=torch.zeros((1, max_steps), dtype=torch.int32, device=dev),
        recent=torch.zeros((1, win), dtype=torch.int32, device=dev),
        recent_n=torch.zeros(1, dtype=torch.int32, device=dev))
    _sample_advance(model, state, last, min_len, max_len, gen)
    norm_w = model.body.norm.weight
    seq0 = int(seq_len[0])
    while state.step < max_steps and not bool(state.done.all()):
        pos = seq0 + state.step - 1
        cos, sin = rope_cos_sin(torch.tensor([[pos]], device=dev), q.head_dim,
                                q.rope_theta, torch.float32)
        y = lm_step(step_w, state.prev_emb[0], state.kc, state.vc, pos, cos[0, 0],
                    sin[0, 0], nq=q.num_heads, nkv=q.num_kv_heads, hd=q.head_dim,
                    eps=q.rms_norm_eps)
        hid = rms_norm(y, norm_w, q.rms_norm_eps)[None]
        _sample_advance(model, state, hid, min_len, max_len, gen)
    return state.out, state.count


# --------------------------------------------------------------------------
# CosyVoice v1: TransformerLM over a conformer KV cache
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class TransformerLMConfig:
    """The CosyVoice-300M LM (the reference's cosyvoice.yaml)."""

    text_encoder_input_size: int = 512
    llm_input_size: int = 1024
    llm_output_size: int = 1024
    text_token_size: int = 60515
    speech_token_size: int = 4096
    spk_embed_dim: int = 192
    # the training loss, as LMConfig's
    length_normalized_loss: bool = True
    lsm_weight: float = 0.0
    sampling: SamplingConfig = field(default_factory=lambda: SamplingConfig(
        method="non_random_ras", top_p=0.8, top_k=10, win_size=50, tau_r=0.1))
    text_encoder: ConformerConfig = field(default_factory=lambda: ConformerConfig(
        dim=1024, heads=16, linear_units=4096, num_blocks=6, input_size=512,
        static_chunk_size=1, attention_dropout_rate=0.0))
    llm: ConformerConfig = field(default_factory=lambda: ConformerConfig(
        dim=1024, heads=16, linear_units=4096, num_blocks=14, input_size=1024,
        static_chunk_size=1, input_layer="linear_legacy", activation="relu",
        attention_dropout_rate=0.0))
    min_token_text_ratio: float = 2.0
    max_token_text_ratio: float = 20.0

    @property
    def eos_token(self) -> int:
        return self.speech_token_size


class TransformerLM(nn.Module):
    """The v1 speech-token LM: a causal conformer text encoder, then a
    causal transformer body over [sos, speaker, text, task, speech]."""

    def __init__(self, cfg: TransformerLMConfig = TransformerLMConfig()):
        super().__init__()
        self.cfg = cfg
        self.text_embedding, text_encoder = self._text_front(cfg)
        self.text_encoder = ConformerEncoder(text_encoder)
        self.text_encoder_affine_layer = Dense(cfg.text_encoder.dim, cfg.llm_input_size)
        self.llm_embedding = nn.Embedding(2, cfg.llm_input_size)
        self.llm = ConformerEncoder(cfg.llm, transformer_layer=True)
        self.llm_decoder = Dense(cfg.llm_output_size, cfg.speech_token_size + 1)
        self.speech_embedding = nn.Embedding(cfg.speech_token_size, cfg.llm_input_size)
        self.spk_embed_affine_layer = Dense(cfg.spk_embed_dim, cfg.llm_input_size)

    def _text_front(self, cfg) -> tuple[nn.Module, ConformerConfig]:
        """The text embedding table and the text encoder's config (the v1
        phoneme LM takes its factored embedding and speaker adaptation)."""
        return nn.Embedding(cfg.text_token_size, cfg.text_encoder_input_size), cfg.text_encoder

    def encode_text(self, text, text_len):
        """text ids [B, Tt] -> [B, Tt, llm_input_size] through the causal
        (static chunk 1) conformer."""
        h, _ = self.text_encoder(self.text_embedding(text), text_len)
        return self.text_encoder_affine_layer(h)

    def prefill_embeds(self, text, text_len, prompt_speech, prompt_speech_len,
                       embedding: Optional[torch.Tensor]):
        """Pack [sos, spk, text_enc, task, speech_emb] per row (right-padded);
        with embedding None (or empty) the speaker slot is left out.
        -> (embeds [B, N, D], seq_len [B])."""
        return self._pack_prefix(self.encode_text(text, text_len), text_len, prompt_speech,
                                 prompt_speech_len, embedding)

    def _pack_prefix(self, text_h, text_len, prompt_speech, prompt_speech_len,
                     embedding: Optional[torch.Tensor]):
        """prefill_embeds' packing of the encoded text text_h [B, Tt, D]."""
        B, Tt, D = text_h.shape
        Ts = prompt_speech.shape[1]
        dev = text_h.device
        has_spk = embedding is not None and embedding.shape[-1] > 0
        n_fixed = 2 if has_spk else 1
        N = n_fixed + Tt + 1 + Ts
        pos = torch.arange(N, device=dev)[None, :]
        tl = text_len[:, None]
        in_text = (pos >= n_fixed) & (pos < n_fixed + tl)
        is_task = pos == n_fixed + tl
        in_speech = (pos > n_fixed + tl) & (pos < n_fixed + 1 + tl + prompt_speech_len[:, None])
        gt = torch.gather(text_h, 1, (pos - n_fixed).clamp(0, Tt - 1).expand(B, N)[..., None]
                          .expand(B, N, D))
        if Ts > 0:
            gs = torch.gather(self.speech_embedding(prompt_speech), 1,
                              (pos - n_fixed - 1 - tl).clamp(0, Ts - 1)[..., None]
                              .expand(B, N, D))
        else:
            gs = torch.zeros_like(gt)
        zero = torch.zeros((), dtype=text_h.dtype, device=dev)
        emb = torch.where(pos[..., None] == 0, self.llm_embedding.weight[0],
              torch.where(in_text[..., None], gt,
              torch.where(is_task[..., None], self.llm_embedding.weight[1],
              torch.where(in_speech[..., None], gs, zero))))
        if has_spk:
            spk = embedding / embedding.norm(dim=-1, keepdim=True).clamp_min(1e-12)
            spk = self.spk_embed_affine_layer(spk.to(text_h.dtype))[:, None, :]
            emb = torch.where(pos[..., None] == 1, spk, emb)
        return emb, n_fixed + 1 + text_len + prompt_speech_len

    def forward(self, text, text_len, speech, speech_len, embedding) -> dict:
        """Training loss over [IGNORE x (2 + text_len), speech, EOS]: the
        targets assume the speaker slot, as the JAX package's do, so pass
        an embedding.  -> {"loss", "acc"}.  The body is causal by its static
        chunk of 1; the conformers' dropout follows train() / eval()."""
        cfg = self.cfg
        emb, seq_len = self.prefill_embeds(text, text_len, speech, speech_len, embedding)
        hidden, _ = self.llm(emb, seq_len)
        logits = self.llm_decoder(hidden)
        target = _speech_targets(speech, text_len, speech_len, emb.shape[1], 2,
                                 cfg.eos_token)
        return {"loss": masked_ce_loss(logits, target, cfg.lsm_weight,
                                       cfg.length_normalized_loss),
                "acc": masked_accuracy(logits, target),
                "denom": ce_denominator(target, cfg.length_normalized_loss)}

    def llm_prefill(self, embeds, cache: ConformerKVCache):
        return self.llm.prefill(embeds, cache)

    def llm_decode_step(self, x, cache: ConformerKVCache):
        return self.llm.decode_step(x, cache)

    def decode_logits(self, hidden):
        return self.llm_decoder(hidden)

    def speech_emb(self, tokens):
        return self.speech_embedding(tokens)


@dataclass
class StreamStateV1:
    """Carry of a chunked v1 decode: the GenState (over a ConformerKVCache),
    the EOS mask's bound (1: the first step only), the stopping bound and the
    sampling generator."""

    gen: GenState
    min_len: torch.Tensor
    max_len: torch.Tensor
    rng: Optional[torch.Generator]


@torch.no_grad()
def lm_prefill_stream_v1(model: TransformerLM, text, text_len, prompt_speech,
                         prompt_speech_len, embedding: Optional[torch.Tensor], max_len,
                         gen: Optional[torch.Generator], max_steps: int,
                         cache_len: int) -> StreamStateV1:
    """Prefill the conformer cache over the packed prefix and take the first
    sample (EOS masked).  B=1: the prefill writes a padded row's pad slots."""
    if text.shape[0] != 1:
        raise ValueError("the v1 decode is exact for B=1 only (the prefill writes "
                         "unmasked K/V for rows shorter than the padded prefix)")
    cfg = model.cfg
    embeds, seq_len = model.prefill_embeds(text, text_len, prompt_speech, prompt_speech_len,
                                           embedding)
    B, _, D = embeds.shape
    dev = embeds.device
    cache = ConformerKVCache.create(cfg.llm, B, cache_len, embeds.dtype, dev)
    hidden, cache = model.llm_prefill(embeds, cache)
    last = hidden[torch.arange(B, device=dev), seq_len - 1][:, None]
    win = cfg.sampling.win_size
    state = GenState(cache=cache, prev_emb=torch.zeros((B, 1, D), dtype=embeds.dtype,
                                                       device=dev),
                     step=0, count=torch.zeros(B, dtype=torch.int32, device=dev),
                     done=torch.zeros(B, dtype=torch.bool, device=dev),
                     out=torch.zeros((B, max_steps), dtype=torch.int32, device=dev),
                     recent=torch.zeros((B, win), dtype=torch.int32, device=dev),
                     recent_n=torch.zeros(B, dtype=torch.int32, device=dev))
    stream = StreamStateV1(state, torch.ones(B, dtype=torch.long, device=dev), max_len, gen)
    _sample_advance(model, state, last, stream.min_len, max_len, gen)
    return stream


@torch.no_grad()
def lm_decode_chunk_v1(model: TransformerLM, stream: StreamStateV1,
                       n_steps: int) -> StreamStateV1:
    """Advance the v1 decode by up to n_steps steps, in place; stops early
    at EOS, max_len or a full out buffer."""
    state = stream.gen
    max_steps = state.out.shape[1]
    start = state.step
    while (state.step < max_steps and state.step - start < n_steps
           and not bool(state.done.all())):
        hidden, state.cache = model.llm_decode_step(state.prev_emb, state.cache)
        _sample_advance(model, state, hidden, stream.min_len, stream.max_len, stream.rng)
    return stream


def lm_generate_v1(model: TransformerLM, text, text_len, prompt_speech, prompt_speech_len,
                   embedding: Optional[torch.Tensor], max_len,
                   gen: Optional[torch.Generator], max_steps: int, cache_len: int):
    """v1 generation (B=1): the streaming prefill and one chunk that runs to
    the end.  Only the first step masks EOS (the JAX package's min_len
    argument is unused there, and is not taken here).
    Returns (tokens [1, max_steps], count [1])."""
    stream = lm_prefill_stream_v1(model, text, text_len, prompt_speech, prompt_speech_len,
                                  embedding, max_len, gen, max_steps, cache_len)
    state = lm_decode_chunk_v1(model, stream, max_steps).gen
    return state.out, state.count
