"""Re-head the speech-token LM as a Hugging Face Qwen2 checkpoint for
HF-compatible serving engines.  Port of cosyvoice_tpu/bin/export_serving_lm.py.

    python -m cosyvoice_tpu_torch.bin.export_serving_lm --ckpt exp/llm.pt \\
        --out exp/llm_hf [--config conf.yaml]

The CosyVoice2 LM is a Qwen2 body with a speech embedding and an
`llm_decoder` head; the export is a plain Qwen2 causal LM whose
`model.embed_tokens` is the speech embedding (text enters as input
embeddings), whose `lm_head` is llm_decoder with its bias, and whose
vocabulary is padded with zero rows to a multiple of 64; config.json names
the class CosyVoice2ForCausalLM, with tie_word_embeddings false and 1024
positions.  The directory is written directly: config.json and
model.safetensors (utils/safetensors_io.py), so neither `transformers` nor
`safetensors` is needed.  --ckpt is a .pt state dict (bin/average_model.py)
or a model_dir of cosyvoice_tpu_torch.bin.train (its newest step, or
--step).
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import torch

from cosyvoice_tpu_torch.models.llm import LMConfig
from cosyvoice_tpu_torch.utils.safetensors_io import save_safetensors

BODY = "llm.model."


def rehead_state_dict(lm_state: dict, cfg: LMConfig, pad_to: int = 64) -> tuple[dict, dict]:
    """A Qwen2LM state dict (the port's names, the reference's) -> (HF
    Qwen2ForCausalLM state dict, HF config fields)."""
    q = cfg.qwen
    if q.quant != "none" or any(k.endswith(".scale") for k in lm_state):
        raise ValueError("export a float LM: the HF checkpoint holds float weights")
    if q.head_dim * q.num_heads != q.hidden_size:
        raise ValueError(f"HF Qwen2 derives head_dim from hidden_size / heads; "
                         f"{q.hidden_size} / {q.num_heads} != {q.head_dim}")
    sd = {k[len(BODY):]: v.detach().float().cpu() for k, v in lm_state.items()
          if k.startswith(BODY) and not k.startswith(BODY + "lm_head.")}
    vocab = cfg.speech_token_size + 3
    pad_vocab = -(-vocab // pad_to) * pad_to
    pad = lambda t: torch.cat([t, t.new_zeros((pad_vocab - vocab,) + t.shape[1:])])  # noqa
    sd["model.embed_tokens.weight"] = pad(lm_state["speech_embedding.weight"].float().cpu())
    sd["lm_head.weight"] = pad(lm_state["llm_decoder.weight"].float().cpu())
    sd["lm_head.bias"] = pad(lm_state["llm_decoder.bias"].float().cpu())
    hf_cfg = dict(vocab_size=pad_vocab, hidden_size=q.hidden_size,
                  num_hidden_layers=q.num_layers, num_attention_heads=q.num_heads,
                  num_key_value_heads=q.num_kv_heads, intermediate_size=q.intermediate_size,
                  rope_theta=q.rope_theta, rms_norm_eps=q.rms_norm_eps,
                  tie_word_embeddings=False, max_position_embeddings=1024)
    return {k: v.contiguous() for k, v in sd.items()}, hf_cfg


def export_serving_lm(lm_state: dict, cfg: LMConfig, out_dir: str, pad_to: int = 64) -> str:
    """Write `out_dir`/config.json and model.safetensors."""
    sd, hf_cfg = rehead_state_dict(lm_state, cfg, pad_to)
    os.makedirs(out_dir, exist_ok=True)
    conf = dict(architectures=["CosyVoice2ForCausalLM"], model_type="qwen2", hidden_act="silu",
                attention_dropout=0.0, use_sliding_window=False, rope_scaling=None,
                use_bias=True, **hf_cfg)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(conf, f, indent=2)
    save_safetensors(os.path.join(out_dir, "model.safetensors"), sd, {"format": "pt"})
    return out_dir


def load_lm_state(ckpt: str, step: Optional[int] = None) -> tuple[dict, int]:
    """A .pt state dict, or a trainer model_dir's step (newest by default)
    -> (state dict, step; -1 for a .pt)."""
    if os.path.isfile(ckpt):
        return torch.load(ckpt, map_location="cpu", weights_only=True), -1
    from cosyvoice_tpu_torch.train.checkpoint import STATE_FILE, latest_step

    step = latest_step(ckpt) if step is None else step
    if step is None:
        raise SystemExit(f"no checkpoint found under {ckpt}")
    saved = torch.load(os.path.join(ckpt, str(step), STATE_FILE), map_location="cpu",
                       weights_only=True)
    return saved["params"], step


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True,
                    help="a .pt state dict or a model_dir of cosyvoice_tpu_torch.bin.train")
    ap.add_argument("--out", required=True)
    ap.add_argument("--config", default=None, help="yaml with an `llm:` section (default: LMConfig())")
    ap.add_argument("--step", type=int, default=None)
    args = ap.parse_args(argv)
    if args.config:
        from cosyvoice_tpu_torch.config import load_config, make_config

        conf = dict(load_config(args.config)["llm"])
        cfg = make_config(conf.pop("kind", "qwen2lm"), conf)
    else:
        cfg = LMConfig()
    state, step = load_lm_state(args.ckpt, args.step)
    export_serving_lm(state, cfg, args.out)
    print(f"exported {args.ckpt}" + (f" step {step}" if step >= 0 else "") + f" -> {args.out}")


if __name__ == "__main__":
    main()
