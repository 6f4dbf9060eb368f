"""Assemble a deployable model directory from trained sub-model checkpoints.
Port of cosyvoice_tpu/bin/ckpt_resave.py.

    python -m cosyvoice_tpu_torch.bin.ckpt_resave --out_dir exp/deploy \\
        --llm_pt exp/llm.pt --flow_pt exp/flow.pt --hift_pt exp/hift.pt \\
        --campplus_onnx base/campplus.onnx --s3_onnx base/speech_tokenizer_v2.onnx \\
        --tokenizer_dir base/CosyVoice-BlankEN [--base_llm_pt base/llm.pt] \\
        [--ref_audio spk1=spk1.wav ...]

Each sub-model's state dict is cleaned of training metadata (a
{"state_dict": ...} wrapper, non-tensor entries) and, with a --base_*_pt,
laid over the base as torch's load_state_dict(strict=False) would: keys
only in the base keep its values, shape mismatches keep the base's, keys
only in the checkpoint are dropped (each reported).  The directory gets
llm.pt, flow.pt and hift.pt (under `generator.`) in the reference names,
which both packages' `from_pretrained` read; the copied ONNX files and
tokenizer directory; and spk2info.npz (keys `<spk>/embedding`, the JAX
CLI's) with a speaker vector for each --ref_audio from the directory's
CAMPPlus.  --lora_npz merges a LoRA overlay into the LLM before it is
written: W += (lora_alpha / lora_r) * B @ A on each weight the overlay
names (train/lora.merge_lora), from a lora.npz of the port's train CLI
(port names) or of the JAX one (flax paths, mapped by
convert.lora_overlay_from_jax).  The JAX CLI writes .npz parameter trees
into its directory instead of .pt files.

--out_prefix P writes the JAX CLI's bare exports instead: P.llm.npz,
P.flow.npz and P.hift.npz, each sub-model's JAX parameter tree (the
state dict, --lora_npz merged into the LLM, through convert.*_state_to_jax)
flattened by utils/npz_io.flatten_params, the same keys and arrays as the
JAX CLI writes from the same .pt files.
"""
from __future__ import annotations

import argparse
import os
import shutil
from typing import Optional

import numpy as np
import torch

def clean_state_dict(raw, strip_prefix: str = "") -> dict:
    """Unwrap training metadata and normalize keys: bare state dicts or a
    {'state_dict': ...} wrapper; non-tensor entries dropped."""
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    return {k.removeprefix(strip_prefix): v for k, v in raw.items() if hasattr(v, "shape")}


def merge_state_dicts(base: dict, update: dict) -> dict:
    """load_state_dict(strict=False) over dicts: keys only in `base` keep
    its values, shape mismatches keep the base's, keys only in `update` are
    dropped; each case reported."""
    merged = dict(base)
    for k, v in update.items():
        if k not in base:
            print(f"  [resave] unexpected key dropped: {k}")
            continue
        if tuple(base[k].shape) != tuple(v.shape):
            print(f"  [resave] size mismatch for {k}: ckpt {tuple(v.shape)} vs base "
                  f"{tuple(base[k].shape)}, keeping base")
            continue
        merged[k] = v
    return merged


def load_sub_model(path: str, base_path: Optional[str] = None, strip_prefix: str = "") -> dict:
    """One sub-model's state dict, laid over `base_path`'s when given."""
    load = lambda p: clean_state_dict(  # noqa: E731
        torch.load(p, map_location="cpu", weights_only=True), strip_prefix)
    sd = load(path)
    return merge_state_dicts(load(base_path), sd) if base_path else sd


def merge_lora_overlay(sd: dict, lora_npz: str, r: int, alpha: float) -> dict:
    """The LLM state dict with lora.npz's overlay merged in (a JAX-written
    file's flax paths mapped to the state dict's names)."""
    from cosyvoice_tpu_torch.convert import lora_overlay_from_jax
    from cosyvoice_tpu_torch.train.lora import LoRAConfig, merge_lora, read_lora_npz

    overlay = read_lora_npz(lora_npz)
    if any("/" in name for name in overlay):
        overlay = lora_overlay_from_jax(overlay, list(sd))
    merged = merge_lora(sd, overlay, LoRAConfig(r=r, alpha=alpha))
    print(f"merged LoRA overlay over {len(overlay)} weights")
    return merged


def extract_spk2info(model_dir: str, ref_audios: dict, campplus_cfg=None,
                     device=None) -> dict:
    """spk -> {"embedding": vector} from each speaker's WAV (read at 16
    kHz, whole-file) through the directory's campplus.onnx on the port's
    CAMPPlus."""
    from cosyvoice_tpu_torch.models.campplus import (CAMPPlusConfig, import_campplus_onnx,
                                                     make_campplus_frontend_fn)
    from cosyvoice_tpu_torch.utils.audio import read_wav_16k

    fn = make_campplus_frontend_fn(import_campplus_onnx(
        os.path.join(model_dir, "campplus.onnx"), campplus_cfg or CAMPPlusConfig(), device))
    info = {}
    for spk, wav_path in ref_audios.items():
        info[spk] = {"embedding": np.asarray(fn(read_wav_16k(wav_path)), np.float32).reshape(-1)}
        print(f"extracted speaker vector for {spk} from {wav_path}")
    return info


def assemble_dir(out_dir: str, llm_pt=None, flow_pt=None, hift_pt=None, base_llm_pt=None,
                 base_flow_pt=None, base_hift_pt=None, lora_npz=None, lora_r: int = 8,
                 lora_alpha: float = 16, campplus_onnx=None, s3_onnx=None, tokenizer_dir=None,
                 ref_audios=None, campplus_cfg=None, device=None) -> str:
    """One deployable directory that from_pretrained loads."""
    if lora_npz and not llm_pt:
        raise ValueError("--lora_npz merges into the LLM: give --llm_pt")
    os.makedirs(out_dir, exist_ok=True)
    for stem, pt, base, prefix in (("llm", llm_pt, base_llm_pt, ""),
                                   ("flow", flow_pt, base_flow_pt, ""),
                                   ("hift", hift_pt, base_hift_pt, "generator.")):
        if pt:
            sd = load_sub_model(pt, base, strip_prefix=prefix)
            if stem == "llm" and lora_npz:
                sd = merge_lora_overlay(sd, lora_npz, lora_r, lora_alpha)
            torch.save({f"{prefix}{k}": v for k, v in sd.items()},
                       os.path.join(out_dir, f"{stem}.pt"))
            print(f"wrote {out_dir}/{stem}.pt")
    for src, name in ((campplus_onnx, "campplus.onnx"), (s3_onnx, "speech_tokenizer_v2.onnx")):
        if src:
            shutil.copyfile(src, os.path.join(out_dir, name))
            print(f"copied {name}")
    if tokenizer_dir:
        dst = os.path.join(out_dir, "CosyVoice-BlankEN")
        if os.path.abspath(tokenizer_dir) != os.path.abspath(dst):
            shutil.copytree(tokenizer_dir, dst, dirs_exist_ok=True)
            print("copied tokenizer assets")
    if ref_audios:
        info = extract_spk2info(out_dir, ref_audios, campplus_cfg, device)
        np.savez(os.path.join(out_dir, "spk2info.npz"),
                 **{f"{spk}/{k}": v for spk, d in info.items() for k, v in d.items()})
        print(f"wrote {out_dir}/spk2info.npz ({len(info)} speakers)")
    return out_dir


def write_prefix_npz(prefix: str, llm_pt=None, flow_pt=None, hift_pt=None, base_llm_pt=None,
                     base_flow_pt=None, base_hift_pt=None, lora_npz=None, lora_r: int = 8,
                     lora_alpha: float = 16) -> list:
    """The JAX CLI's --out_prefix exports: <prefix>.<stem>.npz for each
    sub-model given -> the paths written."""
    from cosyvoice_tpu_torch import convert
    from cosyvoice_tpu_torch.utils.npz_io import flatten_params

    if lora_npz and not llm_pt:
        raise ValueError("--lora_npz merges into the LLM: give --llm_pt")
    written = []
    for stem, pt, base, strip, to_jax in (
            ("llm", llm_pt, base_llm_pt, "", convert.lm_state_to_jax),
            ("flow", flow_pt, base_flow_pt, "", convert.flow_state_to_jax),
            ("hift", hift_pt, base_hift_pt, "generator.", convert.hift_state_to_jax)):
        if not pt:
            continue
        sd = load_sub_model(pt, base, strip_prefix=strip)
        if stem == "llm" and lora_npz:
            sd = merge_lora_overlay(sd, lora_npz, lora_r, lora_alpha)
        path = f"{prefix}.{stem}.npz"
        np.savez(path, **flatten_params(to_jax(sd, strict=False)))
        print(f"wrote {path}")
        written.append(path)
    return written


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--llm_pt", default=None)
    p.add_argument("--flow_pt", default=None)
    p.add_argument("--hift_pt", default=None)
    p.add_argument("--base_llm_pt", default=None,
                   help="base checkpoint under a partial --llm_pt (strict=False)")
    p.add_argument("--base_flow_pt", default=None)
    p.add_argument("--base_hift_pt", default=None)
    p.add_argument("--lora_npz", default=None, help="LoRA overlay to merge into the llm")
    p.add_argument("--lora_r", type=int, default=8)
    p.add_argument("--lora_alpha", type=int, default=16)
    p.add_argument("--campplus_onnx", default=None)
    p.add_argument("--s3_onnx", default=None)
    p.add_argument("--tokenizer_dir", default=None)
    p.add_argument("--ref_audio", action="append", default=[], metavar="SPK=WAV",
                   help="register SPK in spk2info.npz with WAV's speaker vector (repeatable)")
    p.add_argument("--out_dir", default=None, help="the deployable model directory")
    p.add_argument("--out_prefix", default=None,
                   help="write the JAX CLI's bare <prefix>.<model>.npz parameter trees")
    p.add_argument("--device", default=None,
                   help="where CAMPPlus runs for --ref_audio: cuda (the default) or cpu")
    args = p.parse_args(argv)
    if not (args.out_dir or args.out_prefix):
        p.error("need --out_dir or --out_prefix")
    if not args.out_dir:
        write_prefix_npz(args.out_prefix, llm_pt=args.llm_pt, flow_pt=args.flow_pt,
                         hift_pt=args.hift_pt, base_llm_pt=args.base_llm_pt,
                         base_flow_pt=args.base_flow_pt, base_hift_pt=args.base_hift_pt,
                         lora_npz=args.lora_npz, lora_r=args.lora_r,
                         lora_alpha=args.lora_alpha)
        return
    assemble_dir(args.out_dir, llm_pt=args.llm_pt, flow_pt=args.flow_pt, hift_pt=args.hift_pt,
                 base_llm_pt=args.base_llm_pt, base_flow_pt=args.base_flow_pt,
                 base_hift_pt=args.base_hift_pt, lora_npz=args.lora_npz, lora_r=args.lora_r,
                 lora_alpha=args.lora_alpha, campplus_onnx=args.campplus_onnx, s3_onnx=args.s3_onnx,
                 tokenizer_dir=args.tokenizer_dir,
                 ref_audios=dict(s.split("=", 1) for s in args.ref_audio), device=args.device)


if __name__ == "__main__":
    main()
