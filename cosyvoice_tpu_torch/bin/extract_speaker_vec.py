"""Offline speaker-vector extraction for the offline-embedding training path.

Port of cosyvoice_tpu/bin/extract_speaker_vec.py (the reference's
bin/extract_speaker_vec.py): each line of a wav.scp (`utt path`, 24 kHz
wavs) -> `<utt>.npy`, the 512-d vector of the LAM SpeakerEmbedding loaded
from a reference `.pt` state_dict (weights only, by name, strictly).  The
posterior sample's noise comes from a CPU generator seeded 0 for every
utterance, as the JAX CLI passes PRNGKey(0).

    python -m cosyvoice_tpu_torch.bin.extract_speaker_vec --wav_scp wav.scp \\
        --out_dir vecs --ckpt speaker.pt [--device cpu]
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--wav_scp", required=True, help="utt -> wav path (24 kHz)")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--ckpt", default=None, help=".pt SpeakerEmbedding ckpt")
    p.add_argument("--device", default=None, help="default: the GPU; 'cpu' runs the plain "
                                                  "PyTorch versions")
    args = p.parse_args(argv)
    if not args.ckpt:
        raise SystemExit("--ckpt required (random vectors are useless)")

    import torch

    from cosyvoice_tpu_torch.bin.inference import read_wav
    from cosyvoice_tpu_torch.models.speaker import load_speaker_embedding, speaker_embed

    model = load_speaker_embedding(
        state_dict=torch.load(args.ckpt, map_location="cpu", weights_only=True),
        device=args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    with open(args.wav_scp) as f:
        lines = [line.split(maxsplit=1) for line in f if line.strip()]
    for utt, path in lines:
        wav, _ = read_wav(path.strip())
        vec = speaker_embed(model, wav, gen=torch.Generator().manual_seed(0))
        np.save(os.path.join(args.out_dir, f"{utt}.npy"), vec)
        print(utt)


if __name__ == "__main__":
    main()
