"""Average the newest checkpoints of a training run into one state dict.
Port of cosyvoice_tpu/bin/average_model.py.

    python -m cosyvoice_tpu_torch.bin.average_model --src_dir exp/llm \\
        --dst_path exp/llm.pt [--num 5]

Reads the port trainer's checkpoints (`<src_dir>/<step>/state.pt`,
train/checkpoint.py), sums the newest `--num` in float64 and writes their
float32 mean with torch.save, under the reference checkpoint names that
`from_pretrained` and the `load_*` functions read; a HiFT generator's
names go under `generator.`, as in a released hift.pt.  (The JAX CLI
writes a flat .npz of flax paths instead.)
"""
from __future__ import annotations

import argparse
from typing import Optional

import torch

from cosyvoice_tpu_torch.train.checkpoint import all_steps, average_checkpoints


def averaged_state(src_dir: str, num: int = 5) -> dict:
    """The mean of the newest `num` checkpoints' parameters, a HiFT
    generator's under `generator.`."""
    avg = average_checkpoints(src_dir, last_n=num)
    if any(k.startswith("f0_predictor.") for k in avg) and \
            any(k.startswith("m_source.") for k in avg):
        avg = {f"generator.{k}": v for k, v in avg.items()}
    return avg


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--src_dir", required=True, help="a model_dir of cosyvoice_tpu_torch.bin.train")
    p.add_argument("--dst_path", required=True, help="output .pt state dict")
    p.add_argument("--num", type=int, default=5, help="average the newest N checkpoints")
    args = p.parse_args(argv)
    avg = averaged_state(args.src_dir, args.num)
    torch.save(avg, args.dst_path)
    steps = all_steps(args.src_dir)[-args.num:]
    print(f"averaged {len(steps)} checkpoints (steps {steps}) -> {args.dst_path} "
          f"({len(avg)} tensors)")


if __name__ == "__main__":
    main()
