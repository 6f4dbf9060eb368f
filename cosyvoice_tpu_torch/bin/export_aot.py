"""Ahead-of-time export of the flow's CFM estimator.  Port of
cosyvoice_tpu/bin/export_aot.py.

    python -m cosyvoice_tpu_torch.bin.export_aot --model_dir D --out_dir exp/aot \\
        [--fp16] [--device cpu]

`export_flow_estimator` runs torch.export on the estimator's forward(x,
mask, mu, t, spks, cond) at batch 2 (the CFG pair) and each static length
T, in the model's own dtype and on its device, writes
`estimator_T{T}.pt2` (torch.export.save) and holds the reloaded program to
the eager call on seeded random inputs at the reference's export bar
(rtol 1e-2, atol 1e-5).  Where the JAX package writes StableHLO, this
writes an ExportedProgram: its K2-K4 nodes are the operators
`torch.ops.cosyvoice.dit_attention_packed`, `fused_layer_norm` and
`dit_block` (ops/kernels/), which launch the hand-written kernels on the
card and run their plain versions on the CPU.  A reader registers them
before it loads a file:

    import cosyvoice_tpu_torch.ops.kernels.dit_attention  # noqa: F401
    import cosyvoice_tpu_torch.ops.kernels.dit_block      # noqa: F401
    import cosyvoice_tpu_torch.ops.kernels.fused_norm     # noqa: F401
    est = torch.export.load("estimator_T200.pt2").module()

(`import cosyvoice_tpu_torch.bin.export_aot` imports all three.)
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

# the operators an exported estimator calls
from cosyvoice_tpu_torch.ops.kernels import dit_attention, dit_block, fused_norm  # noqa: F401

RTOL, ATOL = 1e-2, 1e-5      # the reference's ONNX export check (export_onnx.py:95-101)


def estimator_inputs(estimator, T: int, seed: int = 0) -> tuple:
    """(x, mask, mu, t, spks, cond) at batch 2 and length T on the
    estimator's device: standard normal draws from `seed` (numpy, as the
    reference's check)."""
    C = estimator.cfg.out_channels
    dev = next(estimator.parameters()).device
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
                 for s in ((2, T, C), (2, T), (2, T, C), (2,), (2, C), (2, T, C)))


def export_estimator(estimator, T: int) -> torch.export.ExportedProgram:
    """torch.export of the estimator at batch 2 and static length T."""
    with torch.no_grad():
        return torch.export.export(estimator.eval(), estimator_inputs(estimator, T),
                                   strict=False)


def cosyvoice_ops(program: torch.export.ExportedProgram) -> dict:
    """{operator name: nodes} of the cosyvoice:: operators in a program's graph."""
    out: dict = {}
    for node in program.graph.nodes:
        target = str(node.target)
        if node.op == "call_function" and target.startswith("cosyvoice."):
            name = target.split(".")[1]
            out[name] = out.get(name, 0) + 1
    return out


def export_flow_estimator(flow_model, out_dir: str, lengths: Sequence[int] = (100, 200, 500),
                          seed: int = 0) -> dict:
    """Export flow_model's estimator at each length, reload each file and
    check it against the eager estimator -> {T: {"path", "export_s",
    "save_load_s", "max_abs_err", "ops", "program"}} ("program": the
    reloaded module); raises where a reloaded program misses the bar."""
    est = flow_model.decoder.estimator.eval()
    os.makedirs(out_dir, exist_ok=True)
    report = {}
    for T in lengths:
        t0 = time.perf_counter()
        program = export_estimator(est, T)
        t1 = time.perf_counter()
        path = os.path.join(out_dir, f"estimator_T{T}.pt2")
        torch.export.save(program, path)
        loaded = torch.export.load(path).module()
        t2 = time.perf_counter()
        args = estimator_inputs(est, T, seed)
        with torch.no_grad():
            got, want = loaded(*args), est(*args)
        err = float((got.float() - want.float()).abs().max())
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=path)
        report[T] = {"path": path, "export_s": t1 - t0, "save_load_s": t2 - t1,
                     "max_abs_err": err, "ops": cosyvoice_ops(program), "program": loaded}
        print(f"exported + verified {path}")
    return report


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--model_dir", required=True,
                   help="model directory (llm/flow/hift .pt or .npz, as from_pretrained reads)")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--fp16", action="store_true",
                   help="the bf16 serving estimator (its fused attention on the card)")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    from cosyvoice_tpu_torch.runtime.api import from_pretrained

    cv = from_pretrained(args.model_dir, fp16=args.fp16, device=args.device)
    export_flow_estimator(cv.model.flow, args.out_dir)


if __name__ == "__main__":
    main()
