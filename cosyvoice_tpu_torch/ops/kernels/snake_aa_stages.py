"""K7 (snake_aa) at the BigVGAN recipe's stage shapes, and the vocoder's
forward around it, on the card, for the port's tree or an older one.

    PYTHONPATH=. python cosyvoice_tpu_torch/ops/kernels/snake_aa_stages.py
    PYTHONPATH=build/parent python cosyvoice_tpu_torch/ops/kernels/snake_aa_stages.py

Run as a file, it measures the `cosyvoice_tpu_torch` that PYTHONPATH puts
first, so one command can hold two trees on one card (`git archive` the
older one into a gitignored directory).  It prints one JSON line a stage
shape: K7's device time (the median of three CUDA-graph replays of 20 calls)
with x channels-last, and with x channels-first where the tree's wrapper
takes that layout, else the copy to channels-last that the tree's AAAct
made ahead of each launch (`layout_copy_dev_ms`); each launch's largest
error against the plain version; the bound (8 bytes an element at
3.35 TB/s).  Then one line for a full-width recipe forward (4 rows of
250/200/150/100 tokens, seeded random weights, every AAAct through K7):
wall seconds, K7's launches, and device ms of K7, of the copy kernels and
in all (torch.profiler, one forward), with the card's name and power limit.
Convolutions and matmuls run in full fp32 (TF32 off), as in chip_smoke.py.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

# run as a file, Python puts this directory first on the path: drop it, so
# that its modules do not shadow top-level names
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    del sys.path[0]

import torch  # noqa: E402

from cosyvoice_tpu_torch.models.bigvgan import RECIPE, BigVGAN  # noqa: E402
from cosyvoice_tpu_torch.ops.kernels import snake_aa as K7  # noqa: E402

STAGES = ((4, 8000, 768), (4, 40000, 384), (4, 120000, 192), (4, 240000, 96))
HBM_BYTES_PER_S = 3.35e12


def device_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Device ms of one call of fn: `calls` calls in one CUDA graph, events
    around `replays` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
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


def dev_time(fn) -> dict:
    runs = [device_ms(fn) for _ in range(3)]
    return {"dev_ms": sorted(runs)[1], "dev_ms_runs": runs}


def stage_row(shape, g) -> dict:
    B, T, C = shape
    x = torch.randn(*shape, generator=g, device="cuda")
    a, b = (torch.randn(C, generator=g, device="cuda") * 0.3 for _ in range(2))
    xcf = x.transpose(1, 2).contiguous().transpose(1, 2)
    want = K7.snake_aa_plain(x, a, b)
    row = {"shape": list(shape), "bound_ms": 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3,
           "channels_last": {"max_abs_err": float((K7.snake_aa(x, a, b) - want).abs().max()),
                             **dev_time(lambda: K7.snake_aa(x, a, b))}}
    if hasattr(K7, "memory_layout"):          # the wrapper takes channels-first x
        row["channels_first"] = {
            "max_abs_err": float((K7.snake_aa(xcf, a, b) - want).abs().max()),
            **dev_time(lambda: K7.snake_aa(xcf, a, b))}
    else:
        row["layout_copy_dev_ms"] = dev_time(lambda: xcf.contiguous())["dev_ms"]
    return row


@torch.no_grad()
def forward_row(g) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = dataclasses.replace(RECIPE, use_pallas_act=True)
    with torch.device("cuda"):
        model = BigVGAN(cfg)
    for name, p in model.named_parameters():           # chip_smoke.py's rand_init_
        if p.ndim >= 2:
            p.copy_(torch.randn(p.shape, generator=g, device="cuda")
                    * (0.02 if "embed" in name else (p.numel() // p.shape[0]) ** -0.5))
        else:
            p.fill_(0.0 if "bias" in name else 1.0)
    model.eval()
    lens = torch.tensor([250, 200, 150, 100], device="cuda")
    valid = torch.arange(250, device="cuda")[None] < lens[:, None]
    token = torch.where(valid, torch.randint(0, cfg.vocab_size, (4, 250), generator=g,
                                             device="cuda"), -1)
    spk = torch.randn(4, cfg.speaker_embedding_dim, generator=g, device="cuda")
    model(token, lens, spk)
    torch.cuda.synchronize()
    K7.launches = 0
    t0 = time.perf_counter()
    model(token, lens, spk)
    torch.cuda.synchronize()
    wall, launches = time.perf_counter() - t0, K7.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model(token, lens, spk)
        torch.cuda.synchronize()
    k7 = copy = total = 0.0
    copies = 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            ms = e.self_device_time_total / 1e3
            total += ms
            if "snake_aa" in e.key:
                k7 += ms
            if "copy" in e.key.lower():
                copy, copies = copy + ms, copies + e.count
    return {"forward": "bigvgan recipe, 4 rows of 250/200/150/100 tokens", "wall_s": wall,
            "k7_launches": launches, "k7_device_ms": k7, "copy_device_ms": copy,
            "copy_launches": copies, "device_ms": total}


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    # fp32 convolutions in full fp32, as chip_smoke.py runs them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tree = str(K7.__file__).rsplit("/cosyvoice_tpu_torch/", 1)[0]
    g = torch.Generator(device="cuda").manual_seed(3)
    for shape in STAGES:
        print(json.dumps({"tree": tree, "card": smi, **stage_row(shape, g)}), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"tree": tree, "card": smi, **forward_row(g)}), flush=True)


if __name__ == "__main__":
    main()
