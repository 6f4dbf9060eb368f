"""Where K6's time goes, phase by phase, on the card.

    python -m cosyvoice_tpu_torch.ops.kernels.lm_step_phases   # one CUDA GPU, nvcc

Builds a copy of csrc/lm_step.cu (into build/kernels/phases/) with a
clock64() stamp at each phase's start (after the grid barrier), once its
weights have landed (after its cp.async wait) and at its end (before the
next barrier), runs one full-width step (Qwen2-0.5B widths, 24 layers, a
384-row cache at pos 364, bf16), and prints one JSON line: for each phase
A-E the cycles from its start to its weights being ready and to its end,
the largest over the blocks (the phase's critical path) and block 0's,
medians over layers 1-23, and the mean cycles a block waits at the barrier
after it, with the SM clock to turn cycles into time.  The kernel it times
is the one `lm_step` launches, but for the stamps.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess

import numpy as np
import torch

from cosyvoice_tpu_torch.ops.kernels import build
from cosyvoice_tpu_torch.ops.kernels import lm_step as K6

_PHASES = ("    // A: x = ", "    // B: attention", "    // C: merge", "    // D: y1",
           "    // E: T(silu")
_STAMPS = 3 * 5 * 64                   # (start, ready, end) x phases x up to 64 layers


def _instrumented_source() -> str:
    src = (build.CSRC / "lm_step.cu").read_text()

    def put(old: str, new: str, count: int) -> None:
        nonlocal src
        if src.count(old) != count:
            raise RuntimeError(f"lm_step.cu no longer has {count} x {old!r}")
        src = src.replace(old, new)

    put("namespace {\n", "namespace {\n__device__ long long g_clock[132][%d];\n" % _STAMPS
        + "__shared__ int s_stamp;\n#define STAMP(k) do { if (threadIdx.x == 0 && "
        "blockIdx.x < 132 && s_stamp + (k) < %d) g_clock[blockIdx.x][s_stamp + (k)] = "
        "clock64(); } while (0)\n" % _STAMPS, 1)
    for ph, marker in enumerate(_PHASES):
        put(marker, "    if (threadIdx.x == 0) s_stamp = 15 * l + %d;\n    STAMP(0);\n"
            % (3 * ph) + marker, 1)
    # after each phase's wait for its copies (one a phase)
    src, n = re.subn(r"(cp_async_wait<\d>\(\);\n(\s*)__syncthreads\(\);[^\n]*\n)",
                     r"\1\2STAMP(1);\n", src)
    if n != 5:
        raise RuntimeError(f"lm_step.cu has {n} phase waits, not 5")
    put("    grid.sync();\n", "    STAMP(2);\n    grid.sync();\n", 5)
    return src + ('\nextern "C" int cvt_lm_step_clocks(void* out) {\n'
                  "  return (int)cudaMemcpyFromSymbol(out, g_clock, sizeof(g_clock));\n}\n")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("lm_step_phases: needs a CUDA GPU")
    out_dir = build.BUILD_ROOT / "phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "lm_step_phases.cu").write_text(_instrumented_source())
    lib_path = out_dir / "liblm_step_phases.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-shared",
                    str(out_dir / "lm_step_phases.cu"), "-o", str(lib_path)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    for name in ("cvt_lm_step", "cvt_lm_step_sync_probe"):
        getattr(lib, name).argtypes = build._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    build._lib = lib                   # lm_step launches the stamped kernel from here on

    dev, L, C, pos = torch.device("cuda"), 24, 384, 364
    g = torch.Generator(device=dev).manual_seed(7)
    w = K6.random_step_weights(L, 896, 4864, 14, 2, 64, g, dev)
    x = torch.randn(1, 896, generator=g, device=dev).to(torch.bfloat16)
    kc, vc = (torch.randn(L, C, 128, generator=g, device=dev).to(torch.bfloat16)
              for _ in range(2))
    ang = pos * 1e6 ** (-torch.arange(0, 64, 2, device=dev) / 64.0)
    for _ in range(3):
        K6.lm_step(w, x, kc, vc, pos, torch.cos(ang).repeat(2), torch.sin(ang).repeat(2),
                   nq=14, nkv=2, hd=64)
    torch.cuda.synchronize()
    clocks = np.zeros((132, _STAMPS), np.int64)
    build.check_launch(lib.cvt_lm_step_clocks(ctypes.c_void_p(clocks.ctypes.data)), "clocks")
    blocks = K6.sync_probe(1, dev)
    st = clocks[:blocks, :15 * L].reshape(blocks, 5 * L, 3).astype(np.float64)
    ready, end = st[..., 1] - st[..., 0], st[..., 2] - st[..., 0]
    # a block's wait at the barrier after a phase: the next phase's start
    # minus this one's end (none after the last)
    wait = np.zeros((blocks, 5 * L))
    wait[:, :-1] = st[:, 1:, 0] - st[:, :-1, 2]
    ready, end, wait = (v.reshape(blocks, L, 5)[:, 1:] for v in (ready, end, wait))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    res = {"card": smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None,
           "blocks": blocks, "layers": L, "unit": "SM cycles", "phases": {}}
    for ph, name in enumerate("ABCDE"):
        res["phases"][name] = dict(
            ready_max=float(np.median(ready[:, :, ph].max(0))),
            end_max=float(np.median(end[:, :, ph].max(0))),
            end_block0=float(np.median(end[0, :, ph])),
            barrier_wait_mean=float(np.median(wait[:, :-1, ph].mean(0))))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
