"""Build the port's CUDA kernels at first use and bind them with ctypes.

The sources under `cosyvoice_tpu_torch/csrc/` have a plain C interface (no
PyTorch headers), so `nvcc` compiles each one in seconds.  All sources are
compiled in parallel, one `nvcc` each, for `sm_90a` (Hopper), then linked into
one shared library in `build/kernels/<digest>/` at the repo root; the digest
covers the sources and flags, so an edited source rebuilds and an unchanged
one loads the library already built.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("lm_decode_attention.cu", "dit_attention.cu", "fused_norm.cu",
           "int4_matmul.cu", "lm_step.cu", "dit_block.cu", "snake_aa.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "cvt_lm_decode_attention": [_P] * 10 + [_I] * 5 + [_F, _I, _P],
    "cvt_dit_attention": [_P] * 5 + [_I] * 4 + [_LL] * 4 + [_F, _I, _P],
    "cvt_fused_layer_norm": [_P] * 4 + [_LL, _I, _F, _I, _I, _P],
    "cvt_int4_matmul": [_P] * 6 + [_I] * 5 + [_P],
    "cvt_int4_matmul_plan": [_I] * 4 + [ctypes.POINTER(_I)],
    "cvt_lm_step": [_P] * 20 + [_I] * 7 + [_F, _F, _I, _P],
    "cvt_lm_step_sync_probe": [_I, ctypes.POINTER(_I), _P],
    "cvt_lm_step_int8_to_float": [_P, _P, _I, _P],
    "cvt_dit_block": [_P] * 16 + [_I] * 6 + [_F, _I, _P],
    "cvt_snake_aa": [_P] * 5 + [_I] * 10 + [_P],
    "cvt_snake_aa_sin2_mismatches": [_P, _P],
}

_lock = threading.Lock()
_lib = None
# what the last build did: {"seconds", "cached", "ptxas"}; chip_smoke.py prints it
report: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           "from csrc/ on a machine with the CUDA toolkit")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile and link the kernel library unless it is built already."""
    t0 = time.perf_counter()
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / "libcosyvoice_kernels.so"
    log_path = out_dir / "ptxas.log"
    if lib_path.exists():
        report.update(seconds=time.perf_counter() - t0, cached=True,
                      ptxas=log_path.read_text() if log_path.exists() else "")
        return lib_path
    nvcc = _nvcc()
    work = out_dir / f"tmp-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in SOURCES:
        obj = work / f"{src}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src}\n{out}")
        if proc.returncode:
            failed.append(src)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    tmp_lib = work / lib_path.name
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp_lib),
                           *(str(obj) for _, obj, _ in procs)],
                          capture_output=True, text=True)
    if link.returncode:
        raise RuntimeError(f"linking the kernel library failed:\n{link.stderr}")
    log_path.write_text("\n".join(logs))
    os.replace(tmp_lib, lib_path)
    shutil.rmtree(work, ignore_errors=True)
    report.update(seconds=time.perf_counter() - t0, cached=False,
                  ptxas="\n".join(logs))
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on t's device (the call
    PyTorch's own generated kernels use: no Stream object is built)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def scratch_for(store: dict, device: torch.device, stream: int, counters: int,
                floats: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A split kernel's scratch from `store`, one set per (device, raw stream):
    (int32 arrival counters, zero between launches, since each launch leaves
    them zero; fp32 partials), grown to at least `counters` and `floats`.
    Launches on one stream run in order, so they may share a set; a launch on
    another stream gets its own."""
    cnt, work = store.get((device, stream), (None, None))
    if cnt is None or cnt.numel() < counters:
        cnt = torch.zeros(counters, dtype=torch.int32, device=device)
    if work is None or work.numel() < floats:
        work = torch.empty(floats, dtype=torch.float32, device=device)
    store[(device, stream)] = (cnt, work)
    return cnt, work


def check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def needs_autograd(name: str, *tensors: torch.Tensor) -> bool:
    """True where a call must keep a graph for a backward (grad on and a
    tensor wanting a gradient): the caller then runs its plain PyTorch
    version, which is differentiable, on the CPU.  On a CUDA tensor it
    raises instead, as require_cuda does: the kernels have no backward.
    A registered operator cannot tell, since PyTorch runs its kernel with
    grad off, so its wrapper asks first."""
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors)):
        return False
    if tensors[0].device.type != "cpu":
        require_cuda(name, *tensors)
    return True


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """The launch's tensors on one CUDA device, contiguous, and none of
    them wanting a gradient: the kernels have no backward, so a launch
    inside autograd would hand back an output cut off from the graph."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the kernel has no backward; call it under "
                           "torch.no_grad() (training takes the plain PyTorch routes)")
    index = tensors[0].get_device()            # -1 on the CPU
    for t in tensors:
        if index < 0 or t.get_device() != index:
            raise ValueError(f"{name}: every tensor must be on one CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
