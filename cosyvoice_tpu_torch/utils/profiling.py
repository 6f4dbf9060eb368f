"""Tracing and stage timers.  Port of cosyvoice_tpu/utils/profiling.py.

  * `trace(log_dir)`: a torch.profiler trace of the block (CPU activity,
    and CUDA activity once CUDA is in use), written into log_dir as a
    Chrome/Perfetto trace (`trace_<pid>_<n>.json`); the profiler object is
    yielded for its key_averages() / events().
  * `StageTimer`: per-stage wall timers with RTF summaries for the
    llm / flow / vocoder pipeline.  Eager CUDA returns before the device
    finishes, so a stage waits for the current CUDA stream at its end
    (where CUDA is initialised): its wall includes its device work.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import time
from collections import defaultdict

import torch

_traces = itertools.count()


@contextlib.contextmanager
def trace(log_dir: str):
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}_{next(_traces)}.json"))


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.current_stream().synchronize()


class StageTimer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self, audio_seconds: float | None = None) -> dict:
        out = {k: {"total_s": v, "calls": self.counts[k]}
               for k, v in self.totals.items()}
        if audio_seconds:
            for k in out:
                out[k]["rtf"] = self.totals[k] / audio_seconds
        return out
