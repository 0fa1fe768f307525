"""Profiling helpers (port of kvquant_tpu/utils/profiling.py).

  - device_timed(fn, *args, iters): seconds per call of ``fn(*args)``;
    on a card, CUDA events around ``iters`` back-to-back calls after a
    warm-up call; on the CPU, ``time.perf_counter`` around the same loop.
  - trace(path): a ``torch.profiler`` context that writes a Chrome trace
    (``trace.json``) into the directory ``path`` and yields the profiler.
    A profiler that fails to start raises: a profile that silently did
    not happen is no profile.
  - cost_analysis(fn, *args) / traffic_report(fn, *args): what one
    profiled call shows. JAX reads XLA's cost model there (bytes accessed,
    flops, transcendentals); torch has no such model, so those keys are
    absent. Reported instead: the kernel launches, the kernel time and the
    time per kernel name (top 10). On a card these are CUDA kernels and
    device time; on the CPU they are the ATen operators and their CPU
    time, and the result says ``device: "cpu"``.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile


def _on_cuda(args) -> bool:
    return any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)


def _activities(cuda: bool) -> list:
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])


def device_timed(fn, *args, iters: int = 20) -> float:
    """Seconds per call of ``fn(*args)`` over ``iters`` back-to-back calls
    after one warm-up call (CUDA events when an argument lies on a card)."""
    fn(*args)
    if _on_cuda(args):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters


@contextlib.contextmanager
def trace(path: str):
    """Profile the body (with device activity when a card is present); on
    exit write ``path``/trace.json (Chrome trace format). Yields the
    ``torch.profiler.profile`` object."""
    cuda = torch.cuda.is_available()
    os.makedirs(path, exist_ok=True)
    with profile(activities=_activities(cuda), acc_events=True) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(path, "trace.json"))


def kernel_summary(prof, cuda: bool) -> dict:
    """{"device", "launches", "kernel_ms", "by_kernel": [(name, ms), ...]}
    of a finished profile: CUDA kernels and their device time, or, for a
    CPU run, ATen operators and their self CPU time."""
    if cuda:
        ev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
        us = {e.key: e.self_device_time_total for e in ev}
    else:
        ev = [e for e in prof.key_averages()
              if e.key.startswith("aten::") and e.self_cpu_time_total > 0]
        us = {e.key: e.self_cpu_time_total for e in ev}
    top = sorted(us.items(), key=lambda kv: -kv[1])[:10]
    return {"device": "cuda" if cuda else "cpu",
            "launches": sum(e.count for e in ev),
            "kernel_ms": sum(us.values()) / 1e3,
            "by_kernel": [(k, v / 1e3) for k, v in top]}


def cost_analysis(fn, *args) -> dict:
    """``kernel_summary`` of one profiled call of ``fn(*args)`` after a
    warm-up call. XLA's bytes accessed / flops / transcendentals have no
    torch source and are absent."""
    cuda = _on_cuda(args)
    fn(*args)
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=_activities(cuda), acc_events=True) as prof:
        fn(*args)
        if cuda:
            torch.cuda.synchronize()
    return kernel_summary(prof, cuda)


def traffic_report(fn, *args, label: str = "fn") -> dict:
    """Print and return ``cost_analysis(fn, *args)``."""
    ca = cost_analysis(fn, *args)
    print(f"[{label}] {ca['device']}: launches={ca['launches']} "
          f"time={ca['kernel_ms']:.3f}ms")
    for name, ms in ca["by_kernel"]:
        print(f"[{label}]   {ms:9.3f} ms  {name[:90]}")
    return ca
