"""Profiling and roofline accounting — the counterpart of
`amid_tpu/utils/profiler.py`.

* `trace(logdir)` — a context manager around `torch.profiler.profile` (the
  CPU's activity, and the card's where there is one); on exit it writes a
  Chrome trace, `<logdir>/<host>_<pid>.<ns>.pt.trace.json`, which
  `chrome://tracing`, Perfetto and TensorBoard's profiler plugin read.
* `StepTimer` — examples/s over a window that skips the first step (graph
  capture, the kernels' first load), the JAX package's class and arithmetic.
* `Roofline` — achieved against peak FLOP/s and bytes/s for a measured op;
  the default peaks are the H100's (below), not the TPU v5e's.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

# NVIDIA's data sheet for the H100 SXM at its 700 W limit (`nvidia-smi
# --query-gpu=name,power.limit`: "NVIDIA H100 80GB HBM3, 700.00 W"): dense
# bf16 tensor cores and HBM3; a card set to a lower limit reaches less
H100_BF16_TFLOPS = 989.0
H100_HBM_GBS = 3350.0


@contextlib.contextmanager
def trace(logdir: str):
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


class StepTimer:
    """Examples/s over a window, excluding the first (compile) step."""

    def __init__(self) -> None:
        self._t0: float | None = None
        self._examples = 0
        self._steps = 0

    def step(self, batch_size: int) -> None:
        self._steps += 1
        if self._steps == 1:
            return  # first step includes compile; start the clock after it
        if self._t0 is None:
            self._t0 = time.perf_counter()
            return
        self._examples += batch_size

    @property
    def examples_per_s(self) -> float:
        if self._t0 is None or self._examples == 0:
            return 0.0
        return self._examples / (time.perf_counter() - self._t0)


@dataclass
class Roofline:
    flops: int
    bytes_accessed: int
    seconds: float
    peak_tflops: float = H100_BF16_TFLOPS
    peak_gbs: float = H100_HBM_GBS

    @property
    def achieved_tflops(self) -> float:
        return self.flops / self.seconds / 1e12

    @property
    def achieved_gbs(self) -> float:
        return self.bytes_accessed / self.seconds / 1e9

    @property
    def compute_bound(self) -> bool:
        """Operational intensity above the machine-balance ridge point."""
        ridge = self.peak_tflops * 1e12 / (self.peak_gbs * 1e9)
        return self.flops / max(self.bytes_accessed, 1) >= ridge

    @property
    def fraction_of_sol(self) -> float:
        """Achieved fraction of the binding roofline."""
        if self.compute_bound:
            return self.achieved_tflops / self.peak_tflops
        return self.achieved_gbs / self.peak_gbs

    def report(self, name: str) -> str:
        bound = "compute" if self.compute_bound else "memory"
        return (
            f"{name}: {self.seconds * 1e6:.0f}us "
            f"{self.achieved_tflops:.2f} TF/s {self.achieved_gbs:.0f} GB/s "
            f"({bound}-bound, {100 * self.fraction_of_sol:.1f}% of SOL)"
        )
