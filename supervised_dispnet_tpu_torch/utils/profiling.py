"""Step timing and traces, the port of
``supervised_dispnet_tpu/utils/profiling.py``: a ``torch.profiler`` trace
around a block (the train CLI's ``--profile-steps``), a steady-state
images-per-second timer that times the card with CUDA events, and the
reference's batch / data time meters."""

from __future__ import annotations

import contextlib
import time
from collections.abc import Callable
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(logdir: str | Path, device: torch.device):
    """A ``torch.profiler`` trace of the block, the host's and, on the card,
    the device's activity, written to ``logdir/trace.json`` (Chrome trace
    format: chrome://tracing or Perfetto). The card's queue is drained
    before the trace stops."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(str(logdir / "trace.json"))


def steady_state_images_per_sec(step_fn: Callable[[], object], batch_size: int,
                                device: torch.device, iters: int = 20,
                                warmup: int = 3) -> float:
    """Images per second of ``step_fn`` (one step of ``batch_size`` images)
    after ``warmup`` steps: on the card, CUDA events around ``iters`` steps
    (the time the card takes for them, its queue drained); on the CPU, the
    host clock."""
    for _ in range(warmup):
        step_fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            step_fn()
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            step_fn()
        seconds = time.perf_counter() - t0
    return batch_size * iters / seconds


class StepTimer:
    """batch_time / data_time meters around a training loop (the reference
    console log's names), on the host clock."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._last = time.time()
        self.data_time = 0.0
        self.batch_time = 0.0
        self.count = 0

    def mark_data(self) -> None:
        """The batch is ready: the time since the last step is data time."""
        self.data_time += time.time() - self._last

    def mark_step(self) -> None:
        """The step is done: the time since the last step is batch time."""
        now = time.time()
        self.batch_time += now - self._last
        self._last = now
        self.count += 1

    def averages(self) -> dict[str, float]:
        n = max(self.count, 1)
        return {"batch_time": self.batch_time / n, "data_time": self.data_time / n}
