"""Tracing / profiling / debug hooks (port of `train/profiling.py`; the
reference has only wall-clock prints, SURVEY §5)."""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a profile of the host and, where there is one, the card, and
    write it as a Chrome trace (``trace.json`` under ``log_dir``; open it in
    ``chrome://tracing`` or Perfetto)::

        with profiling.trace("traces/step"):
            train_step(...)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def debug_nans(enable: bool = True) -> Iterator[None]:
    """Raise where a backward produces NaN (``torch.autograd``'s anomaly
    mode, slow: debug only); check a loss with ``check_finite``."""
    with torch.autograd.set_detect_anomaly(enable):
        yield


def check_finite(loss: torch.Tensor, what: str = "loss") -> torch.Tensor:
    """``loss`` itself, after checking that it is finite (a sync)."""
    if not bool(torch.isfinite(loss).all()):
        raise FloatingPointError(f"{what} is not finite: {loss}")
    return loss


class StepTimer:
    """Throughput counter (samples/sec, steps/sec).

    Call ``sync()`` before reading: a step returns before the card has run
    it."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self.steps = 0
        self.samples = 0

    def update(self, batch_size: int, n_steps: int = 1):
        self.steps += n_steps
        self.samples += batch_size * n_steps

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def steps_per_sec(self) -> float:
        return self.steps / max(self.elapsed, 1e-9)

    @property
    def samples_per_sec(self) -> float:
        return self.samples / max(self.elapsed, 1e-9)

    @staticmethod
    def sync(tensor: torch.Tensor) -> float:
        """Wait for everything queued on ``tensor``'s card
        (``torch.cuda.synchronize``) and return its sum as a float."""
        if tensor.device.type == "cuda":
            torch.cuda.synchronize(tensor.device)
        return float(tensor.sum())
