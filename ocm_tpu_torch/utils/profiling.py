"""Tracing, profiling and throughput measurement (port of
``ocm_tpu/utils/profiling.py``).

- ``trace(logdir)`` — context manager around ``torch.profiler`` (CPU, and
  CUDA where there is a card) writing a Chrome/Perfetto trace of
  everything run inside to ``logdir/trace.json``; yields the profiler, so
  ``key_averages()`` can sum the kernels by name;
- ``annotate(name)`` — a named range on the trace timeline
  (``torch.profiler.record_function``) and, on a card, an NVTX range;
- ``timeit`` — wall-clock timing that synchronizes every device its
  outputs lie on, so asynchronous launches cannot fake speed, after a
  warm-up that excludes first-call costs (kernel builds, allocator growth);
- ``throughput`` — items a second from ``timeit``'s best time;
- ``EpochLogger`` — structured per-epoch loss rows;
- ``debug_nans`` — autograd's anomaly mode (the sanitizer-mode
  counterpart of ``jax_debug_nans``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block and write ``logdir/trace.json`` (open in
    Perfetto or chrome://tracing); yields the ``torch.profiler.profile``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named range on the trace timeline (and an NVTX range on a card)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def _devices(out, found: set) -> set:
    if isinstance(out, torch.Tensor):
        if out.device.type == "cuda":
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _devices(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _devices(v, found)
    return found


def synchronize(out):
    """Wait for every CUDA device that a tensor of ``out`` (a tensor or a
    nest of dicts, lists and tuples) lies on."""
    for dev in _devices(out, set()):
        torch.cuda.synchronize(dev)
    return out


def timeit(fn: Callable, *args, warmup: int = 2, repeats: int = 5,
           **kwargs) -> dict:
    """Wall-clock stats of ``fn(*args, **kwargs)``, each call timed to the
    end of the device work on its outputs (``synchronize``), after at
    least one warm-up call.  Returns {'best', 'mean', 'times'} in
    seconds."""
    for _ in range(max(warmup, 1)):
        synchronize(fn(*args, **kwargs))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        synchronize(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    return {"best": min(times), "mean": sum(times) / len(times),
            "times": times}


def throughput(fn: Callable, n_items: int, *args, warmup: int = 2,
               repeats: int = 5, **kwargs) -> float:
    """Items a second at the best of ``repeats`` wall-clock times."""
    stats = timeit(fn, *args, warmup=warmup, repeats=repeats, **kwargs)
    return n_items / stats["best"]


class EpochLogger:
    """Structured replacement for the reference's print-every-N-epochs
    (utils/final_vaesimca.py:397-398): records (epoch, train, val) rows and
    optionally prints at a cadence."""

    def __init__(self, print_every: Optional[int] = None):
        self.print_every = print_every
        self.rows: list[dict] = []

    def log(self, epoch: int, train_loss: float, val_loss: float,
            **extra) -> None:
        row = {"epoch": epoch, "train_loss": float(train_loss),
               "val_loss": float(val_loss), **extra}
        self.rows.append(row)
        if self.print_every and ((epoch + 1) % self.print_every == 0
                                 or epoch == 0):
            print(f"Epoch {epoch + 1} | Train: {train_loss:.6f} | "
                  f"Val: {val_loss:.6f}")

    def history(self) -> dict:
        return {
            "train_losses": [r["train_loss"] for r in self.rows],
            "val_losses": [r["val_loss"] for r in self.rows],
        }


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Autograd's anomaly mode over the enclosed block.

    It traps a backward pass: a backward function that returns NaN raises
    at once, with the traceback of the forward operation that created it.
    It does not trap NaN produced by forward-only code, such as scoring
    under ``torch.inference_mode()``; check such outputs with
    ``torch.isfinite``.  It slows every autograd operation, so it is for
    debugging only.
    """
    with torch.autograd.set_detect_anomaly(enable):
        yield
