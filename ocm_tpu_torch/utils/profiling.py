"""Tracing, profiling and throughput measurement (port of
``ocm_tpu/utils/profiling.py``).

- ``trace(logdir)`` — context manager around ``torch.profiler`` (CPU, and
  CUDA where there is a card) writing a Chrome/Perfetto trace of
  everything run inside to ``logdir/trace.json``; yields the profiler, so
  ``key_averages()`` can sum the kernels by name;
- spans and counters, recorded in memory: ``span(name, parent=None,
  **attrs)`` times the enclosed block and ``count(name, n)`` adds to a
  counter (``annotate`` is ``span``).  They record only while tracing is
  on: inside ``tracing()``, or on a thread where a ``torch.profiler`` is
  recording.  Off, a span costs a flag check and records nothing.  On,
  each span keeps its name, start and end (``time.perf_counter_ns``), its
  thread, its id, its parent's id and its call's id (the id of its
  outermost span; a span opened with ``parent=`` on another thread joins
  that span's call), the counts made inside it, and whether it opened a
  profiler range of its name (a ``record_function``, through torch's
  one-call binding), which it does on a thread where the profiler records
  (so the profiler's trace shows it as an operator of that name); on a
  card it also pushes an NVTX range (Nsight Systems shows it).
  ``spans()``, ``counters()`` and ``dropped()`` read what was recorded,
  ``reset()`` clears it; the buffer holds ``CAPACITY`` spans and counts
  the spans it had no room for.  ``to_profiler_time(spans, events)`` puts
  spans on the clock of a profiler's events.
  ``serving``'s scorers record, per call of ``score`` or
  ``score_prepared``: ``serving.score`` (the call), and per chunk
  ``serving.input`` (pad, host stage and copy to the device, on the
  scorer's copy worker where it has one; on a card the staging into
  page-locked memory and the copy's wait), ``serving.wait_input`` (the
  caller waiting for the worker), ``serving.decide`` (the enqueue under
  ``inference_mode``) and ``serving.fetch`` (waiting for the outputs on
  the host, the host epilogue, the cut); ``prepare`` records
  ``serving.prepare`` and its chunks' ``serving.input``; the counter
  ``serving.h2d_bytes`` counts the bytes put on the device, and
  ``serving.h2d_bytes_pinned`` those of them copied from page-locked
  memory;
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
import itertools
import os
import threading
import time
from collections import defaultdict
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

_profiler_on = torch._C._autograd._profiler_enabled   # this thread's flag
# a profiler range from one C++ call (record_function's Python op costs
# about ten times as much); the same range, shown under its name
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.profiler.record_function)

CAPACITY = 1 << 17          # spans the buffer holds; later ones are dropped
FIT_TOLERANCE_NS = 20_000   # pairs further off the fitted clock are left out
MAX_DRIFT = 1e-4            # of one clock against the other, at most


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


class Span(NamedTuple):
    """One recorded span; times in ns of ``time.perf_counter_ns`` (of the
    profiler's clock after ``to_profiler_time``)."""

    name: str
    start_ns: int
    end_ns: int
    thread: int
    id: int
    parent: Optional[int]
    call: int
    marked: bool            # opened a record_function of its name
    attrs: dict
    counts: dict


class _Recorder:
    """The process's span buffer and counter totals."""

    def __init__(self):
        self.lock = threading.Lock()
        self.tracing = 0            # depth of open ``tracing()`` blocks
        self.spans: list = []
        self.counts: dict = defaultdict(int)
        self.dropped = 0
        self.nvtx = None            # decided at the first recorded span

    def close(self, rec: Span):
        """Keep an ended span (or count it dropped); one fewer open."""
        global _LIVE
        with self.lock:
            _LIVE -= 1
            if len(self.spans) < CAPACITY:
                self.spans.append(rec)
            else:
                self.dropped += 1


class _Stack(threading.local):
    def __init__(self):
        self.open = []              # this thread's open spans, innermost last


_REC = _Recorder()
_TLS = _Stack()
_LIVE = 0   # open tracing() blocks + recorded spans open on any thread
_IDS = itertools.count(1)
_OFF = contextlib.nullcontext()


class _Open:
    """A span being recorded; ``with span(...) as s`` binds it, and ``s``
    is the ``parent=`` that hands its call to another thread."""

    __slots__ = ("name", "parent", "attrs", "id", "call", "start", "rf",
                 "counts")

    def __init__(self, name: str, parent, attrs: dict):
        self.name, self.parent, self.attrs = name, parent, attrs
        self.counts = None

    def __enter__(self):
        self.id = next(_IDS)
        self.call = self.id if self.parent is None else self.parent.call
        _TLS.open.append(self)
        _opened()
        self.start = time.perf_counter_ns()
        if _REC.nvtx is None:
            _REC.nvtx = torch.cuda.is_available()
        if _REC.nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self.rf = None
        if _profiler_on():
            self.rf = _RANGE(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if _REC.nvtx:
            torch.cuda.nvtx.range_pop()
        end = time.perf_counter_ns()
        _TLS.open.pop()
        _REC.close(Span(self.name, self.start, end, threading.get_ident(),
                      self.id, None if self.parent is None else
                      self.parent.id, self.call, self.rf is not None,
                      self.attrs, dict(self.counts or {})))
        return False


def _opened() -> None:
    global _LIVE
    with _REC.lock:
        _LIVE += 1


def span(name: str, parent=None, **attrs):
    """Record the enclosed block as a span named ``name`` (with ``attrs``)
    while tracing is on (``tracing()``, or a profiler recording on this
    thread), or inside a recorded span, whose child it becomes; otherwise
    a shared no-op context.  ``parent``: a recorded span (what ``with
    span(...) as s`` bound, None where that span was off) of which this
    one is a child, also on another thread: so a worker records exactly
    when its caller does."""
    if parent is None:
        if not (_LIVE or _profiler_on()):
            return _OFF
        stack = _TLS.open
        if stack:
            parent = stack[-1]
        elif not (_REC.tracing or _profiler_on()):
            return _OFF
    return _Open(name, parent, attrs)


annotate = span


def count(name: str, n) -> None:
    """Add ``n`` to the counter ``name`` (and to the innermost open span's
    counts), under ``span``'s switch."""
    if not (_LIVE or _profiler_on()):
        return
    stack = _TLS.open
    if not stack and not (_REC.tracing or _profiler_on()):
        return
    with _REC.lock:
        _REC.counts[name] += n
        if stack:
            top = stack[-1]
            if top.counts is None:
                top.counts = defaultdict(int)
            top.counts[name] += n


@contextlib.contextmanager
def tracing():
    """Record spans and counts on every thread inside the block (they also
    record, without it, on a thread where a ``torch.profiler`` records)."""
    global _LIVE
    with _REC.lock:
        _REC.tracing += 1
        _LIVE += 1
    try:
        yield
    finally:
        with _REC.lock:
            _REC.tracing -= 1
            _LIVE -= 1


def spans() -> list:
    """The recorded spans (``Span``), in the order they ended."""
    with _REC.lock:
        return list(_REC.spans)


def counters() -> dict:
    """The counters' totals."""
    with _REC.lock:
        return dict(_REC.counts)


def dropped() -> int:
    """Spans that ended while the buffer was full (``CAPACITY``)."""
    return _REC.dropped


def reset() -> None:
    """Clear the recorded spans, the counters and ``dropped``."""
    with _REC.lock:
        _REC.spans.clear()
        _REC.counts.clear()
        _REC.dropped = 0


def to_profiler_time(recorded, events) -> list:
    """The spans of the calls that a ``torch.profiler`` saw, on the clock
    of its events.

    ``recorded``: spans (``spans()``); ``events``: the profiler's host
    events as (name, start_ns, end_ns), e.g. from
    ``prof.profiler.kineto_results.events()``.  A span that opened a
    ``record_function`` has an event of its name: the latest such spans
    of each name are paired, in order, with the latest events of that
    name (so spans of earlier profiled runs find none).  The profiler's
    clock is fitted as a line in the spans' clock through the pairs'
    midpoints (its slope by least squares, within ``MAX_DRIFT``, its
    offset the median's), in passes that leave out the pairs off the last
    line by more than a band that narrows to ``FIT_TOLERANCE_NS`` (a
    profiler's slow first entry, a thread switch inside a span's entry).
    Every span of a call that has a pair left is returned, its start and
    end on that line, in order of start.  [] where nothing pairs; raises
    ValueError where fewer than half the pairs agree on one line (the
    spans and events are not of one run)."""
    theirs = defaultdict(list)
    for name, s, e in events:
        theirs[name].append((s, e))
    mine = defaultdict(list)
    for sp in recorded:
        if sp.marked:
            mine[sp.name].append(sp)
    pairs = []
    for name, ours in mine.items():
        ev = sorted(theirs.get(name, ()))
        n = min(len(ours), len(ev))
        if n:
            ours.sort(key=lambda sp: sp.start_ns)
            pairs += zip(ours[len(ours) - n:], ev[len(ev) - n:])
    if not pairs:
        return []
    x = np.array([(sp.start_ns + sp.end_ns) // 2 for sp, _ in pairs],
                 np.int64)
    d = np.array([(s + e) // 2 for _, (s, e) in pairs], np.int64) - x
    x0, d0 = int(x.min()), int(np.median(d))
    u, v = (x - x0).astype(np.float64), (d - d0).astype(np.float64)
    keep = np.abs(v) <= 50 * FIT_TOLERANCE_NS
    # each pass fits the kept pairs and keeps those near the line, in a
    # narrower band, so that a few slow entries cannot tilt the last fit
    for band in (10, 2.5, 1):
        if keep.sum() < max(1, len(pairs) / 2):
            break
        slope = 0.0
        if np.ptp(u[keep]) > 0:
            slope = float(np.clip(np.polyfit(u[keep], v[keep], 1)[0],
                                  -MAX_DRIFT, MAX_DRIFT))
        icpt = float(np.median(v[keep] - slope * u[keep]))
        keep = np.abs(v - (icpt + slope * u)) <= band * FIT_TOLERANCE_NS
    if keep.sum() < max(1, len(pairs) / 2):
        raise ValueError(
            f"{int(keep.sum())} of {len(pairs)} span/event pairs agree on "
            "one clock: the spans are not of the profiled run")
    calls = {pairs[i][0].call for i in np.flatnonzero(keep)}

    def at(t: int) -> int:
        return t + d0 + int(round(icpt + slope * (t - x0)))

    return sorted((sp._replace(start_ns=at(sp.start_ns), end_ns=at(sp.end_ns))
                   for sp in recorded if sp.call in calls),
                  key=lambda sp: sp.start_ns)


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
