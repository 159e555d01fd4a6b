"""The device trace of a run's steady window, read from ``torch.profiler``.

The window is the span of the ``record_function`` named ``WINDOW`` that
the harness opens around the measured loop, so set-up and warm-up are
outside it.  Device activity is read from the profiler's raw event list
(``kineto_results.events()``): kernels, memory copies and sets on the
device, CUDA runtime and driver calls, and the host's operators.

``busy_s`` is the length of the union of the device's kernel, copy and
set intervals inside the window; the idle share that every metric and the
run's ``device`` record give is 1 - busy_s / window_s of that same union.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

WINDOW = "ocm_bench.window"
KERNEL, COPY, RUNTIME, HOST = "kernel", "copy", "runtime", "host"
_KINDS = {"kernel": KERNEL, "gpu_memcpy": COPY, "gpu_memset": COPY,
          "cuda_runtime": RUNTIME, "cuda_driver": RUNTIME,
          "cpu_op": HOST, "user_annotation": HOST,
          "python_function": HOST}


@dataclass
class Trace:
    """Events as (name, start_ns, end_ns) by kind, and the window."""

    start: int = 0
    end: int = 0
    events: dict = field(default_factory=lambda: defaultdict(list))

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-9

    def inside(self, kind: str):
        """Events of ``kind`` clipped to the window (empty ones dropped)."""
        for name, s, e in self.events[kind]:
            s, e = max(s, self.start), min(e, self.end)
            if e > s:
                yield name, s, e

    def busy_intervals(self) -> list:
        spans = sorted((s, e) for kind in (KERNEL, COPY)
                       for _, s, e in self.inside(kind))
        merged: list = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def idle_pct(self) -> float | None:
        if self.end <= self.start:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def device_seconds(self, kind: str, contains: str = "") -> tuple:
        """(seconds, count) of the events of ``kind`` whose name contains
        ``contains``."""
        total, count = 0, 0
        for name, s, e in self.inside(kind):
            if contains in name:
                total += e - s
                count += 1
        return total * 1e-9, count

    def gaps(self) -> list:
        """The device's idle intervals inside the window."""
        out, at = [], self.start
        for s, e in self.busy_intervals():
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if self.end > at:
            out.append((at, self.end))
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by the innermost host operation running at each gap's
        middle ('python' where none is)."""
        ops: dict = defaultdict(int)
        for kind in (KERNEL, COPY):
            for name, s, e in self.inside(kind):
                ops[name] += e - s
        host = sorted(self.events[HOST], key=lambda ev: ev[1])
        starts = [s for _, s, _ in host]
        idle: dict = defaultdict(int)
        for gs, ge in self.gaps():
            mid = (gs + ge) // 2
            i = bisect.bisect_right(starts, mid) - 1
            name = "python"
            for j in range(i, max(i - 4096, -1), -1):
                if host[j][2] >= mid and host[j][0] != WINDOW:
                    name = host[j][0]
                    break
            idle[name] += ge - gs

        def head(d):
            return [[n[:120], v * 1e-9] for n, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": head(ops), "idle_gaps": head(idle)}


def kind_of(event) -> str | None:
    """KERNEL, COPY, RUNTIME or HOST, by the event's activity type where
    the profiler gives one, else by its device and name (None: an event
    that is none of these, such as the device's copy of an annotation)."""
    kind = getattr(event, "activity_type", None)
    if kind is not None:
        return _KINDS.get(kind() if callable(kind) else str(kind))
    name = event.name()
    if str(event.device_type()).endswith("CUDA"):
        return COPY if name.startswith(("Memcpy", "Memset")) else KERNEL
    if name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper()):
        return RUNTIME
    return HOST


def from_events(raw) -> Trace:
    """A ``Trace`` from the profiler's raw events (objects with
    ``name()``, ``start_ns()``, ``duration_ns()`` and
    ``activity_type()``)."""
    tr = Trace()
    for ev in raw:
        kind = kind_of(ev)
        if kind is None:
            continue
        s = ev.start_ns()
        e = s + ev.duration_ns()
        name = ev.name()
        if kind == HOST and name == WINDOW:
            tr.start, tr.end = s, e
        tr.events[kind].append((name, s, e))
    # the device's copies of host annotations (record_function spans) are
    # no device work
    host_names = {name for name, _, _ in tr.events[HOST]}
    tr.events[KERNEL] = [ev for ev in tr.events[KERNEL]
                         if ev[0] not in host_names]
    return tr


def from_profiler(prof) -> Trace:
    return from_events(prof.profiler.kineto_results.events())
