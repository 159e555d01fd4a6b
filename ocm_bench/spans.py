"""The program's spans in a traced window.

``ocm_tpu_torch.utils.profiling`` records spans while a ``torch.profiler``
records on the scoring thread, as it does in a ``--trace 1`` run.  They
are put on the clock of the profiler's events
(``profiling.to_profiler_time``, fitted through the scoring thread's spans
and their ``record_function`` events) and clipped to the trace's window.
A program that records no spans (one without ``profiling.spans``) gives
None, as does a trace the spans do not fit.
"""

from __future__ import annotations

from ocm_bench import trace


def window_spans(ctx) -> list | None:
    """[(name, start_ns, end_ns, counts)] of the program's spans that
    overlap the window, clipped to it, in order of start; None where
    there is none."""
    try:
        from ocm_tpu_torch.utils import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "spans", lambda: [])()
    convert = getattr(profiling, "to_profiler_time", None)
    if not recorded or convert is None:
        return None
    tr = ctx["trace"]
    names = {sp.name for sp in recorded if sp.marked}
    events = [ev for ev in tr.events[trace.HOST] if ev[0] in names]
    try:
        spans = convert(recorded, events)
    except ValueError:
        return None
    out = [(sp.name, max(sp.start_ns, tr.start), min(sp.end_ns, tr.end),
            sp.counts) for sp in spans]
    return [sp for sp in out if sp[2] > sp[1]] or None


def union(intervals) -> list:
    """Sorted disjoint [start, end] intervals covering ``intervals``."""
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def length(intervals) -> int:
    return sum(e - s for s, e in intervals)


def intersect(a, b) -> list:
    """The intersection of two sorted disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            out.append([s, e])
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def of(spans, name: str) -> list:
    """The union of the spans named ``name``."""
    return union((s, e) for n, s, e, _ in spans if n == name)


def idle_split(ctx) -> dict | None:
    """The device's idle ns in the window (``trace.gaps()``) shared out
    exactly: 'wait' under a ``serving.wait_input`` (inside a
    ``serving.score``), 'score' under a ``serving.score`` but not a wait,
    'caller' under no ``serving.score``.  None without a score span."""
    spans = window_spans(ctx)
    if not spans:
        return None
    score = of(spans, "serving.score")
    if not score:
        return None
    idle = [list(g) for g in ctx["trace"].gaps()]
    in_score = intersect(idle, score)
    wait = length(intersect(in_score, of(spans, "serving.wait_input")))
    return {"wait": wait, "score": length(in_score) - wait,
            "caller": length(idle) - length(in_score)}


def idle_ms(ctx, part: str) -> float | None:
    """One part of ``idle_split`` a frame, in ms."""
    split, frames = idle_split(ctx), ctx["counts"].get("frames")
    if split is None or not frames:
        return None
    return 1e-6 * split[part] / frames
