"""h2d_gbps.screen: the bytes the program put on the device in the traced
window (its counter `serving.h2d_bytes`, counted in the `serving.input`
spans that overlap the window) over the device time of the window's
host-to-device copies (GB/s)."""

from ocm_bench import spans, trace


def read(ctx):
    got = spans.window_spans(ctx)
    moved = sum(c.get("serving.h2d_bytes", 0) for _, _, _, c in got or [])
    seconds, count = ctx["trace"].device_seconds(trace.COPY, "HtoD")
    if not moved or not count or seconds <= 0:
        return None
    return 1e-9 * moved / seconds
