"""h2d_ms.screen: the device time of the host-to-device copies in the
traced window, per frame (ms)."""

from ocm_bench import trace


def read(ctx):
    seconds, count = ctx["trace"].device_seconds(trace.COPY, "HtoD")
    frames = ctx["counts"].get("frames")
    if not count or not frames:
        return None
    return 1e3 * seconds / frames
