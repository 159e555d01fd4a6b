"""input_ms.screen: the time the traced window spends under a
`serving.input` span (a chunk's pad, host stage and copy to the device,
on the prefetch worker), as the union of those spans, per frame (ms)."""

from ocm_bench import spans


def read(ctx):
    got, frames = spans.window_spans(ctx), ctx["counts"].get("frames")
    inputs = spans.of(got or [], "serving.input")
    if not inputs or not frames:
        return None
    return 1e-6 * spans.length(inputs) / frames
