"""idle_score_ms.screen: the device's idle time in the traced window
inside a `serving.score` call but under no `serving.wait_input` span (the
enqueue, the fetch's host epilogue, the concatenation, the worker pool's
start and join), per frame (ms)."""

from ocm_bench import spans


def read(ctx):
    return spans.idle_ms(ctx, "score")
