"""idle_wait_ms.screen: the device's idle time in the traced window while
the scoring thread waits for a chunk's input (a `serving.wait_input`
span: pad, host stage and copy on the prefetch worker), per frame (ms)."""

from ocm_bench import spans


def read(ctx):
    return spans.idle_ms(ctx, "wait")
