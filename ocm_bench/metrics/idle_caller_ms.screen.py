"""idle_caller_ms.screen: the device's idle time in the traced window
under no `serving.score` span (the client between calls), per frame (ms).
With idle_wait_ms.screen and idle_score_ms.screen it shares out the
window's idle time exactly."""

from ocm_bench import spans


def read(ctx):
    return spans.idle_ms(ctx, "caller")
