"""h2d_pinned_pct.screen: the share of the bytes the program put on the
device in the traced window that it copied from page-locked host memory
(%): 100 x pinned / all of the counters `serving.h2d_bytes_pinned` and
`serving.h2d_bytes`, counted in the `serving.input` spans that overlap the
window.  None where the pinned counter is not found (a program without
it) or no bytes were counted."""

from ocm_bench import spans

PINNED, ALL = "serving.h2d_bytes_pinned", "serving.h2d_bytes"


def read(ctx):
    got = spans.window_spans(ctx) or []
    pinned = [c[PINNED] for _, _, _, c in got if PINNED in c]
    moved = sum(c.get(ALL, 0) for _, _, _, c in got)
    if not pinned or not moved:
        return None
    return 100.0 * sum(pinned) / moved
