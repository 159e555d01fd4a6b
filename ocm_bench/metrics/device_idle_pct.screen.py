"""device_idle_pct.screen: 100 x (1 - the union of the device's kernel,
copy and set intervals / the traced steady window)."""


def read(ctx):
    tr = ctx["trace"]
    if tr.window_s <= 0 or tr.busy_s() <= 0:
        return None
    return tr.idle_pct()
