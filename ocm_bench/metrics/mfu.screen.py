"""mfu.screen: the screen's network FLOPs (``flops.screen_flops`` of the
cell's variant, once per screened class) over the traced window, as a
share of the card's float32 peak.  The pass is bound by operations (about
1.2 KB read a spectrum against tens of MFLOP), so this is also its
roofline share."""

from ocm_bench import flops


def read(ctx):
    tr, counts = ctx["trace"], ctx["counts"]
    if tr.window_s <= 0 or not counts.get("spectra"):
        return None
    work = (counts["spectra"] * counts["classes"]
            * flops.screen_flops(ctx["cfg"], ctx["traffic"]["variant"]))
    return 100.0 * work / tr.window_s / flops.PEAK_F32_FLOPS
