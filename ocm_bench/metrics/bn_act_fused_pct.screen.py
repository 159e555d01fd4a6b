"""bn_act_fused_pct.screen: the share of the eval-mode conv epilogues that
ran in the program's one-pass kernel, of all it ran in the traced window
(%): 100 x fused / (fused + plain) of the counters
`model.bn_act_eval_fused` and `model.bn_act_eval_plain`, counted in the
program's spans that overlap the window (a chunk's `serving.decide`).
None where neither counter is found (a program without them)."""

from ocm_bench import spans

FUSED, PLAIN = "model.bn_act_eval_fused", "model.bn_act_eval_plain"


def read(ctx):
    got = spans.window_spans(ctx) or []
    fused = sum(c.get(FUSED, 0) for _, _, _, c in got)
    plain = sum(c.get(PLAIN, 0) for _, _, _, c in got)
    if not fused + plain:
        return None
    return 100.0 * fused / (fused + plain)
