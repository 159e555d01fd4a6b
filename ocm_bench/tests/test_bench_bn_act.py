"""The reader of bn_act_fused_pct.screen on synthetic spans and counts."""

import pytest

from ocm_bench import run
from ocm_bench.tests import test_bench_spans as syn
from ocm_tpu_torch.utils import profiling

FUSED, PLAIN = "model.bn_act_eval_fused", "model.bn_act_eval_plain"


def with_counts(per_decide):
    """The synthetic spans of test_bench_spans, each `serving.decide`
    carrying ``per_decide`` (a dict of counts, or a list of one a
    decide)."""
    out, i = [], 0
    for sp in syn.recorded():
        if sp.name == "serving.decide":
            c = per_decide[i] if isinstance(per_decide, list) else per_decide
            sp = sp._replace(counts=dict(c))
            i += 1
        out.append(sp)
    return out


@pytest.fixture
def read():
    return run.reader("bn_act_fused_pct.screen")


def ctx_with(monkeypatch, recorded):
    monkeypatch.setattr(profiling, "spans", lambda: recorded)
    return {"trace": syn.synthetic(), "counts": {"frames": 2}}


def test_only_fused_reads_100(monkeypatch, read):
    ctx = ctx_with(monkeypatch, with_counts({FUSED: 9}))
    assert read(ctx) == 100.0


def test_mixed_counts_read_the_fused_share(monkeypatch, read):
    # three decides: 9 fused, 6 fused + 3 plain, 3 plain
    ctx = ctx_with(monkeypatch, with_counts(
        [{FUSED: 9}, {FUSED: 6, PLAIN: 3}, {PLAIN: 3}]))
    assert read(ctx) == pytest.approx(100.0 * 15 / 21)


@pytest.mark.parametrize("counts", [{}, {"serving.h2d_bytes": 5}],
                         ids=["none", "other"])
def test_neither_counter_reads_none(monkeypatch, read, counts):
    ctx = ctx_with(monkeypatch, with_counts(counts))
    assert read(ctx) is None
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert read(ctx) is None
    monkeypatch.delattr(profiling, "spans")        # a program without spans
    assert read(ctx) is None
