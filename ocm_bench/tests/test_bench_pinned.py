"""The reader of ``h2d_pinned_pct.screen`` on the synthetic trace and
program spans of ``test_bench_spans``: three ``serving.input`` spans
overlap the window, each counting ``BYTES`` put on the device."""

import pytest

from ocm_bench import run, trace
from ocm_bench.tests.test_bench_spans import BYTES, recorded, synthetic
from ocm_tpu_torch.utils import profiling

NAME = "h2d_pinned_pct.screen"
PINNED = "serving.h2d_bytes_pinned"


def _with_pinned(pinned):
    """The recorded spans, the i-th ``serving.input`` counting
    ``pinned[i]`` pinned bytes (None: no pinned counter)."""
    out, i = [], 0
    for sp in recorded():
        if sp.name == "serving.input":
            if pinned[i] is not None:
                sp = sp._replace(counts={**sp.counts, PINNED: pinned[i]})
            i += 1
        out.append(sp)
    return out


def _read(monkeypatch, got):
    monkeypatch.setattr(profiling, "spans", lambda: got)
    return run.reader(NAME)({"trace": synthetic(), "counts": {"frames": 2}})


@pytest.mark.parametrize("pinned, want", [
    ((BYTES, BYTES, BYTES), 100.0),
    ((BYTES, 0, 0), 100.0 / 3),
    ((BYTES // 2, BYTES, None), 50.0),
    ((0, 0, 0), 0.0),
])
def test_share_of_the_window_bytes(monkeypatch, pinned, want):
    assert _read(monkeypatch, _with_pinned(pinned)) == pytest.approx(want)


def test_finds_nothing_without_the_pinned_counter(monkeypatch):
    # a program that counts serving.h2d_bytes alone (no pinned staging)
    assert _read(monkeypatch, _with_pinned((None, None, None))) is None
    no_bytes = [sp._replace(counts={}) for sp in recorded()]
    assert _read(monkeypatch, no_bytes) is None


def test_finds_nothing_without_spans(monkeypatch):
    read = run.reader(NAME)
    empty = {"trace": trace.Trace(), "counts": {"frames": 2}}
    assert _read(monkeypatch, []) is None
    monkeypatch.delattr(profiling, "spans")        # a program without spans
    assert read({"trace": synthetic(), "counts": {"frames": 2}}) is None
    assert read(empty) is None
