"""The span readers on a synthetic trace and synthetic program spans."""

import pytest

from ocm_bench import run, spans, trace
from ocm_bench.tests.test_bench_trace import Ev
from ocm_tpu_torch.utils import profiling

OFFSET = 7_000_000          # the profiler's clock less the spans' clock
CALLER, WORKER = 1, 2
READERS = ["idle_wait_ms.screen", "idle_score_ms.screen",
           "idle_caller_ms.screen", "input_ms.screen", "h2d_gbps.screen"]

# two frames in the window [1000, 41000] (profiler ns): (name, start, end,
# thread, parent index); the caller's spans are marked, the worker's not
SPANS = [
    ("serving.score", 2000, 20000, CALLER, None),
    ("serving.wait_input", 2500, 6000, CALLER, 0),
    ("serving.decide", 6000, 7000, CALLER, 0),
    ("serving.fetch", 7000, 12000, CALLER, 0),
    ("serving.wait_input", 12000, 14000, CALLER, 0),
    ("serving.decide", 14000, 15000, CALLER, 0),
    ("serving.fetch", 15000, 19500, CALLER, 0),
    ("serving.input", 2500, 5500, WORKER, 0),
    ("serving.input", 6500, 13500, WORKER, 0),
    ("serving.score", 21000, 40500, CALLER, None),
    ("serving.wait_input", 21500, 26000, CALLER, 9),
    ("serving.decide", 26000, 27000, CALLER, 9),
    ("serving.fetch", 27000, 40000, CALLER, 9),
    ("serving.input", 500, 25500, WORKER, 9),    # starts before the window
]
BYTES = 1000                # each serving.input's serving.h2d_bytes
DEVICE = [("kernel", "k", 6500, 11000),
          ("gpu_memcpy", "Memcpy HtoD", 4500, 5500),
          ("gpu_memcpy", "Memcpy HtoD", 12500, 13500),
          ("kernel", "k", 14500, 19000),
          ("gpu_memcpy", "Memcpy HtoD", 24500, 25500),
          ("kernel", "k", 26500, 38000)]


def recorded():
    out = []
    for i, (name, s, e, thread, parent) in enumerate(SPANS):
        root = i if parent is None else parent
        out.append(profiling.Span(
            name, s - OFFSET, e - OFFSET, thread, i, parent, root,
            thread == CALLER, {},
            {"serving.h2d_bytes": BYTES} if name == "serving.input" else {}))
    return out


def synthetic():
    evs = [Ev("user_annotation", trace.WINDOW, 1000, 40_000)]
    evs += [Ev("user_annotation", n, s, e - s)
            for n, s, e, thread, _ in SPANS if thread == CALLER]
    evs += [Ev(kind, n, s, e - s) for kind, n, s, e in DEVICE]
    return trace.from_events(evs)


@pytest.fixture
def ctx(monkeypatch):
    monkeypatch.setattr(profiling, "spans", recorded)
    return {"trace": synthetic(), "counts": {"frames": 2}}


def brute_force(tr):
    """The split of the idle ns by a 500 ns grid (every boundary above is
    a multiple of 500)."""
    busy = [(s, e) for kind, _, s, e in DEVICE]
    score = [(s, e) for n, s, e, _, _ in SPANS if n == "serving.score"]
    wait = [(s, e) for n, s, e, _, _ in SPANS if n == "serving.wait_input"]
    inputs = [(s, e) for n, s, e, _, _ in SPANS if n == "serving.input"]

    def under(t, iv):
        return any(s <= t < e for s, e in iv)

    out = dict.fromkeys(("wait", "score", "caller", "input"), 0)
    for t in range(tr.start, tr.end, 500):
        out["input"] += 500 * under(t, inputs)
        if under(t, busy):
            continue
        part = ("caller" if not under(t, score) else
                "wait" if under(t, wait) else "score")
        out[part] += 500
    return out


def test_idle_split_shares_out_the_idle_time(ctx):
    tr = ctx["trace"]
    want = brute_force(tr)
    got = {part: run.reader(f"idle_{part}_ms.screen")(ctx)
           for part in ("wait", "score", "caller")}
    for part, v in got.items():
        assert v == pytest.approx(1e-6 * want[part] / 2), part
    idle_pct = run.reader("device_idle_pct.screen")(ctx)
    # that share of the window, in ms a frame
    assert sum(got.values()) == pytest.approx(idle_pct * 10 * tr.window_s / 2)


def test_input_and_copy_rate(ctx):
    want = brute_force(ctx["trace"])
    assert run.reader("input_ms.screen")(ctx) == \
        pytest.approx(1e-6 * want["input"] / 2)
    # three spans overlap the window, 3000 ns of HtoD copies
    assert run.reader("h2d_gbps.screen")(ctx) == \
        pytest.approx(1e-9 * 3 * BYTES / 3e-6)


def test_spans_are_clipped_to_the_window(ctx):
    got = spans.window_spans(ctx)
    assert len(got) == len(SPANS)
    assert min(s for _, s, _, _ in got) == ctx["trace"].start


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_without_spans(monkeypatch, ctx, name):
    read = run.reader(name)
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert read(ctx) is None
    monkeypatch.delattr(profiling, "spans")        # a program without spans
    assert read(ctx) is None
    assert read({"trace": trace.Trace(), "counts": {"frames": 2}}) is None


def test_spans_of_another_run_find_nothing(monkeypatch, ctx):
    # every event a millisecond off its span: no two pairs agree
    shifted = [sp._replace(start_ns=sp.start_ns + 10 ** 6 * i,
                           end_ns=sp.end_ns + 10 ** 6 * i)
               for i, sp in enumerate(recorded())]
    monkeypatch.setattr(profiling, "spans", lambda: shifted)
    assert spans.window_spans(ctx) is None
    assert all(run.reader(n)(ctx) is None for n in READERS)
