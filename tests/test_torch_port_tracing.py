"""Spans and counters of ``ocm_tpu_torch.utils.profiling`` in the chunked
scorer: what ``VAEScorer.score`` records with tracing off and on, on which
thread and under which call, the byte counter, the clock conversion onto
the profiler's events, the buffer's cap, and outputs unchanged by tracing.

A float64 ``VAEScorer`` on the CPU screens 3 chunks (two full, one ragged)
at prefetch 1.  The card-only case holds each converted ``serving.input``
span against its chunk's ``cudaMemcpyAsync`` in the profiler's events.
"""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ocm_tpu_torch.models.bundle import new_bundle, spectral_stats
from ocm_tpu_torch.models.vae import ConvVAE1D
from ocm_tpu_torch.serving import VAEScorer
from ocm_tpu_torch.utils import profiling

L, CHUNK, N = 48, 64, 150          # 3 chunks: 64, 64 and a ragged 22
# what a traced score counts: the bytes put on the device, and the two
# conv blocks' eval epilogues of each chunk's encoder (plain: f64, CPU)
COUNTS = {"serving.h2d_bytes": 3 * CHUNK * L * 8,
          "model.bn_act_eval_plain": 3 * 2}
CALLER = ("serving.score", "serving.wait_input", "serving.decide",
          "serving.fetch")


def _scorer(device="cpu", dtype=torch.float64, length=L, chunk=CHUNK):
    torch.manual_seed(3)
    model = ConvVAE1D(length, 4, conv_blocks=2, n_filters=8, kernel_size=9,
                      stride=2, hidden_fc=32)
    x_cal = torch.randn(256, length, dtype=dtype, device=device)
    mean, std = spectral_stats(x_cal)
    bundle = new_bundle({k: v.to(device) for k, v in
                         model.state_dict().items()}, mean, std, 4)
    return VAEScorer(model, bundle, variant="d2", chunk_size=chunk)


@pytest.fixture(scope="module")
def scorer():
    return _scorer()


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(5).standard_normal((N, L))


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.reset()
    yield
    profiling.reset()


def _host_events(prof):
    """The profiler's host events as (name, start_ns, end_ns)."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if str(e.device_type()).endswith("CPU")]


def _by_name(recorded):
    out = {}
    for sp in recorded:
        out.setdefault(sp.name, []).append(sp)
    return out


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def test_off_records_nothing_and_adds_no_event(scorer, x):
    assert profiling.span("a") is profiling.span("b")     # the shared no-op
    scorer.score(x, prefetch=1)
    assert profiling.spans() == [] and profiling.counters() == {}
    # a profiler recording on another thread does not turn this one on
    done = threading.Event()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t = threading.Thread(target=lambda: (scorer.score(x, prefetch=1),
                                             done.set()))
        t.start()
        t.join(timeout=120)
    assert done.is_set() and not t.is_alive()
    assert profiling.spans() == [] and profiling.counters() == {}
    assert not [n for n, _, _ in _host_events(prof)
                if n.startswith("serving.")]


def _check_call(recorded, caller, inputs_on_caller, waits):
    """One ``score`` call's spans: their counts, threads, call and parents;
    returns them by name."""
    by = _by_name(recorded)
    (score,) = by["serving.score"]
    counts = {k: len(v) for k, v in by.items()}
    assert counts == {"serving.score": 1, "serving.input": 3,
                      "serving.decide": 3, "serving.fetch": 3,
                      **({"serving.wait_input": waits} if waits else {})}
    for name in CALLER:
        for sp in by.get(name, []):
            assert sp.thread == caller and sp.call == score.id
            if name != "serving.score":
                assert sp.parent == score.id
    assert score.parent is None
    for sp in by["serving.input"]:
        assert (sp.thread == caller) == inputs_on_caller
        assert sp.counts == {"serving.h2d_bytes": CHUNK * L * 8}
    return by


@pytest.mark.parametrize("prefetch", [1, 0])
def test_profiled_score_records_its_spans(scorer, x, prefetch):
    _, prof = _profiled(lambda: scorer.score(x, prefetch=prefetch))
    by = _check_call(profiling.spans(), threading.get_ident(),
                     inputs_on_caller=prefetch == 0,
                     waits=3 if prefetch else 0)
    score = by["serving.score"][0]
    assert all(sp.call == score.id and sp.parent == score.id
               for sp in by["serving.input"])
    names = [n for n, _, _ in _host_events(prof)]
    for sp in profiling.spans():
        if sp.thread == threading.get_ident():
            assert sp.marked
            assert names.count(sp.name) == len(by[sp.name])
    assert profiling.counters() == COUNTS


def test_profiled_prepare_and_score_prepared(scorer, x):
    def run():
        return scorer.score_prepared(scorer.prepare(x))

    _, prof = _profiled(run)
    recorded = profiling.spans()
    by = _by_name(recorded)
    (prep,) = by["serving.prepare"]
    (score,) = by["serving.score"]
    assert [sp.name for sp in recorded].count("serving.input") == 3
    for sp in by["serving.input"]:
        assert sp.call == prep.id and sp.parent == prep.id
    for name in ("serving.decide", "serving.fetch"):
        assert len(by[name]) == 3
        assert all(sp.call == score.id and sp.parent == score.id
                   for sp in by[name])
    assert "serving.wait_input" not in by
    assert profiling.counters() == COUNTS


def test_tracing_switch_records_without_a_profiler(scorer, x):
    with profiling.tracing():
        scorer.score(x, prefetch=1)
        profiling.count("frames", 1)
    _check_call(profiling.spans(), threading.get_ident(),
                inputs_on_caller=False, waits=3)
    assert not any(sp.marked for sp in profiling.spans())
    assert profiling.counters() == {**COUNTS, "frames": 1}
    scorer.score(x, prefetch=1)                  # off again
    assert len(profiling.spans()) == 13


def test_spans_convert_onto_the_profiler_clock(scorer, x):
    _, prof = _profiled(lambda: scorer.score(x, prefetch=1))
    events = _host_events(prof)
    conv = profiling.to_profiler_time(profiling.spans(), events)
    assert len(conv) == 13
    by = _by_name(conv)
    (s0, e0), = [(s, e) for n, s, e in events if n == "serving.score"]
    for sp in by["serving.input"]:
        assert s0 <= sp.start_ns and sp.end_ns <= e0
    tol = profiling.FIT_TOLERANCE_NS
    for name in CALLER:
        theirs = sorted((s, e) for n, s, e in events if n == name)
        for sp, (s, e) in zip(by[name], theirs):
            assert sp.start_ns <= s + tol and e <= sp.end_ns + tol, name


def test_conversion_keeps_only_the_profiled_run(scorer, x):
    _profiled(lambda: scorer.score(x, prefetch=1))        # an earlier run
    first = {sp.id for sp in profiling.spans()}
    _, prof = _profiled(lambda: scorer.score(x, prefetch=1))
    conv = profiling.to_profiler_time(profiling.spans(), _host_events(prof))
    assert len(conv) == 13 and not {sp.id for sp in conv} & first
    assert profiling.to_profiler_time(profiling.spans(), []) == []
    shifted = [(n, s + 7 * 10 ** 6 * i, e + 7 * 10 ** 6 * i)
               for i, (n, s, e) in enumerate(_host_events(prof))]
    with pytest.raises(ValueError, match="agree"):
        profiling.to_profiler_time(profiling.spans(), shifted)


def test_buffer_stops_at_its_cap(monkeypatch, scorer, x):
    monkeypatch.setattr(profiling, "CAPACITY", 5)
    with profiling.tracing():
        scorer.score(x, prefetch=1)
    assert len(profiling.spans()) == 5 and profiling.dropped() == 8
    profiling.reset()
    assert profiling.spans() == [] and profiling.dropped() == 0


@pytest.mark.parametrize("prefetch", [0, 1])
def test_tracing_leaves_outputs_bit_equal(scorer, x, prefetch):
    off = scorer.score(x, prefetch=prefetch)
    on, _ = _profiled(lambda: scorer.score(x, prefetch=prefetch))
    assert off.keys() == on.keys()
    for k in off:
        assert off[k].dtype == on[k].dtype
        np.testing.assert_array_equal(off[k], on[k])


@pytest.fixture
def cuda():
    """The CUDA device, decided when the test runs; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the copies are the card's")
    return torch.device("cuda")


@pytest.mark.cuda
def test_input_spans_enclose_their_copies_on_the_card(cuda):
    """Each converted ``serving.input`` span holds its chunk's
    ``cudaMemcpyAsync`` (a runtime event of the worker thread), within the
    fit's tolerance, in >= 99 % of chunks."""
    length, chunk, frames = 288, 16384, 60
    scorer = _scorer(cuda, torch.float32, length, chunk)
    frame = np.random.default_rng(7).standard_normal(
        (2 * chunk, length)).astype(np.float32)
    scorer.score(frame, prefetch=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            scorer.score(frame, prefetch=1)
        torch.cuda.synchronize()
    raw = prof.profiler.kineto_results.events()
    host = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in raw if str(e.device_type()).endswith("CPU")
            and e.name().startswith("serving.")]
    # the runtime calls of the host-to-device copies, by their device copy:
    # CUPTI's correlation id pairs the two (a runtime event's linked id is
    # the profiler's operator id, another numbering that can collide)
    htod = {e.correlation_id() for e in raw if "HtoD" in e.name()} - {0}
    copies = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in raw if e.name() == "cudaMemcpyAsync"
                    and e.correlation_id() in htod)
    conv = profiling.to_profiler_time(profiling.spans(), host)
    inputs = [sp for sp in conv if sp.name == "serving.input"]
    assert len(inputs) == 2 * frames and len(copies) == 2 * frames, \
        (len(inputs), len(copies))
    tol = profiling.FIT_TOLERANCE_NS
    held = sum(sp.start_ns - tol <= s and e <= sp.end_ns + tol
               for sp, (s, e) in zip(inputs, copies))
    print(f"{held} of {len(inputs)} serving.input spans enclose their "
          f"cudaMemcpyAsync within {tol} ns")
    assert held >= 0.99 * len(inputs)
