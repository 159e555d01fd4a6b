"""The chunked scorer's host path (``ocm_tpu_torch.serving._ChunkedScorer``):
one resident copy worker a scorer, the fetch one chunk behind the decide,
and on a card page-locked staging copied on a stream of its own.

On the CPU: every way of scoring gives the bits of the chunk-by-chunk path
(``score`` with and without the worker, ``prepare``/``score_prepared``)
for one chunk, a full chunk and many with a ragged tail, single and
stacked bundles, and the variants that reduce over the chunk or finish on
the host ('f' unpinned and pinned, 'full'); results own their memory; a
scorer starts one worker thread, and none is left once it is closed or
freed; many threads share one scorer; and each host stage, run on a
chunk's real rows and padded after, equals the stage of the padded chunk,
for every storage width and every rank's rows under a mesh.

The card-only tests (marker ``cuda``) hold the page-locked path against
the pageable one bit for bit and find the copies on a stream other than
the kernels'.  The file imports no JAX, so that they run on the card's
machine (``--noconftest``).
"""

import gc
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from ocm_tpu_torch.models.bundle import new_bundle, spectral_stats, \
    stack_bundles
from ocm_tpu_torch.models.simca import fit_classes, fit_simca
from ocm_tpu_torch.models.vae import ConvVAE1D
from ocm_tpu_torch.models.vaesimca import fit_vaesimca
from ocm_tpu_torch.serving import (SIMCAScorer, VAEScorer, _pad_chunk,
                                   _padded)

L, CHUNK = 48, 64
SIZES = [40, 64, 150]      # one ragged chunk, one full, three with a tail
CASES = [("d2", 1), ("d2", 3), ("vaesimca", 1), ("vaesimca", 3), ("f", 1),
         ("f_pinned", 1), ("f_pinned", 3), ("full", 1)]


def _scorer(variant="d2", classes=1, device="cpu", dtype=torch.float64,
            length=L, chunk=CHUNK):
    bundles, fitted, model = [], [], None
    for c in range(classes):
        torch.manual_seed(3 + c)
        model = ConvVAE1D(length, 4, conv_blocks=2, n_filters=8,
                          kernel_size=9, stride=2, hidden_fc=32)
        x_cal = torch.randn(256, length, dtype=dtype,
                            generator=torch.Generator().manual_seed(c))
        x_cal = x_cal.to(device)
        mean, std = spectral_stats(x_cal)
        bundle = new_bundle({k: v.to(device) for k, v in
                             model.state_dict().items()}, mean, std, 4)
        if variant == "vaesimca":
            fitted.append(fit_vaesimca(model, bundle, x_cal))
        bundles.append(bundle)
    kw = {}
    if variant == "vaesimca":
        kw["vaesimca_model"] = (stack_bundles(fitted) if classes > 1
                                else fitted[0])
    if variant == "f_pinned":
        variant, kw["pin_f_stats"] = "f", True
    bundle = stack_bundles(bundles) if classes > 1 else bundles[0]
    return VAEScorer(model, bundle, variant=variant, chunk_size=chunk,
                     loss_type="euclidean", **kw)


def _frames(n, length=L, seed=5, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(
        (n, length)).astype(dtype)


def _chunk_by_chunk(scorer, x):
    """The sequential path spelled out: each chunk padded, staged and
    copied from pageable memory, decided, read back with ``.cpu()``."""
    outs = []
    for s in range(0, len(x), scorer.chunk_size):
        chunk, n = _pad_chunk(x[s:s + scorer.chunk_size], scorer.chunk_size)
        res = scorer._decide(*scorer.to_device(scorer.host_chunk(chunk)))
        out = {k: v.cpu().numpy() for k, v in res.items()}
        if scorer._post is not None:
            out = scorer._post(out)
        outs.append({k: a[:n] for k, a in out.items()})
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


def _same(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def scorers():
    """Scorers by (variant, classes), built once; closed at the end."""
    made = {}

    def get(variant, classes):
        if (variant, classes) not in made:
            made[variant, classes] = _scorer(variant, classes)
        return made[variant, classes]

    yield get
    for s in made.values():
        s.close()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("variant, classes", CASES)
def test_every_way_of_scoring_gives_the_same_bits(scorers, variant, classes,
                                                  n):
    scorer = scorers(variant, classes)
    x = _frames(n)
    want = _chunk_by_chunk(scorer, x)
    assert len(want["accept"]) == n
    for got in (scorer.score(x, prefetch=0), scorer.score(x),
                scorer.score(x, prefetch=3),
                scorer.score_prepared(scorer.prepare(x))):
        _same(got, want)


def test_results_own_their_memory(scorers):
    scorer = scorers("f_pinned", 1)
    x, y = _frames(150), _frames(150, seed=6)
    firsts = [scorer.score(x), scorer.score(x[:40], prefetch=0),
              scorer.score_prepared(scorer.prepare(x))]
    kept = [{k: v.copy() for k, v in f.items()} for f in firsts]
    for _ in range(3):
        scorer.score(y)
        scorer.score(y[:40])
        scorer.score_prepared(scorer.prepare(y))
    for first, copy in zip(firsts, kept):
        _same(first, copy)
        for v in first.values():
            assert v.flags.owndata


def _started(before):
    """The live threads that were not running at ``before``; threads that
    other tests' freed scorers leave meanwhile do not count."""
    return set(threading.enumerate()) - before


def _settles(before, want, timeout=30.0):
    """Whether ``len(_started(before))`` reaches ``want`` in time."""
    deadline = time.monotonic() + timeout
    while len(_started(before)) != want:
        if time.monotonic() > deadline:
            return False
        gc.collect()
        time.sleep(0.01)
    return True


def test_one_worker_a_scorer_and_none_left_when_closed_or_freed():
    gc.collect()
    before = set(threading.enumerate())
    x = _frames(150)
    scorer = _scorer()
    scorer.score(x[:40])                        # one chunk: no worker
    scorer.score(x, prefetch=0)
    assert not _started(before)
    for _ in range(50):
        scorer.score(x)
    assert len(_started(before)) == 1
    scorer.close()
    assert not _started(before)                 # close() joins it
    scorer.close()
    scorer.score(x)                             # a later call restarts it
    assert len(_started(before)) == 1
    for _ in range(20):
        freed = _scorer()
        freed.score(x)
        del freed
    assert _settles(before, 1), _started(before)
    del scorer
    assert _settles(before, 0), _started(before)


def test_many_threads_share_one_scorer():
    """More calling threads than cores on one scorer (and its one worker),
    with a short switch interval: each call gets its own frame's bits."""
    scorer = _scorer("vaesimca")
    frames = [_frames(n, seed=n) for n in (30, 64, 100, 150, 200)]
    want = [scorer.score(f, prefetch=0) for f in frames]
    wrong, done = [], []

    def call(i):
        for r in range(4):
            j = (i + r) % len(frames)
            got = scorer.score(frames[j], prefetch=1 + i % 2)
            for k in want[j]:
                if not np.array_equal(got[k], want[j][k]):
                    wrong.append((i, j, k))
        done.append(i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        scorer.close()
    assert sorted(done) == list(range(16)) and wrong == []


class _Ranks:
    """The part of a ``parallel.mesh.Mesh`` that staging reads: this rank's
    rows of the data axis."""

    def __init__(self, rank, size):
        self.rank, self.size = rank, size

    def rows(self, n, axis):
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


def _simca(mode):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((60, L)).astype(np.float32)
    y = np.repeat([0, 1, 2], 20)
    if mode == "f32_one":
        return SIMCAScorer(fit_simca(torch.from_numpy(x[:20]), 3),
                           chunk_size=CHUNK)
    if mode == "raw":
        return SIMCAScorer(fit_classes(x, y, [0, 1, 2], 3, device="cpu"),
                           chunk_size=CHUNK, preprocess_fn=lambda t: t)
    dtype = {"f32": None, "bf16": torch.bfloat16, "int8": torch.int8}[mode]
    return SIMCAScorer(fit_classes(x, y, [0, 1, 2], 3, device="cpu"),
                       chunk_size=CHUNK, store_dtype=dtype)


@pytest.mark.parametrize("ranks", [1, 2, 4])
@pytest.mark.parametrize("mode", ["vae", "f32", "f32_one", "bf16", "int8",
                                  "raw"])
def test_stage_of_real_rows_padded_equals_stage_of_padded_chunk(mode, ranks):
    scorer = _scorer(dtype=torch.float32) if mode == "vae" else _simca(mode)
    x = _frames(150, dtype=np.float64 if mode == "vae" else np.float32)
    if mode == "raw":
        x = np.abs(x * 1000).astype(np.uint16)
    for n in (1, 20, 40, 64, 150):
        for start in range(0, n, CHUNK):
            for rank in range(ranks):
                scorer._mesh = _Ranks(rank, ranks) if ranks > 1 else None
                rows, size, real = scorer._rows(x[:n], start)
                got = _padded(scorer.host_chunk(rows), size)
                chunk, want_real = _pad_chunk(x[start:min(n, start + CHUNK)],
                                              CHUNK)
                if ranks > 1:
                    chunk = chunk[scorer._mesh.rows(CHUNK, "data")]
                want = scorer.host_chunk(chunk)
                assert real == want_real and len(got) == len(want)
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype and g.shape == w.shape
                    assert torch.equal(g, w), (mode, n, start, rank)


@pytest.fixture
def cuda():
    """The CUDA device, decided when the test runs; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: page-locked staging and the copy "
                    "stream are the card's")
    return torch.device("cuda")


def _card_scorer(case, cuda):
    if case.startswith("simca"):
        rng = np.random.default_rng(8)
        x = rng.standard_normal((600, 288)).astype(np.float32)
        models = fit_classes(x, np.repeat([0, 1, 2], 200), [0, 1, 2], 5,
                             device=cuda)
        dtype = torch.int8 if case == "simca_int8" else None
        return SIMCAScorer(models, chunk_size=4096, store_dtype=dtype)
    variant, classes = {"d2": ("d2", 1), "vaesimca_stacked": ("vaesimca", 3),
                        "f_pinned": ("f_pinned", 1), "full": ("full", 1)}[case]
    return _scorer(variant, classes, cuda, torch.float32, 288, 4096)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["d2", "vaesimca_stacked", "f_pinned",
                                  "full", "simca_f32", "simca_int8"])
def test_pinned_path_equals_pageable_path_on_the_card(cuda, case):
    scorer = _card_scorer(case, cuda)
    x = _frames(10_000, 288, dtype=np.float32)
    try:
        for frame in (x, x[:100]):
            want = _chunk_by_chunk(scorer, frame)
            for got in (scorer.score(frame), scorer.score(frame, prefetch=0),
                        scorer.score(frame, prefetch=2),
                        scorer.score_prepared(scorer.prepare(frame))):
                _same(got, want)
    finally:
        scorer.close()


@pytest.mark.cuda
def test_copies_run_from_pinned_memory_on_their_own_stream(cuda, tmp_path):
    """A traced camera frame (two chunks of 16,384 x 288 f32): every
    host-to-device copy is from page-locked memory, on a stream on which
    no kernel runs; the second chunk's copy overlaps the first's
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    scorer = _scorer("d2", 1, cuda, torch.float32, 288, 16384)
    frame = _frames(2 * 16384, 288, dtype=np.float32)
    frames = 3
    try:
        scorer.score(frame)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(frames):
                scorer.score(frame)
            torch.cuda.synchronize()
    finally:
        scorer.close()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e["name"]]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert len(copies) == 2 * frames and kernels
    assert all("Pinned" in e["name"] for e in copies), \
        {e["name"] for e in copies}
    copy_streams = {e["args"]["stream"] for e in copies}
    assert copy_streams.isdisjoint(e["args"]["stream"] for e in kernels)

    def overlaps(c):
        return any(k["ts"] < c["ts"] + c["dur"] and c["ts"] < k["ts"]
                   + k["dur"] for k in kernels)

    held = sum(map(overlaps, sorted(copies, key=lambda e: e["ts"])[1::2]))
    print(f"{held} of {frames} second-chunk copies overlap a kernel")
    assert held >= 1
